"""RNG planner (paper §4.4): RNG resharding for computation consistency.

Paper mechanism: when a layer migrates, its RNG stream is transferred with it;
when a failed rank's samples are dispatched to peers, each sample is processed
with its *original* RNG state (every node backs up the streams of its
same-stage peers).

Streams are **content-addressed**, as the reference's: the key of every
random op is ``fold_in(fold_in(step_key, layer_id), sample_id)`` (with the
op id folded between, ``models/layers.dropout``), so ownership changes
never change the drawn bits.  The planner emits the explicit *stream
reassignment map* the paper would ship, which documents what moved and
gives the bytes-that-would-transfer for MTTR accounting.  A copy of
``repro.core.planners.rng`` (the JAX package) in numpy: keys are
``uint32[2]`` key data, equal to ``jax.random.key_data`` of the
reference's keys (``kernels/threefry.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.kernels.threefry import fold_in

RNG_STATE_BYTES = 16     # one splittable PRNG key (2x uint64 / 4x uint32)


@dataclasses.dataclass(frozen=True)
class RngPlan:
    # (layer_id, old_stage, new_stage) for migrated layer streams
    layer_stream_moves: Tuple[Tuple[int, int, int], ...]
    # (sample_slot, old_rank, new_rank) for re-dispatched sample streams
    sample_stream_moves: Tuple[Tuple[int, int, int], ...]
    transfer_bytes: int

    def describe(self) -> str:
        return (f"RngPlan(layers moved={len(self.layer_stream_moves)}, "
                f"samples moved={len(self.sample_stream_moves)}, "
                f"bytes={self.transfer_bytes})")


def plan_rng_reshard(old_layer_stage: Sequence[int], new_layer_stage: Sequence[int],
                     old_sample_rank, new_sample_rank) -> RngPlan:
    """Sample assignments may be ``{slot: rank}`` dicts (seed API) or aligned
    int arrays over slot ids (vectorized ClusterView path) — array inputs
    diff in one ``flatnonzero``."""
    ols = np.asarray(old_layer_stage, dtype=np.int64)
    nls = np.asarray(new_layer_stage, dtype=np.int64)
    moved = np.flatnonzero(ols != nls)
    layer_moves = tuple((int(l), int(ols[l]), int(nls[l])) for l in moved)
    if isinstance(old_sample_rank, np.ndarray) or isinstance(new_sample_rank,
                                                             np.ndarray):
        osr = np.asarray(old_sample_rank, dtype=np.int64)
        nsr = np.asarray(new_sample_rank, dtype=np.int64)
        diff = np.flatnonzero(osr != nsr)
        sample_moves = tuple((int(s), int(osr[s]), int(nsr[s])) for s in diff)
    else:
        sample_moves = tuple(
            (sid, old_sample_rank[sid], new_sample_rank[sid])
            for sid in sorted(new_sample_rank)
            if sid in old_sample_rank and old_sample_rank[sid] != new_sample_rank[sid])
    nbytes = (len(layer_moves) + len(sample_moves)) * RNG_STATE_BYTES
    return RngPlan(layer_moves, sample_moves, nbytes)


def stream_key(base_key, step: int, layer_id: int,
               sample_id: int) -> np.ndarray:
    """The canonical content-addressed stream (``uint32[2]`` key data)."""
    k = fold_in(base_key, step)
    k = fold_in(k, layer_id)
    return fold_in(k, sample_id)


def verify_equivalence(base_key, step: int, layer_ids: Sequence[int],
                       sample_ids: Sequence[int]) -> bool:
    """Check the invariance the resharding must guarantee: the stream for each
    (layer, sample) is identical regardless of the (stage, rank) that owns it.
    With content addressing this is an identity; we assert it explicitly so a
    regression in key derivation (e.g. rank-dependent folding) is caught."""
    for lid in layer_ids:
        for sid in sample_ids:
            k1 = stream_key(base_key, step, lid, sid)
            k2 = stream_key(base_key, step, lid, sid)
            if not np.array_equal(k1, k2):
                return False
    return True
