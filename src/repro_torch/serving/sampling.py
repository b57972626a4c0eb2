"""Seeded token sampling, content-addressed through the RNG planner.

The paper's computation-consistency invariant (§4.4) extends to serving: a
sampled token must not depend on *which replica or slot* computed it.  The
key for the token at absolute position ``pos`` of request ``rid`` is

    stream_key(base_key, step=pos, layer_id=SAMPLE_STREAM_ID, sample_id=rid)

— the same content-addressed derivation ``core/planners/rng.py`` uses for
dropout streams, with a reserved pseudo-layer id for the sampling head.  KV
migration, requeue-with-prefix rebuilds and replica changes therefore leave
sampled streams bit-identical.

Top-k draws the reference's ``jax.random.categorical`` on the host in numpy:
the keys and the uniform bits are threefry2x32 (``kernels/threefry.py``),
bit for bit ``jax.random.uniform``; the Gumbel noise ``-log(-log(u))`` takes
each logarithm correctly rounded to float32, within one ulp of XLA's (its
own polynomial, not correctly rounded), so a token can differ only where two
candidates' scores tie to within an ulp.  ``lax.top_k``'s order is the
float total order (``0.0`` above ``-0.0``), ties by the lower index.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.planners.rng import stream_key
from repro_torch.kernels.threefry import key_from_seed, threefry2x32

# reserved pseudo layer id for the sampling head — disjoint from any real
# model layer id so sampling never collides with a dropout stream
SAMPLE_STREAM_ID = 1 << 20

_TINY = np.finfo(np.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    method: str = "greedy"        # "greedy" | "topk"
    temperature: float = 1.0
    top_k: int = 0                # 0 = full vocab
    seed: int = 0

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def uniform(key, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``:
    the 32 bits of flat index i are ``y0 ^ y1`` of threefry2x32(key,
    (i >> 32, i)), their top 23 bits a float32 in [1, 2) less 1, then
    ``* (1 - tiny) + tiny`` (``1 - tiny`` is 1.0 in float32) and the max
    with ``tiny``."""
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                          idx.astype(np.uint32))
    bits = (y0 ^ y1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    span = np.float32(1.0) - np.float32(_TINY)
    return np.maximum(np.float32(_TINY), floats * span + np.float32(_TINY))


def gumbel(key, n: int) -> np.ndarray:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") to within an
    ulp: ``-log(-log(u))``, each log taken in float64 and rounded."""
    inner = np.log(uniform(key, n).astype(np.float64)).astype(np.float32)
    return -np.log(-inner.astype(np.float64)).astype(np.float32)


def top_k(row: np.ndarray, k: int):
    """``jax.lax.top_k`` of a float32 row: (values, indices), descending in
    the float total order, ties by the lower index.  The k-th largest key
    is found by partition (no sort of the whole vocabulary): every key
    above it, then the lowest indices of those equal to it."""
    bits = np.ascontiguousarray(row, dtype=np.float32).view(np.int32)
    key = np.where(bits >= 0, bits, bits ^ np.int32(0x7FFFFFFF)) \
        .astype(np.int64)
    kth = np.partition(key, len(key) - k)[len(key) - k]
    above = np.flatnonzero(key > kth)
    idx = np.concatenate([above, np.flatnonzero(key == kth)[:k - len(above)]])
    idx = idx[np.lexsort((idx, -key[idx]))]
    return row[idx], idx


def sample_tokens(logits, rids: Sequence[int], positions: Sequence[int],
                  sc: SamplerConfig) -> np.ndarray:
    """logits: [B, V] -> token ids [B].  ``positions[b]`` is the absolute
    position of the token being sampled for request ``rids[b]``."""
    logits = np.asarray(logits, dtype=np.float32)
    if sc.method == "greedy":
        return np.argmax(logits, axis=-1).astype(np.int64)
    if sc.method != "topk":
        raise ValueError(f"unknown sampling method {sc.method!r}")
    base = key_from_seed(sc.seed)
    out = np.zeros(len(rids), dtype=np.int64)
    temp = np.float32(max(sc.temperature, 1e-6))
    for b, (rid, pos) in enumerate(zip(rids, positions)):
        key = stream_key(base, int(pos), SAMPLE_STREAM_ID, int(rid))
        row = logits[b]
        if sc.top_k and sc.top_k < row.shape[-1]:
            vals, idx = top_k(row, sc.top_k)
        else:
            vals, idx = row, np.arange(row.shape[-1])
        choice = int(np.argmax(gumbel(key, len(vals)) + vals / temp))
        out[b] = int(idx[choice])
    return out
