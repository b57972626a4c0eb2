"""Layer migration (paper §6.2): blocking vs non-blocking with gradient
precomputation, plus the optimizer-state movement from core/zero.py.

Blocking: pause -> copy params+opt -> resume.  Stall = bytes/bw + fixed
orchestration.

Non-blocking (ElasWave, Fig. 9): the parameter copy streams while training
proceeds.  For early micro-batches mb[0..k] the *target* stage has no L_i
parameters yet, so the *source* runs a shadow instance of L_i, accumulates
the missing gradients, and asynchronously ships one "payback" gradient that
the target merges — gradient accumulation stays complete, and the only
non-overlapped cost is orchestration + whatever copy time exceeds the step's
compute window.

This module provides the planning + modeled MTTR accounting the
VirtualCluster's migrations record.  A copy of ``repro.core.migration`` (the
JAX package), plain Python.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from . import zero

ORCH_OVERHEAD_S = 0.3           # pause/handshake/bookkeeping per layer move


@dataclasses.dataclass(frozen=True)
class MigrationSpec:
    layer_ids: Tuple[int, ...]      # global layer indices to move
    src_stage: int
    dst_stage: int
    param_bytes: int                # total parameter payload
    opt_bytes: int                  # total optimizer-state payload
    dp: int
    zero_layout: str                # "contiguous" | "interleaved"
    blocking: bool


@dataclasses.dataclass
class MigrationTiming:
    param_seconds: float
    opt_seconds: float
    overlapped_seconds: float       # hidden under compute
    stall_seconds: float            # MTTR contribution
    payback_grad_bytes: int
    opt_transfer_bytes: int


def plan_opt_transfers(spec: MigrationSpec, layer_sizes: Sequence[int],
                       layer_pos: int, dst_layer_sizes: Sequence[int],
                       ) -> List[zero.Transfer]:
    return zero.migration_plan(spec.zero_layout, layer_sizes, layer_pos,
                               spec.dp, spec.src_stage, spec.dst_stage,
                               dst_layer_sizes)


def migration_timing(spec: MigrationSpec, link_bw: float,
                     step_compute_window: float) -> MigrationTiming:
    """MTTR model.  `step_compute_window`: compute time available to hide the
    copy under (non-blocking overlaps with ongoing training steps)."""
    if spec.zero_layout == "interleaved":
        opt_bytes = float(spec.opt_bytes)
        # D disjoint p2p sends proceed in parallel across ranks
        opt_secs = spec.opt_bytes / spec.dp / link_bw
    else:
        opt_bytes = zero.theoretical_bytes("contiguous", spec.opt_bytes, spec.dp)
        # cross-stage |O_i| + (D-1)/2 |O_i| intra-stage neighbor rounds,
        # serialized through the group (paper §6.3)
        opt_secs = (spec.opt_bytes / spec.dp / link_bw
                    + (spec.dp - 1) / 2 * spec.opt_bytes / spec.dp / link_bw * 2)
    param_secs = spec.param_bytes / link_bw
    payback = spec.param_bytes * 2 if not spec.blocking else 0   # fp32 grads of bf16 params

    orch = ORCH_OVERHEAD_S * max(len(spec.layer_ids), 1)
    if spec.blocking:
        stall = orch + param_secs + opt_secs
        overlapped = 0.0
    else:
        # The copy overlaps with ongoing compute, but not perfectly: the
        # shadow-instance bookkeeping, the payback-gradient merge, and the
        # final parameter swap stay on the critical path.  Empirically (paper
        # Fig. 13) the hidden fraction saturates around ~55% of the payload
        # for large models — orchestration dominates for small ones.
        copy = param_secs + opt_secs
        payback_secs = payback / link_bw * 0.2   # low-priority, mostly hidden
        overlapped = min(0.55 * copy, step_compute_window)
        stall = orch + (copy - overlapped) + payback_secs
    return MigrationTiming(param_secs, opt_secs, overlapped, stall,
                           payback, int(opt_bytes))
