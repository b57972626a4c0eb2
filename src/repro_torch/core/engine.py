"""Schedule Engine (paper §4): elastic event -> executable RecoveryPlan.

Jointly decides the four axes — Dataflow, Graph, DVFS, RNG — under per-stage
memory-capacity checks, and attaches the data-plane actions (communicator
edits, live-remap transfer plan, migration specs) so the Recovery Executor
(``VirtualCluster.apply_plan``) can run it without further decisions.

A copy of ``repro.core.engine`` (the JAX package), numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .cost_model import HardwareSpec, SegmentCosts, mini_step_time
from .events import ElasticEvent
from .planners.dataflow import DataflowPlan, plan_dataflow
from .planners.graph import GraphPlan, minimax_layer_partition
from .planners.dvfs import DvfsPlan, plan_dvfs_stages
from .planners.rng import RngPlan, plan_rng_reshard


@dataclasses.dataclass
class RecoveryPlan:
    event: ElasticEvent
    dataflow: DataflowPlan
    graph: GraphPlan
    dvfs: List[DvfsPlan]
    rng: RngPlan
    new_dp: int
    migrations: List[Tuple[int, int, int]]   # (layer_id, src_stage, dst_stage)
    capacity_ok: bool
    plan_seconds: float = 0.0                # planner wall time (MTTR itemization)


class ScheduleEngine:
    def __init__(self, cfg, seq: int, hw: Optional[HardwareSpec] = None,
                 mem_cap: Optional[float] = None):
        self.cfg = cfg
        self.hw = hw or HardwareSpec()
        self.seg = SegmentCosts.build(cfg, seq, self.hw)
        self.mem_cap = mem_cap if mem_cap is not None else self.hw.hbm_bytes

    def plan_view(self, event: ElasticEvent, view, *,
                  failed_dp_ranks: Sequence[int],
                  old_sample_rank: Optional[Dict[int, int]] = None,
                  dp: Optional[int] = None,
                  use_slow: bool = False) -> RecoveryPlan:
        """Plan directly from a shared ``core.clusterview.ClusterView``:
        per-stage widths and straggler factors come from the view's array
        reductions, so callers stop re-deriving rank membership per planner.
        ``dp`` overrides the pre-event replica count when the view's static
        ``dp`` no longer reflects it (ranks already removed earlier)."""
        return self.plan(
            event, dp=dp if dp is not None else view.dp, pp=view.pp,
            global_batch=view.global_batch, num_micro=view.num_micro,
            layer_assignment=view.layer_assignment,
            failed_dp_ranks=list(failed_dp_ranks),
            old_sample_rank=old_sample_rank or {},
            stage_widths=[int(w) for w in view.stage_width()],
            slow=view.stage_slow() if use_slow else None)

    def plan(self, event: ElasticEvent, *, dp: int, pp: int,
             global_batch: int, num_micro: int,
             layer_assignment: Sequence[Tuple[int, int]],
             failed_dp_ranks: Sequence[int],
             old_sample_rank: Dict[int, int],
             stage_widths: Optional[Sequence[int]] = None,
             freqs: Optional[Sequence[float]] = None,
             slow: Optional[Sequence[float]] = None) -> RecoveryPlan:
        import time as _time
        t0 = _time.perf_counter()
        L = self.cfg.num_layers
        new_dp = dp - len(failed_dp_ranks) if event.is_shrink else \
            dp + len(event.ranks)
        assert new_dp >= 1

        # --- Dataflow ---
        df = plan_dataflow(global_batch, num_micro, new_dp)
        per_micro = global_batch // num_micro
        if stage_widths is None:
            stage_widths = [new_dp] * pp
        # per-stage micro-batch size after resizing on that stage's DP width
        mbs_stage = [-(-per_micro // max(w, 1)) for w in stage_widths]
        mbs = max(df.micro_batch_sizes)

        # --- Graph (minimax repartition under memory caps) ---
        def t(p, a, b):
            return mini_step_time(self.seg, a, b, mbs_stage[p], hw=self.hw)

        def mem(p, a, b):
            return self.seg.seg_mem(a, b, mbs_stage[p],
                                    inflight=min(pp, num_micro),
                                    dp_size=max(stage_widths[p], 1))

        graph = minimax_layer_partition(L, pp, t, mem, [self.mem_cap] * pp)
        capacity_ok = graph.feasible
        if not graph.feasible:
            graph = GraphPlan((), tuple(layer_assignment), float("inf"), False)

        # --- migrations: diff old vs new assignment ---
        old_stage = _stage_of(layer_assignment, L)
        new_stage = _stage_of(graph.stage_ranges, L) if graph.feasible else old_stage
        migrations = [(lid, old_stage[lid], new_stage[lid])
                      for lid in range(L) if old_stage[lid] != new_stage[lid]]

        # --- DVFS: align residual stragglers to fastest stage ---
        dvfs_plans: List[DvfsPlan] = []
        if graph.feasible:
            times = []
            for p, (a, b) in enumerate(graph.stage_ranges):
                s = (slow[p] if slow is not None and len(slow) else 1.0)
                times.append(t(p, a, b) * s)
            dvfs_plans = list(plan_dvfs_stages(times, self.hw.max_freq))

        # --- RNG resharding ---
        new_sample_rank = _sample_assignment(df, old_sample_rank)
        rng = plan_rng_reshard(old_stage, new_stage, old_sample_rank,
                               new_sample_rank)

        return RecoveryPlan(event, df, graph, dvfs_plans, rng, new_dp,
                            migrations, capacity_ok,
                            plan_seconds=_time.perf_counter() - t0)


def _stage_of(ranges: Sequence[Tuple[int, int]], L: int) -> List[int]:
    out = [0] * L
    for p, (a, b) in enumerate(ranges):
        for l in range(a, b + 1):
            out[l] = p
    return out


def _sample_assignment(df: DataflowPlan, old: Dict[int, int]) -> Dict[int, int]:
    """Re-slice sample slots [0, per_micro) among new ranks, contiguous."""
    new: Dict[int, int] = {}
    cursor = 0
    for r, sz in enumerate(df.micro_batch_sizes):
        for _ in range(sz):
            if cursor in old or not old:
                new[cursor] = r
            cursor += 1
    # keep keys aligned with old when old provided
    if old:
        new = {sid: new.get(sid, old[sid]) for sid in old}
    return new
