"""Graph planner (paper §4.2, Alg. 1): minimax layer partition via DP.

State f[p, l] = optimal worst-stage mini-step time partitioning layers [1..l]
over stages [1..p], subject to per-stage memory caps.  O(P L^2) with O(1)
segment cost queries (precomputed prefix sums in cost_model.SegmentCosts).

`brute_force_partition` is the oracle for property tests.

A copy of ``repro.core.planners.graph`` (the JAX package), numpy only.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    boundaries: Tuple[int, ...]       # right boundaries b_1..b_{P-1} (1-based)
    stage_ranges: Tuple[Tuple[int, int], ...]  # 0-based inclusive [a, b] per stage
    worst_mini_step: float
    feasible: bool

    @property
    def layers_per_stage(self) -> Tuple[int, ...]:
        return tuple(b - a + 1 for a, b in self.stage_ranges)


def minimax_layer_partition(
        L: int, P: int,
        t: Callable[[int, int, int], float],     # t(stage, a, b) 0-based incl.
        mem: Callable[[int, int, int], float],   # mem(stage, a, b)
        caps: Sequence[float]) -> GraphPlan:
    """Alg. 1. Returns infeasible plan if no memory-feasible partition exists."""
    assert P >= 1 and L >= P
    f = np.full((P + 1, L + 1), INF)
    kstar = np.full((P + 1, L + 1), -1, dtype=np.int64)
    # base: stage 1 takes [1..l]
    for l in range(1, L + 1):
        if mem(0, 0, l - 1) <= caps[0]:
            f[1, l] = t(0, 0, l - 1)
    # transition
    for p in range(2, P + 1):
        for l in range(p, L + 1):
            best, bestk = INF, -1
            # prune: t_p([k+1..l]) decreases as k grows; f[p-1,k] increases.
            for k in range(p - 1, l):
                if f[p - 1, k] == INF:
                    continue
                if mem(p - 1, k, l - 1) > caps[p - 1]:
                    continue
                cand = max(f[p - 1, k], t(p - 1, k, l - 1))
                if cand < best:
                    best, bestk = cand, k
                elif f[p - 1, k] >= best:
                    # f is nondecreasing in k -> no better k beyond this point
                    break
            f[p, l], kstar[p, l] = best, bestk
    if f[P, L] == INF:
        return GraphPlan((), (), INF, feasible=False)
    # backtrack
    bounds = [0] * (P + 1)
    bounds[P] = L
    for p in range(P, 1, -1):
        bounds[p - 1] = int(kstar[p, bounds[p]])
    ranges = tuple((bounds[p - 1], bounds[p] - 1) for p in range(1, P + 1))
    return GraphPlan(tuple(bounds[1:P]), ranges, float(f[P, L]), feasible=True)


def plan_graph(seg, view, hw=None) -> GraphPlan:
    """View-level Alg. 1: derive per-stage widths / micro-batch sizes /
    straggler factors from a shared :class:`core.clusterview.ClusterView`
    (one array reduction each) and run the minimax DP.  Callers stop
    re-deriving rank membership per planner."""
    from ..cost_model import mini_step_time
    hw = hw or seg.hw
    width = view.stage_width()
    if int(width.min()) == 0:
        return GraphPlan((), (), INF, feasible=False)
    per_micro = view.global_batch // view.num_micro
    mbs_stage = np.ceil(per_micro / width).astype(np.int64)
    slow_stage = view.stage_slow()
    P = view.pp

    def t(p, a, b):
        return mini_step_time(seg, a, b, int(mbs_stage[p]), hw=hw) \
            * slow_stage[p]

    def mem(p, a, b):
        return seg.seg_mem(a, b, int(mbs_stage[p]),
                           inflight=min(P, view.num_micro),
                           dp_size=int(width[p]))

    return minimax_layer_partition(seg.cfg.num_layers, P, t, mem,
                                   [view.mem_cap] * P)


def brute_force_partition(L: int, P: int, t, mem, caps) -> GraphPlan:
    """Exhaustive oracle (small L, P only)."""
    best: Optional[GraphPlan] = None
    for cuts in itertools.combinations(range(1, L), P - 1):
        bounds = (0,) + cuts + (L,)
        ranges = tuple((bounds[i], bounds[i + 1] - 1) for i in range(P))
        if any(mem(i, a, b) > caps[i] for i, (a, b) in enumerate(ranges)):
            continue
        worst = max(t(i, a, b) for i, (a, b) in enumerate(ranges))
        if best is None or worst < best.worst_mini_step:
            best = GraphPlan(tuple(cuts), ranges, worst, feasible=True)
    return best or GraphPlan((), (), INF, feasible=False)


def mem_check_fails(L, P, t, mem, caps) -> bool:
    return not minimax_layer_partition(L, P, t, mem, caps).feasible
