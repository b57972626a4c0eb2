"""Expert-parallel (EP) elasticity planner — beyond-paper extension.

The paper's §7.7 MoE case study treats the MoE model through the generic
DP/PP machinery; §7.8 names adapting to expert-parallel systems as future
work.  This planner closes that gap for EP-sharded MoE layers:

* experts are state units (weights + optimizer shards) placed on the EP
  group's workers;
* on a failure, the dead worker's experts are recovered (ring snapshot /
  surviving replica) and re-placed across survivors to minimize the maximum
  *routed load* per worker (LPT greedy on observed router statistics — the
  same minimax shape as the Graph planner, over a different resource);
* on scale-out the placement rebalances back.

Transfer accounting mirrors core/zero.py: each move is (expert, src, dst,
bytes); disjoint pairs ship in parallel.

A copy of ``repro.core.planners.expert`` (the JAX package), plain Python.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ExpertMove:
    expert: int
    src: int                 # worker holding a live copy (or snapshot holder)
    dst: int
    nbytes: int
    from_snapshot: bool


@dataclasses.dataclass
class ExpertPlan:
    placement: Dict[int, int]          # expert -> worker
    moves: List[ExpertMove]
    max_load: float                    # minimax objective value
    est_seconds: float

    def loads(self, expert_load: Sequence[float], workers: Sequence[int]
              ) -> Dict[int, float]:
        out = {w: 0.0 for w in workers}
        for e, w in self.placement.items():
            out[w] += expert_load[e]
        return out


def lpt_placement(expert_load: Sequence[float], workers: Sequence[int],
                  pinned: Optional[Dict[int, int]] = None) -> Dict[int, int]:
    """Longest-processing-time greedy: heaviest expert to lightest worker.
    `pinned` experts keep their worker (avoid moving what survived)."""
    pinned = pinned or {}
    loads = {w: 0.0 for w in workers}
    placement: Dict[int, int] = {}
    for e, w in pinned.items():
        placement[e] = w
        loads[w] += expert_load[e]
    order = sorted((e for e in range(len(expert_load)) if e not in pinned),
                   key=lambda e: -expert_load[e])
    for e in order:
        w = min(loads, key=lambda k: (loads[k], k))
        placement[e] = w
        loads[w] += expert_load[e]
    return placement


def brute_force_placement(expert_load: Sequence[float],
                          workers: Sequence[int]) -> float:
    """Optimal minimax load (small instances; property-test oracle)."""
    best = float("inf")
    E = len(expert_load)
    for assign in itertools.product(workers, repeat=E):
        loads = {w: 0.0 for w in workers}
        for e, w in enumerate(assign):
            loads[w] += expert_load[e]
        best = min(best, max(loads.values()))
    return best


def plan_expert_reshard(expert_load: Sequence[float],
                        old_placement: Dict[int, int],
                        surviving: Sequence[int],
                        expert_bytes: int,
                        snapshot_holder: Optional[Dict[int, int]] = None,
                        link_bw: float = 25e9,
                        rebalance_survivors: bool = False) -> ExpertPlan:
    """Re-place experts after the EP group shrinks to `surviving`.

    Experts whose worker survived stay pinned (no gratuitous movement —
    ElasWave's minimal-perturbation principle) unless `rebalance_survivors`.
    Orphaned experts are fetched from their snapshot holder (ring scheme) or
    any survivor holding a replica, and placed by LPT.
    """
    surviving = list(surviving)
    snapshot_holder = snapshot_holder or {}
    pinned = {e: w for e, w in old_placement.items()
              if w in surviving and not rebalance_survivors}
    placement = lpt_placement(expert_load, surviving, pinned)
    moves: List[ExpertMove] = []
    for e, w in placement.items():
        old_w = old_placement.get(e)
        if old_w == w:
            continue
        if old_w in surviving:
            src, snap = old_w, False
        else:
            src = snapshot_holder.get(e, surviving[0])
            snap = True
        moves.append(ExpertMove(e, src, w, expert_bytes, snap))
    loads = {w: 0.0 for w in surviving}
    for e, w in placement.items():
        loads[w] += expert_load[e]
    # disjoint endpoint pairs in parallel -> max per-endpoint bytes
    ep_bytes: Dict[int, int] = {}
    for m in moves:
        ep_bytes[m.src] = ep_bytes.get(m.src, 0) + m.nbytes
        ep_bytes[m.dst] = ep_bytes.get(m.dst, 0) + m.nbytes
    est = max(ep_bytes.values()) / link_bw if ep_bytes else 0.0
    return ExpertPlan(placement, moves, max(loads.values()), est)
