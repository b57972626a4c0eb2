"""DVFS planner (paper §4.3, Alg. 2): minimum bisection frequency scaling.

Up-clock *only* the residual straggler stage, to the **lowest** frequency that
aligns its mini-step with the target T* (sustained high frequency ages
hardware).  Feasibility is tested at f_max first; UNACHIEVABLE means the gap
is not compute-bound.

A copy of ``repro.core.planners.dvfs`` (the JAX package), numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

ACHIEVABLE = "ACHIEVABLE"
UNACHIEVABLE = "UNACHIEVABLE"


@dataclasses.dataclass(frozen=True)
class DvfsPlan:
    rank: int                  # stage/rank to up-clock (-1: none)
    freq: float
    status: str


def bisect_min_feasible(f_lo: float, f_hi: float,
                        feasible: Callable[[float], bool],
                        df_min: float) -> float:
    """Smallest f in [f_lo, f_hi] with feasible(f), assuming monotonicity.
    Precondition: feasible(f_hi)."""
    lo, hi = f_lo, f_hi
    while hi - lo > df_min:
        mid = 0.5 * (lo + hi)
        if feasible(mid):
            hi = mid
        else:
            lo = mid
    return hi


def plan_dvfs_stages(stage_times, f_max: float, target: float = None,
                     eps_frac: float = 0.02, df_min: float = 0.01,
                     tol: float = 1.001) -> Tuple["DvfsPlan", ...]:
    """Alg. 2 over a whole stage-time vector: up-clock every residual
    straggler stage (time > tol * target) to the lowest aligning frequency.
    The shared per-stage loop of ``ScheduleEngine.plan`` and
    ``ElasWavePolicy.decide`` — stages, not ranks, so it is scale-free."""
    times = list(stage_times)
    if target is None:
        target = min(times)
    plans = []
    for p, tt in enumerate(times):
        if tt <= target * tol:
            continue

        def obs(f, tt=tt):
            return tt / f

        plans.append(plan_dvfs(obs, 1.0, f_max, target,
                               eps=eps_frac * target, df_min=df_min, rank=p))
    return tuple(plans)


def plan_dvfs(obs_time: Callable[[float], float],
              f_cur: float, f_max: float, target: float,
              eps: float, df_min: float, rank: int = -1) -> DvfsPlan:
    """Alg. 2.  obs_time(f) = measured mini-step time at frequency f over the
    observation window W (the simulator/hardware hook)."""
    t_cur = obs_time(f_cur)
    if abs(t_cur - target) <= eps or t_cur <= target + eps:
        return DvfsPlan(rank, f_cur, ACHIEVABLE)
    t_max = obs_time(f_max)
    if t_max > target + eps:
        return DvfsPlan(rank, f_max, UNACHIEVABLE)
    f_star = bisect_min_feasible(
        f_cur, f_max, lambda f: obs_time(f) <= target + eps, df_min)
    return DvfsPlan(rank, f_star, ACHIEVABLE)
