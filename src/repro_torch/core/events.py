"""Elastic events (paper §3.1): fail-stop, fail-slow, scheduler scale signals.

A copy of ``repro.core.events`` (the JAX package), plain Python.  This is
the single event vocabulary shared by the Agent (which *detects* events),
the ScheduleEngine (which *plans* around them) and the VirtualCluster (which
*executes* the plans).

Beyond the paper's four first-class kinds, four further kinds exist:

* ``DVFS_SET``  — an external frequency setpoint (e.g. power capping or a
                  scenario absorbing a straggler by up-clocking peers);
* ``MIGRATE``   — a scheduler-directed layer migration between two stages,
                  used by MTTR micro-benchmarks to meter the migration path
                  in isolation;
* ``PREEMPT_NOTICE`` — a scheduler *advance warning* (spot two-minute
                  notice): the named ranks WILL be preempted ``deadline``
                  seconds after the event step.  Liveness-wise it is a
                  shrink (the rank is lost either way); the proactive
                  executor drains the rank — snapshot flush + verified
                  remap + layer migration — inside the notice window, so
                  most of the recovery overlaps with ongoing training
                  instead of stalling it after the fail-stop lands;
* ``OOM_RISK``  — an Agent-emitted early warning that a rank's memory
                  trend will cross its capacity soon.  Advisory: it alters
                  no liveness and executors treat it as a zero-cost record.

An event may name *several* ranks (``ranks`` tuple): the scenario engine
uses this to express concurrent failure bursts, which executors apply as a
deterministic rank-ordered sequence of single-rank recoveries.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class EventKind(enum.Enum):
    FAIL_STOP = "fail_stop"
    FAIL_SLOW = "fail_slow"
    SCALE_IN = "scale_in"       # scheduler-driven preemption
    SCALE_OUT = "scale_out"     # new resources granted
    DVFS_SET = "dvfs_set"       # injected frequency setpoint (perturbation)
    MIGRATE = "migrate"         # directed layer migration (perturbation)
    PREEMPT_NOTICE = "preempt_notice"   # advance warning of a preemption
    OOM_RISK = "oom_risk"       # agent-emitted pre-OOM early warning


@dataclasses.dataclass(frozen=True)
class ElasticEvent:
    kind: EventKind
    step: int
    ranks: Tuple[int, ...]                 # affected global ranks
    slow_factor: float = 1.0               # >1 for FAIL_SLOW (time multiplier)
    detail: str = ""
    freq: float = 1.0                      # DVFS_SET target frequency
    layers: Tuple[int, ...] = ()           # MIGRATE: layer ids to move
    src_stage: int = 0                     # MIGRATE: source stage
    dst_stage: int = 1                     # MIGRATE: destination stage
    deadline: float = 120.0                # PREEMPT_NOTICE: seconds of warning

    @property
    def is_shrink(self) -> bool:
        return self.kind in (EventKind.FAIL_STOP, EventKind.SCALE_IN,
                             EventKind.PREEMPT_NOTICE)

    @property
    def is_grow(self) -> bool:
        return self.kind == EventKind.SCALE_OUT

    def describe(self) -> str:
        base = f"{self.kind.value}@{self.step} ranks={list(self.ranks)}"
        if self.kind == EventKind.FAIL_SLOW:
            base += f" x{self.slow_factor:g}"
        if self.kind == EventKind.DVFS_SET:
            base += f" f={self.freq:g}"
        if self.kind == EventKind.MIGRATE:
            base += (f" layers={list(self.layers)} "
                     f"{self.src_stage}->{self.dst_stage}")
        if self.kind == EventKind.PREEMPT_NOTICE:
            base += f" deadline={self.deadline:g}s"
        return base


def burst(kind: EventKind, step: int, ranks: Tuple[int, ...], **kw) -> ElasticEvent:
    """A concurrent multi-rank event (e.g. a whole node or switch domain
    failing at once).  Executors apply the ranks in ascending order so burst
    recovery is deterministic."""
    return ElasticEvent(kind, step, tuple(sorted(ranks)), **kw)
