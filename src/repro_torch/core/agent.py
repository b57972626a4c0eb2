"""ElasWave Agent (paper §3.2): per-worker health monitoring.

A copy of ``repro.core.agent`` (the JAX package), numpy only.

Co-located with each (virtual) worker; hooks heartbeat/step-time probes and
relays elastic events to the Core.  Detection is *hardened* against the
imperfect-probe regimes the detection-chaos fuzzer injects:

* **Fail-stop** is a healthy → suspect → confirmed state machine, not a raw
  miss counter.  The first missed heartbeat only raises *suspicion*; the
  rank is confirmed dead (FAIL_STOP emitted) after ``confirm_needed``
  consecutive misses.  A heartbeat received while suspect is a **flap**: the
  rank returns to healthy, and its confirmation threshold doubles
  (``miss_limit * 2**min(flaps, backoff_cap)``) — exponential-backoff
  re-probing, so a link that blips repeatedly has to stay silent for longer
  and longer before it is evicted.  A fresh (never-flapped) rank confirms at
  exactly ``miss_limit`` misses, matching the reactive baseline.
* **Fail-slow** compares a rank's rolling step-time median against the
  median of its *stage peers* (other ranks in the same pipeline stage), not
  the global fleet — heterogeneous stages have legitimately different step
  times.  Stage topology is passed in by the executor (``stage_of``);
  without one, all ranks form a single peer group.
* **OOM early warning**: per-rank ``Probe.mem_used`` history is fitted with
  a linear trend; when the extrapolated usage crosses
  ``mem_threshold * mem_cap`` within ``mem_horizon`` observations, an
  advisory ``OOM_RISK`` event is emitted (once, re-armed when pressure
  recedes).

Probes within one ``observe`` call are aggregated per rank, which makes
detection *order-independent*: duplicated, reordered, or delayed copies of
the same heartbeat cannot change the verdict — any surviving heartbeat
counts as life.

Rank membership is DYNAMIC: the monitored set changes with the cluster.
``add_rank`` registers a worker granted by SCALE_OUT (or a rejoin — stale
dead/slow verdicts and flap history are cleared so a later failure of the
same rank is re-detected), ``remove_rank`` retires one that left.  The
``VirtualCluster`` wires these from its apply paths; probes for
unregistered ranks are ignored.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from .events import ElasticEvent, EventKind


@dataclasses.dataclass
class Probe:
    step: int
    rank: int
    heartbeat: bool
    step_seconds: float
    mem_used: float = 0.0


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"      # ≥1 consecutive miss, below confirmation bar
    CONFIRMED = "confirmed"  # FAIL_STOP emitted


@dataclasses.dataclass
class RankHealth:
    state: HealthState = HealthState.HEALTHY
    consecutive_misses: int = 0
    flaps: int = 0           # heartbeats received while SUSPECT (lifetime)


class Agent:
    def __init__(self, num_ranks: int, window: int = 8,
                 slow_threshold: float = 1.3, miss_limit: int = 2,
                 backoff_cap: int = 3,
                 stage_of: Optional[Dict[int, int]] = None,
                 mem_cap: float = 1.0, mem_threshold: float = 0.9,
                 mem_horizon: int = 3):
        self.window = window
        self.slow_threshold = slow_threshold
        self.miss_limit = miss_limit
        self.backoff_cap = backoff_cap
        self.stage_of: Dict[int, int] = dict(stage_of) if stage_of else {}
        self.mem_cap = mem_cap
        self.mem_threshold = mem_threshold
        self.mem_horizon = mem_horizon
        self.health: Dict[int, RankHealth] = {}
        self.times: Dict[int, Deque[float]] = {}
        self.mem: Dict[int, Deque[float]] = {}
        self.reported_slow: set = set()
        self.reported_dead: set = set()
        self.reported_oom: set = set()
        for r in range(num_ranks):
            self.add_rank(r)

    @property
    def ranks(self) -> List[int]:
        """Currently monitored ranks (sorted)."""
        return sorted(self.times)

    @property
    def num_ranks(self) -> int:
        return len(self.times)

    def add_rank(self, rank: int, stage: Optional[int] = None):
        """Register a rank (SCALE_OUT / rejoin).  Health history restarts
        fresh and stale verdicts are cleared, so a rank that rejoins and
        later fails again is re-detected."""
        self.health[rank] = RankHealth()
        self.times[rank] = deque(maxlen=self.window)
        self.mem[rank] = deque(maxlen=self.window)
        if stage is not None:
            self.stage_of[rank] = stage
        self.reported_dead.discard(rank)
        self.reported_slow.discard(rank)
        self.reported_oom.discard(rank)

    def remove_rank(self, rank: int):
        """Retire a rank that left (recovered fail-stop / scale-in): it no
        longer accrues misses or participates in the stage-peer median."""
        self.health.pop(rank, None)
        self.times.pop(rank, None)
        self.mem.pop(rank, None)
        self.reported_dead.discard(rank)
        self.reported_slow.discard(rank)
        self.reported_oom.discard(rank)

    # -- state machine -----------------------------------------------------

    def confirm_needed(self, rank: int) -> int:
        """Consecutive misses required to confirm this rank dead.  Doubles
        with each recorded flap (bounded by ``backoff_cap``)."""
        h = self.health.get(rank)
        flaps = h.flaps if h is not None else 0
        return self.miss_limit * (2 ** min(flaps, self.backoff_cap))

    def max_confirm_misses(self) -> int:
        """Upper bound on observe() rounds needed to confirm any currently
        registered rank — executors use this as their detection-loop bound."""
        if not self.health:
            return self.miss_limit
        return max(self.confirm_needed(r) for r in self.health)

    def state_of(self, rank: int) -> Optional[HealthState]:
        h = self.health.get(rank)
        return h.state if h is not None else None

    # -- observation -------------------------------------------------------

    def observe(self, probes: List[Probe]) -> List[ElasticEvent]:
        events: List[ElasticEvent] = []
        step = probes[0].step if probes else 0
        # Aggregate probes per rank: order-independent, duplicate-proof.
        # Any heartbeat among a rank's probes counts as life; step-time and
        # memory samples are the medians/max over the heartbeat copies.
        beats: Dict[int, List[Probe]] = {}
        seen: set = set()
        for p in probes:
            if p.rank not in self.times:      # unregistered: ignore
                continue
            seen.add(p.rank)
            if p.heartbeat:
                beats.setdefault(p.rank, []).append(p)

        for r in self.ranks:
            h = self.health[r]
            alive = r in beats
            if alive:
                ps = beats[r]
                self.times[r].append(float(np.median([p.step_seconds for p in ps])))
                m = max(p.mem_used for p in ps)
                if m > 0:
                    self.mem[r].append(float(m))
                if h.state is HealthState.SUSPECT:
                    h.flaps += 1              # blip, not death: back off
                if h.state is not HealthState.CONFIRMED:
                    h.state = HealthState.HEALTHY
                h.consecutive_misses = 0
            elif r in seen or probes:
                # missed: either an explicit dead probe or absent from a
                # round that did carry probes
                h.consecutive_misses += 1
                if h.state is HealthState.HEALTHY:
                    h.state = HealthState.SUSPECT
                if (h.consecutive_misses >= self.confirm_needed(r)
                        and h.state is not HealthState.CONFIRMED):
                    h.state = HealthState.CONFIRMED
                    self.reported_dead.add(r)
                    events.append(ElasticEvent(
                        EventKind.FAIL_STOP, step, (r,),
                        detail=(f"{h.consecutive_misses} consecutive misses"
                                f" (needed {self.confirm_needed(r)},"
                                f" flaps={h.flaps})")))

        events.extend(self._detect_slow(step))
        events.extend(self._detect_oom(step))
        return events

    def _detect_slow(self, step: int) -> List[ElasticEvent]:
        """Fail-slow: each rank's rolling median vs the median of its stage
        peers' medians.  Ranks without enough history — or without any peer
        that has enough history — are skipped."""
        events: List[ElasticEvent] = []
        med: Dict[int, float] = {
            r: float(np.median(d)) for r, d in self.times.items()
            if len(d) >= self.window // 2}
        for r, m in med.items():
            if r in self.reported_dead or r in self.reported_slow:
                continue
            stage = self.stage_of.get(r, 0)
            peers = [med[q] for q in med
                     if q != r and self.stage_of.get(q, 0) == stage]
            if not peers:
                continue
            ref = float(np.median(peers))
            if ref > 0 and m > self.slow_threshold * ref:
                self.reported_slow.add(r)
                events.append(ElasticEvent(
                    EventKind.FAIL_SLOW, step, (r,), slow_factor=float(m / ref),
                    detail=f"median {m:.3f}s vs stage peers {ref:.3f}s"))
        return events

    def _detect_oom(self, step: int) -> List[ElasticEvent]:
        """OOM early warning: linear-trend extrapolation of per-rank memory
        usage.  Advisory — emitted once per rank, re-armed when the
        projection drops back below the threshold."""
        events: List[ElasticEvent] = []
        limit = self.mem_threshold * self.mem_cap
        for r, d in self.mem.items():
            if r in self.reported_dead or len(d) < 2:
                continue
            xs = np.arange(len(d), dtype=np.float64)
            slope = float(np.polyfit(xs, np.asarray(d, dtype=np.float64), 1)[0])
            projected = d[-1] + max(slope, 0.0) * self.mem_horizon
            if projected >= limit:
                if r not in self.reported_oom:
                    self.reported_oom.add(r)
                    events.append(ElasticEvent(
                        EventKind.OOM_RISK, step, (r,),
                        detail=(f"mem {d[-1]:.3f} slope {slope:+.3f}/obs →"
                                f" {projected:.3f} ≥ {limit:.3f}"
                                f" within {self.mem_horizon} obs")))
            else:
                self.reported_oom.discard(r)
        return events
