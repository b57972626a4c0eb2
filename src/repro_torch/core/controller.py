"""Proactive elasticity controller (ROADMAP "predictive capacity controller").

A copy of ``repro.core.controller`` (the JAX package), plain Python.

Wraps the detection :class:`~repro_torch.core.agent.Agent` with the cluster-level
policy decisions the agent itself is too local to make — CLUES-style
lifecycle management (cf. ``lifecycle()`` / pending-task / stuck-node
recovery in the indigo orchestrator):

* **Resurrection**: a heartbeat from a rank the controller itself evicted
  (false positive — the "dead" worker was merely partitioned) turns into a
  ``SCALE_OUT`` rejoin event, so the executor re-admits it through the
  normal grow path and parameter/RNG/dataflow consistency is preserved by
  construction.
* **Stage-width veto**: the controller refuses to confirm-evict the last
  registered rank of a pipeline stage — losing it would make the model
  un-runnable, so the rank stays suspect until a replacement exists.  The
  veto is a backstop against detection false positives, not a liveness fix:
  a genuinely dead last-rank still stalls the stage.
* **Grant tracking**: ``grant()`` records a scheduler-promised scale-out;
  if the rank never joins within ``grant_timeout`` observation rounds it is
  moved to the stuck list (``stuck_grants()``) instead of being waited on
  forever — granted-but-never-joined capacity is recovered, not leaked.

The controller is deterministic and clockless: "time" is the count of
``observe()`` calls, so replays are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

from .agent import Agent, HealthState, Probe
from .events import ElasticEvent, EventKind


@dataclasses.dataclass
class Grant:
    """A scheduler-promised rank that has not joined yet."""
    rank: int
    granted_at: int          # observe-round when the grant was recorded
    detail: str = ""


class ElasticController:
    def __init__(self, agent: Agent, grant_timeout: int = 8,
                 resurrection_window: int = 32):
        self.agent = agent
        self.grant_timeout = grant_timeout
        self.resurrection_window = resurrection_window
        self.rounds = 0                      # observe-call clock
        self._evicted_at: Dict[int, int] = {}   # rank -> round we evicted it
        self._pending_grants: Dict[int, Grant] = {}
        self._stuck: List[Grant] = []

    # -- lifecycle ---------------------------------------------------------

    def grant(self, rank: int, detail: str = ""):
        """Record a scheduler grant: ``rank`` is expected to join soon."""
        self._pending_grants[rank] = Grant(rank, self.rounds, detail)

    def note_join(self, rank: int):
        """The granted rank actually joined (executor applied SCALE_OUT)."""
        self._pending_grants.pop(rank, None)
        self._evicted_at.pop(rank, None)

    def stuck_grants(self) -> List[Grant]:
        """Grants that timed out without the rank ever joining."""
        return list(self._stuck)

    def pending_grants(self) -> List[Grant]:
        return list(self._pending_grants.values())

    # -- observation -------------------------------------------------------

    def observe(self, probes: List[Probe]) -> List[ElasticEvent]:
        """Agent detection + controller policy.

        Returns the agent's events with the stage-width veto applied, plus
        resurrection ``SCALE_OUT`` events for falsely-evicted ranks that
        are heartbeating again.
        """
        self.rounds += 1
        step = probes[0].step if probes else 0

        raw = self.agent.observe(probes)
        events: List[ElasticEvent] = []
        for ev in raw:
            if ev.kind == EventKind.FAIL_STOP and self._veto_eviction(ev):
                continue
            events.append(ev)
            if ev.kind == EventKind.FAIL_STOP:
                for r in ev.ranks:
                    self._evicted_at[r] = self.rounds

        events.extend(self._detect_resurrections(probes, step))
        self._expire_grants()
        return events

    def _veto_eviction(self, ev: ElasticEvent) -> bool:
        """Refuse to evict the last registered rank of any stage.  The agent
        keeps the rank CONFIRMED internally but we do not forward the event;
        the rank is rolled back to SUSPECT so a later heartbeat can clear it
        and a later miss (once the stage has peers again) re-confirms."""
        for r in ev.ranks:
            stage = self.agent.stage_of.get(r, 0)
            peers = [q for q in self.agent.ranks
                     if q != r and self.agent.stage_of.get(q, 0) == stage]
            if not peers:
                h = self.agent.health.get(r)
                if h is not None:
                    h.state = HealthState.SUSPECT
                self.agent.reported_dead.discard(r)
                return True
        return False

    def _detect_resurrections(self, probes: List[Probe],
                              step: int) -> List[ElasticEvent]:
        """A heartbeat from a rank we evicted recently (and that has not
        been re-registered) is a detection false positive: the worker is
        alive behind a healed partition.  Emit a SCALE_OUT rejoin so the
        executor re-admits it through the normal grow path."""
        events: List[ElasticEvent] = []
        beating: Set[int] = {p.rank for p in probes if p.heartbeat}
        for r in sorted(beating & set(self._evicted_at)):
            if r in self.agent.times:        # already re-registered
                self._evicted_at.pop(r, None)
                continue
            if self.rounds - self._evicted_at[r] > self.resurrection_window:
                self._evicted_at.pop(r, None)
                continue
            self._evicted_at.pop(r, None)
            events.append(ElasticEvent(
                EventKind.SCALE_OUT, step, (r,),
                detail="resurrection: heartbeat after false-positive eviction"))
        return events

    def _expire_grants(self):
        expired = [g for g in self._pending_grants.values()
                   if self.rounds - g.granted_at >= self.grant_timeout]
        for g in expired:
            del self._pending_grants[g.rank]
            self._stuck.append(g)

    # -- passthroughs used by executors ------------------------------------

    def max_confirm_misses(self) -> int:
        return self.agent.max_confirm_misses()
