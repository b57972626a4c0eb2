"""Declarative elastic-scenario specs.

A copy of ``repro.scenarios.spec`` (the JAX package) for the port: a
:class:`ClusterWorkload` builds the port's ``VirtualCluster`` on ``device``
(the card by default) where the reference's chose ``use_pallas``.

A :class:`Scenario` is a named, ordered trace of timed
:class:`~repro_torch.core.events.ElasticEvent` injections over a horizon of steps
(cluster mode) or seconds (analytic trace replay).  Scenarios compose: the
builders below cover single failures, concurrent multi-rank bursts, cascades
of worsening stragglers, DVFS setpoints, directed migrations, and
SpotServe-style capacity-trace replays — the ROADMAP's "as many scenarios as
you can imagine" expressed as data instead of bespoke event loops.

Two workload descriptions exist because the runner has two execution modes
(see :mod:`repro_torch.scenarios.runner`):

* :class:`ClusterWorkload` — a tiny real model driven numerically on the
  :class:`~repro_torch.core.cluster.VirtualCluster` (losses, live remap,
  consistency checks);
* :class:`AnalyticWorkload` — a paper-scale workload (e.g. Llama-2 on 96
  NPUs) evaluated through the recovery policies and cost models only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import HardwareSpec, SegmentCosts
from repro_torch.core.events import ElasticEvent, EventKind, burst
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ClusterWorkload:
    """A VirtualCluster-sized workload (tiny real model, real numerics)."""
    family: str = "dense"
    num_layers: int = 8
    dropout_rate: float = 0.1
    dp: int = 4
    pp: int = 2
    global_batch: int = 16
    num_micro: int = 2
    seq_len: int = 16
    seed: int = 0
    rng_mode: str = "reshard"
    device: Optional[str] = None        # None: the card

    def make_cluster(self, **overrides):
        """Build the VirtualCluster.  ``overrides`` pass straight through to
        the constructor — e.g. ``device="cpu"`` with the card cluster's
        ``init_params`` builds the plain-version twin the tolerance-tier
        kernel checker compares a card run against, and ``fast_path=False``
        the seed-path twin of the bit-exact parameter checker."""
        from repro_torch.core.cluster import VirtualCluster
        from repro_torch.models import registry as R
        cfg = R.tiny_config(self.family, num_layers=self.num_layers,
                            dropout_rate=self.dropout_rate)
        kw = dict(global_batch=self.global_batch, num_micro=self.num_micro,
                  seq_len=self.seq_len, seed=self.seed,
                  rng_mode=self.rng_mode, device=self.device)
        kw.update(overrides)
        return VirtualCluster(cfg, dp=self.dp, pp=self.pp, **kw)

    def rank(self, d: int, p: int) -> int:
        return d * self.pp + p

    def describe(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AnalyticWorkload:
    """A paper-scale workload evaluated through policies + cost models.

    ``domain_size`` (ranks per rack/pod) activates correlated failure
    domains: the built views carry a
    :class:`~repro_torch.core.clusterview.FailureDomainMap` and at-scale
    scenarios can sample whole domains (``Scenario.domain_burst``)."""
    cfg: ModelConfig
    dp: int
    pp: int
    mbs: int
    global_batch: int
    seq: int
    hw: HardwareSpec
    mem_cap: Optional[float] = None
    domain_size: Optional[int] = None

    @property
    def num_micro(self) -> int:
        return self.global_batch // (self.mbs * self.dp)

    @property
    def domains(self):
        if self.domain_size is None:
            return None
        from repro_torch.core.clusterview import FailureDomainMap
        return FailureDomainMap(self.dp * self.pp, self.domain_size)

    def rank(self, d: int, p: int) -> int:
        return d * self.pp + p

    def build_seg(self) -> SegmentCosts:
        return SegmentCosts.build(self.cfg, self.seq, self.hw)

    def build_view(self, seg: SegmentCosts, alive: Optional[np.ndarray] = None,
                   slow: Optional[np.ndarray] = None):
        """A ClusterView over this workload (balanced layer assignment)."""
        from repro_torch.core.policies import ClusterView
        L, pp = self.cfg.num_layers, self.pp
        per, rem = L // pp, L % pp
        ranges, a = [], 0
        for p in range(pp):
            b = a + per + (1 if p < rem else 0) - 1
            ranges.append((a, b))
            a = b + 1
        return ClusterView(
            dp=self.dp, pp=self.pp, global_batch=self.global_batch,
            num_micro=self.num_micro, seq=self.seq, layer_assignment=ranges,
            alive=alive if alive is not None else np.ones((self.dp, self.pp), bool),
            freq=np.ones((self.dp, self.pp)),
            slow=slow if slow is not None else np.ones((self.dp, self.pp)),
            mem_cap=self.mem_cap if self.mem_cap is not None
            else self.hw.hbm_bytes,
            domains=self.domains)

    def describe(self) -> Dict:
        return {"model": self.cfg.name, "dp": self.dp, "pp": self.pp,
                "mbs": self.mbs, "global_batch": self.global_batch,
                "seq": self.seq,
                **({"domain_size": self.domain_size}
                   if self.domain_size is not None else {})}


def node_shrink_cells(n_nodes: int, dp: int, pp: int) -> List[Tuple[int, int]]:
    """The paper's shrink pattern: one node = 2 workers, killed replica-major
    so distinct replicas fail first.  Monotone: ``cells(n)`` is a prefix of
    ``cells(n+1)``, which lets capacity traces move between levels by
    failing/rejoining only the delta."""
    cells: List[Tuple[int, int]] = []
    d = 0
    while len(cells) < 2 * n_nodes and d < dp:
        for p in (0, 1):
            if len(cells) < 2 * n_nodes:
                cells.append((d % dp, (p + d) % pp))
        d += 1
    return cells


# ---------------------------------------------------------------------------
# scenario
# ---------------------------------------------------------------------------
def validate_event_legality(events: Sequence[ElasticEvent],
                            name: str = "trace") -> None:
    """Construction-time trace legality — the fuzzer's definition of "legal".

    Walks the (step-sorted) events with a dead-rank set and raises a crisp
    ``ValueError`` on the shapes that used to fail deep inside the runner:
    duplicate ranks within one burst, negative steps/ranks, rejoin
    (SCALE_OUT) of a rank that is currently alive, and shrink (FAIL_STOP /
    SCALE_IN) of a rank that is already dead.  FAIL_SLOW / DVFS_SET / MIGRATE
    do not alter liveness (repeats are legal).  Grid-shape rules (never kill
    a stage's last replica) need dp x pp and live in the fuzzer's
    ``trace_is_legal`` (``repro_torch.scenarios.fuzz``).
    """
    dead: set = set()
    for e in events:
        if e.step < 0:
            raise ValueError(
                f"scenario {name!r}: event at negative step {e.step}")
        if any(r < 0 for r in e.ranks):
            raise ValueError(
                f"scenario {name!r}: negative rank in {e.describe()}")
        if len(set(e.ranks)) != len(e.ranks):
            raise ValueError(
                f"scenario {name!r}: duplicate ranks in burst "
                f"{e.describe()} at step {e.step}")
        if e.is_grow:
            live = sorted(set(e.ranks) - dead)
            if live:
                raise ValueError(
                    f"scenario {name!r}: rejoin of live rank(s) {live} at "
                    f"step {e.step} (SCALE_OUT may only target dead ranks)")
            dead -= set(e.ranks)
        elif e.is_shrink:
            already = sorted(set(e.ranks) & dead)
            if already:
                raise ValueError(
                    f"scenario {name!r}: shrink of already-dead rank(s) "
                    f"{already} at step {e.step}")
            dead |= set(e.ranks)


@dataclasses.dataclass
class Scenario:
    """An ordered trace of timed elastic events over a horizon."""
    name: str
    events: Tuple[ElasticEvent, ...]
    horizon: int
    description: str = ""

    def __post_init__(self):
        # stable sort by step; ties keep insertion order (burst determinism)
        self.events = tuple(sorted(self.events, key=lambda e: e.step))
        if self.events and self.events[-1].step >= self.horizon:
            raise ValueError(
                f"event at step {self.events[-1].step} outside horizon "
                f"{self.horizon} of scenario {self.name!r}")
        validate_event_legality(self.events, self.name)

    def events_at(self, step: int) -> List[ElasticEvent]:
        return [e for e in self.events if e.step == step]

    @property
    def event_steps(self) -> List[int]:
        return sorted({e.step for e in self.events})

    def describe(self) -> Dict:
        return {"name": self.name, "horizon": self.horizon,
                "description": self.description,
                "events": [e.describe() for e in self.events]}

    # -- builders ----------------------------------------------------------
    @staticmethod
    def single(name: str, kind: EventKind, step: int, ranks: Sequence[int],
               horizon: int, **kw) -> "Scenario":
        return Scenario(name, (ElasticEvent(kind, step, tuple(ranks), **kw),),
                        horizon)

    @staticmethod
    def fail_stop_burst(name: str, step: int, ranks: Sequence[int],
                        horizon: int) -> "Scenario":
        """Concurrent multi-rank failure (e.g. a node or switch domain)."""
        return Scenario(name, (burst(EventKind.FAIL_STOP, step, tuple(ranks)),),
                        horizon, description="concurrent multi-rank fail-stop")

    @staticmethod
    def cascade(name: str, cells_factors: Sequence[Tuple[int, float]],
                start: int, spacing: int, horizon: int,
                absorb_freq: Optional[Tuple[Sequence[int], float, int]] = None,
                ) -> "Scenario":
        """Cascading fail-slow: (rank, factor) pairs fire ``spacing`` steps
        apart; optionally followed by a DVFS_SET absorbing the stragglers
        (``absorb_freq=(ranks, freq, step)``)."""
        evs = [ElasticEvent(EventKind.FAIL_SLOW, start + i * spacing, (r,),
                            slow_factor=f)
               for i, (r, f) in enumerate(cells_factors)]
        if absorb_freq is not None:
            ranks, freq, step = absorb_freq
            evs.append(ElasticEvent(EventKind.DVFS_SET, step, tuple(ranks),
                                    freq=freq))
        return Scenario(name, tuple(evs), horizon,
                        description="cascading fail-slow with DVFS absorption")

    @staticmethod
    def domain_burst(name: str, step: int, domain_ids: Sequence[int],
                     domains, horizon: int,
                     kind: EventKind = EventKind.FAIL_STOP,
                     regrow_step: Optional[int] = None) -> "Scenario":
        """Correlated failure-domain burst: every rank of the given rack/pod
        domains (a :class:`~repro_torch.core.clusterview.FailureDomainMap`) fails
        at once — the at-scale shape i.i.d. rank sampling never produces.
        ``regrow_step`` optionally rejoins the whole block later."""
        ranks = tuple(int(r) for r in domains.ranks_of(list(domain_ids)))
        evs: List[ElasticEvent] = [
            burst(kind, step, ranks,
                  detail=f"domains {sorted(set(domain_ids))} down")]
        if regrow_step is not None:
            evs.append(burst(EventKind.SCALE_OUT, regrow_step, ranks,
                             detail="domain rejoin"))
        return Scenario(name, tuple(evs), horizon,
                        description="correlated rack/pod domain burst")

    @staticmethod
    def shrink_regrow(name: str, rank: int, fail_step: int, rejoin_step: int,
                      horizon: int) -> "Scenario":
        """Scale-down then scale-up rejoin of the same worker."""
        return Scenario(name, (
            ElasticEvent(EventKind.SCALE_IN, fail_step, (rank,)),
            ElasticEvent(EventKind.SCALE_OUT, rejoin_step, (rank,))),
            horizon, description="scale-down then scale-up rejoin")

    @staticmethod
    def from_capacity_trace(name: str, trace: Sequence[Tuple[int, int]],
                            dp: int, pp: int) -> "Scenario":
        """Spot-instance replay: ``trace`` is (duration, nodes_down) segments.
        Because the shrink pattern is a monotone prefix, moving between
        capacity levels emits SCALE_IN/SCALE_OUT events for the delta cells
        only; steps are wall-clock seconds."""
        events: List[ElasticEvent] = []
        t, prev = 0, 0
        horizon = sum(d for d, _ in trace)
        max_down = max((down for _, down in trace), default=0)
        seq = node_shrink_cells(max_down, dp, pp)
        for dur, down in trace:
            if down != prev and t > 0:
                lo, hi = 2 * min(prev, down), 2 * max(prev, down)
                ranks = tuple(d * pp + p for d, p in seq[lo:hi])
                kind = EventKind.SCALE_IN if down > prev else EventKind.SCALE_OUT
                events.append(ElasticEvent(kind, t, ranks,
                                           detail=f"capacity->{down} nodes down"))
            elif down != prev:          # trace starts degraded
                ranks = tuple(d * pp + p for d, p in seq[:2 * down])
                events.append(ElasticEvent(EventKind.SCALE_IN, 0, ranks))
            prev = down
            t += dur
        return Scenario(name, tuple(events), horizon,
                        description="capacity-trace replay (seconds horizon)")

    @staticmethod
    def preempt_notice(name: str, step: int, ranks: Sequence[int],
                       horizon: int, deadline: float = 120.0,
                       rejoin_step: Optional[int] = None) -> "Scenario":
        """Spot-style preemption with advance warning: the scheduler notifies
        at ``step`` and the ranks are drained proactively inside the
        ``deadline``-second window.  ``rejoin_step`` optionally brings the
        capacity back (preempted instances often return)."""
        evs: List[ElasticEvent] = [
            burst(EventKind.PREEMPT_NOTICE, step, tuple(ranks),
                  deadline=deadline, detail=f"{deadline:g}s notice")]
        if rejoin_step is not None:
            evs.append(burst(EventKind.SCALE_OUT, rejoin_step, tuple(ranks),
                             detail="preempted capacity returned"))
        return Scenario(name, tuple(evs), horizon,
                        description="preemption notice with proactive drain")

    def reactive_twin(self) -> "Scenario":
        """The reactive baseline of this scenario: every PREEMPT_NOTICE
        becomes a plain FAIL_STOP at the same step — the preemption lands and
        is *detected* instead of drained.  Everything else is unchanged, so
        (proactive MTTR) - (twin MTTR) isolates what the notice window buys."""
        evs = tuple(
            dataclasses.replace(e, kind=EventKind.FAIL_STOP,
                                detail=e.detail + " (reactive baseline)")
            if e.kind == EventKind.PREEMPT_NOTICE else e
            for e in self.events)
        return Scenario(self.name + "-reactive", evs, self.horizon,
                        description=self.description + " [reactive baseline]")

    @staticmethod
    def migration_probe(name: str, probes: Sequence[Tuple[int, ...]],
                        src: int = 0, dst: int = 1) -> "Scenario":
        """One MIGRATE event per probe (a tuple of layer ids), one step
        apart — used to meter migration stall in isolation."""
        evs = tuple(ElasticEvent(EventKind.MIGRATE, i, (), layers=tuple(ls),
                                 src_stage=src, dst_stage=dst)
                    for i, ls in enumerate(probes))
        return Scenario(name, evs, len(probes) + 1,
                        description="directed layer-migration probes")
