"""Seeded generator of *legal* adversarial elastic traces (the fuzzer).

A copy of ``repro.scenarios.fuzz`` (the JAX package) for the port.  Every
draw is the reference's: the same ``random.Random`` seed strings in the same
order, so a seed names the same workload and trace in both packages.  Where
the reference's cases chose ``use_pallas``, the port's numeric workloads
keep ``device=None``, the card: cluster, kernel and chaos cases run the
hand-written kernels under the tolerance-tier
:class:`~repro_torch.core.invariants.KernelConsistencyChecker` and its CPU
twin.  The reference's Pallas mode is the port's kernel mode
(``make_kernel_case``): the same grammar, with the dense or ssm family drawn.

The paper's claim is universally quantified — *every* legal elastic event
sequence preserves the four guarantees (§4) — so hand-picked scenario
builders can never close the argument.  This module draws random traces from
composable :class:`EventStrategy` combinators (fail-stop bursts, correlated
domain bursts, rejoins, cascading fail-slow, DVFS setpoints, directed
migrations, shrink-regrow interleavings) over randomized workload shapes
(dp x pp x model family), constrained to stay *legal*:

* never kill a stage's last surviving replica (training would be
  unrecoverable — that is outside the paper's claim);
* rejoin (SCALE_OUT) only currently-dead ranks, shrink only live ranks,
  no duplicate ranks within one burst (``spec.validate_event_legality``);
* bounded concurrent events per step and per trace.

Everything is derived from a single integer seed: ``make_analytic_case(s)``
/ ``make_cluster_case(s)`` / ``make_kernel_case(s)`` rebuild the exact
workload + trace, so a CI failure is reproducible with one command
(``FuzzCase.repro()``).
``run_case`` attaches the invariant checkers from ``core.invariants`` and
decorates any violation with that command; ``shrink_case`` greedily deletes
events (re-checking legality) to hand back a minimal failing trace.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import HardwareSpec
from repro_torch.core.events import ElasticEvent, EventKind, burst
from repro_torch.core.invariants import (InvariantViolation,
                                         default_analytic_checkers,
                                         default_cluster_checkers)

from .spec import (AnalyticWorkload, ClusterWorkload, Scenario,
                   validate_event_legality)


# ---------------------------------------------------------------------------
# trace state + legality
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TraceState:
    """Liveness bookkeeping threaded through the strategies while a trace is
    being drawn.  ``reserved`` ranks have a scheduled future rejoin and may
    not be touched by any other strategy; a dead rank stays counted as dead
    here even past its rejoin step (conservative: the generator under-counts
    widths, so the never-kill-the-last-replica rule can only over-hold)."""
    dp: int
    pp: int
    horizon: int
    dead: set = dataclasses.field(default_factory=set)
    reserved: set = dataclasses.field(default_factory=set)

    def stage_of(self, rank: int) -> int:
        return rank % self.pp

    def width(self, p: int) -> int:
        return self.dp - sum(1 for r in self.dead if r % self.pp == p)

    def live_ranks(self) -> List[int]:
        return [r for r in range(self.dp * self.pp)
                if r not in self.dead and r not in self.reserved]

    def killable(self, extra_dead: set = frozenset()) -> List[int]:
        """Live, unreserved ranks whose removal keeps their stage >= 1 wide
        (``extra_dead``: ranks already picked for the same burst)."""
        out = []
        for r in self.live_ranks():
            if r in extra_dead:
                continue
            p = self.stage_of(r)
            w = self.width(p) - sum(1 for x in extra_dead if x % self.pp == p)
            if w >= 2:
                out.append(r)
        return out


def trace_is_legal(events: Sequence[ElasticEvent], dp: int, pp: int) -> bool:
    """Predicate form of trace legality (used by the shrinker, which must not
    raise): event-sequence rules from ``validate_event_legality`` plus the
    grid rules — ranks inside the dp x pp grid and every stage keeps >= 1
    live replica after every liveness event."""
    evs = sorted(events, key=lambda e: e.step)
    try:
        validate_event_legality(evs, "candidate")
    except ValueError:
        return False
    width = [dp] * pp
    for e in evs:
        if any(r >= dp * pp for r in e.ranks):
            return False
        if e.is_shrink:
            for r in e.ranks:
                width[r % pp] -= 1
            if min(width) < 1:
                return False
        elif e.is_grow:
            for r in e.ranks:
                width[r % pp] += 1
    return True


# ---------------------------------------------------------------------------
# strategy combinators
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EventStrategy:
    """One adversarial move: ``fn(rnd, state, step)`` either emits a list of
    legal events (mutating ``state``'s liveness books) or returns ``None``
    when inapplicable at this point of the trace."""
    name: str
    fn: Callable[[random.Random, TraceState, int],
                 Optional[List[ElasticEvent]]]
    weight: float = 1.0


def failstop_burst(max_ranks: int = 3) -> EventStrategy:
    """Concurrent multi-rank failure; 30% of draws arrive as scheduler
    SCALE_IN preemptions instead of FAIL_STOPs (same liveness effect)."""
    def fn(rnd, st, step):
        picked: set = set()
        for _ in range(rnd.randint(1, max_ranks)):
            pool = st.killable(picked)
            if not pool:
                break
            picked.add(rnd.choice(pool))
        if not picked:
            return None
        st.dead |= picked
        kind = EventKind.SCALE_IN if rnd.random() < 0.3 else EventKind.FAIL_STOP
        return [burst(kind, step, tuple(picked))]
    return EventStrategy("failstop_burst", fn, weight=2.0)


def rejoin(max_ranks: int = 4) -> EventStrategy:
    """SCALE_OUT of a random subset of the currently-dead ranks."""
    def fn(rnd, st, step):
        pool = sorted(st.dead - st.reserved)
        if not pool:
            return None
        k = rnd.randint(1, min(max_ranks, len(pool)))
        picked = rnd.sample(pool, k)
        st.dead -= set(picked)
        return [burst(EventKind.SCALE_OUT, step, tuple(picked))]
    return EventStrategy("rejoin", fn)


def fail_slow(factors: Tuple[float, ...] = (1.5, 2.0, 3.0)) -> EventStrategy:
    """A live rank starts straggling (repeats on the same rank are legal —
    that is the cascading-degradation shape)."""
    def fn(rnd, st, step):
        pool = st.live_ranks()
        if not pool:
            return None
        return [ElasticEvent(EventKind.FAIL_SLOW, step, (rnd.choice(pool),),
                             slow_factor=rnd.choice(factors))]
    return EventStrategy("fail_slow", fn)


def dvfs_set(freqs: Tuple[float, ...] = (1.0, 1.05, 1.1, 1.178)
             ) -> EventStrategy:
    """Frequency setpoint on a random subset of live ranks (straggler
    absorption / power capping)."""
    def fn(rnd, st, step):
        pool = st.live_ranks()
        if not pool:
            return None
        picked = rnd.sample(pool, rnd.randint(1, min(3, len(pool))))
        return [burst(EventKind.DVFS_SET, step, tuple(picked),
                      freq=rnd.choice(freqs))]
    return EventStrategy("dvfs_set", fn)


def shrink_regrow(max_gap: int = 3) -> EventStrategy:
    """Kill one rank now and schedule its rejoin a few steps later; the rank
    is *reserved* so no other strategy touches it in between (the
    interleaving shape that historically broke naive liveness tracking)."""
    def fn(rnd, st, step):
        if step >= st.horizon - 1:
            return None                       # no room for the rejoin
        pool = st.killable()
        if not pool:
            return None
        r = rnd.choice(pool)
        back = min(step + rnd.randint(1, max_gap), st.horizon - 1)
        st.dead.add(r)
        st.reserved.add(r)
        return [ElasticEvent(EventKind.SCALE_IN, step, (r,)),
                ElasticEvent(EventKind.SCALE_OUT, back, (r,))]
    return EventStrategy("shrink_regrow", fn)


def preempt(max_ranks: int = 2,
            deadlines: Tuple[float, ...] = (0.05, 2.0, 120.0)
            ) -> EventStrategy:
    """Preemption *notice*: liveness-wise a shrink, but the executor drains
    the ranks proactively inside the (randomly short or generous) deadline
    window instead of paying the detection + full-stall path."""
    def fn(rnd, st, step):
        picked: set = set()
        for _ in range(rnd.randint(1, max_ranks)):
            pool = st.killable(picked)
            if not pool:
                break
            picked.add(rnd.choice(pool))
        if not picked:
            return None
        st.dead |= picked
        return [burst(EventKind.PREEMPT_NOTICE, step, tuple(picked),
                      deadline=rnd.choice(deadlines))]
    return EventStrategy("preempt", fn, weight=0.8)


def migrate(num_layers: int, pp: int) -> EventStrategy:
    """Directed layer migration between two distinct stages (analytic-only:
    the numeric executor treats MIGRATE as a planner-internal action)."""
    def fn(rnd, st, step):
        if pp < 2:
            return None
        src = rnd.randrange(pp)
        dst = rnd.choice([p for p in range(pp) if p != src])
        per, rem = num_layers // pp, num_layers % pp
        lo = src * per + min(src, rem)
        n = per + (1 if src < rem else 0)
        layers = sorted(rnd.sample(range(lo, lo + n), min(rnd.randint(1, 3), n)))
        return [ElasticEvent(EventKind.MIGRATE, step, (), layers=tuple(layers),
                             src_stage=src, dst_stage=dst)]
    return EventStrategy("migrate", fn, weight=0.5)


def domain_burst(domains) -> EventStrategy:
    """Correlated whole-domain (rack/pod) failure with a later rejoin of the
    same block — the shape i.i.d. rank sampling never produces."""
    def fn(rnd, st, step):
        if domains is None or step >= st.horizon - 1:
            return None
        order = list(range(domains.n_domains))
        rnd.shuffle(order)
        for d in order:
            ranks = {int(r) for r in domains.ranks_of([d])}
            if ranks & (st.dead | st.reserved):
                continue
            if all(st.width(p) - sum(1 for r in ranks if r % st.pp == p) >= 1
                   for p in range(st.pp)):
                back = min(step + rnd.randint(1, 3), st.horizon - 1)
                st.dead |= ranks
                st.reserved |= ranks
                return [burst(EventKind.FAIL_STOP, step, tuple(ranks),
                              detail=f"domain {d} down"),
                        burst(EventKind.SCALE_OUT, back, tuple(ranks),
                              detail=f"domain {d} rejoin")]
        return None
    return EventStrategy("domain_burst", fn, weight=0.7)


def draw_trace(rnd: random.Random, *, dp: int, pp: int, horizon: int,
               strategies: Sequence[EventStrategy],
               max_events: Optional[int] = None,
               p_event: float = 0.6) -> List[ElasticEvent]:
    """Walk the horizon; at each step maybe fire one weighted strategy."""
    st = TraceState(dp=dp, pp=pp, horizon=horizon)
    weights = [s.weight for s in strategies]
    events: List[ElasticEvent] = []
    for step in range(horizon):
        if max_events is not None and len(events) >= max_events:
            break
        if rnd.random() >= p_event:
            continue
        strat = rnd.choices(list(strategies), weights=weights)[0]
        got = strat.fn(rnd, st, step)
        if got:
            events.extend(got)
    return events


# ---------------------------------------------------------------------------
# randomized workloads
# ---------------------------------------------------------------------------
def draw_analytic_workload(rnd: random.Random) -> AnalyticWorkload:
    from repro_torch.models import registry as R
    pp = rnd.choice((1, 2, 2, 3, 4))
    dp = rnd.randint(2, 6)
    family = rnd.choice(("dense", "moe", "ssm"))
    num_layers = pp * rnd.randint(2, 4)
    mbs = rnd.choice((1, 2))
    num_micro = rnd.randint(2, 4)
    return AnalyticWorkload(
        cfg=R.tiny_config(family, num_layers=num_layers),
        dp=dp, pp=pp, mbs=mbs, global_batch=mbs * dp * num_micro,
        seq=rnd.choice((64, 128, 256)), hw=HardwareSpec(),
        domain_size=pp if rnd.random() < 0.5 else None)


def draw_cluster_workload(rnd: random.Random) -> ClusterWorkload:
    """Numeric workloads stay tiny, so the fuzz budget goes to *traces*, not
    params.  ``device`` stays None: the card."""
    pp = rnd.choice((1, 2))
    dp = rnd.randint(2, 3)
    num_micro = rnd.choice((1, 2))
    per_rank = rnd.choice((1, 2))
    return ClusterWorkload(
        family="dense", num_layers=2 * pp,
        dropout_rate=rnd.choice((0.0, 0.1)), dp=dp, pp=pp,
        global_batch=dp * num_micro * per_rank, num_micro=num_micro,
        seq_len=8, seed=rnd.randrange(10 ** 6), rng_mode="reshard")


def default_analytic_strategies(w: AnalyticWorkload) -> List[EventStrategy]:
    return [failstop_burst(), rejoin(), fail_slow(), dvfs_set(),
            shrink_regrow(), migrate(w.cfg.num_layers, w.pp),
            domain_burst(w.domains), preempt()]


def default_cluster_strategies() -> List[EventStrategy]:
    """No MIGRATE (numeric executor rejects direct injection) and no domain
    bursts (cluster grids are too small for whole-domain kills)."""
    return [failstop_burst(max_ranks=2), rejoin(max_ranks=2),
            fail_slow(factors=(1.5, 2.0)), dvfs_set(), shrink_regrow(),
            preempt(max_ranks=1)]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FuzzCase:
    """A fully-reproducible fuzz input: seed -> (workload, trace)."""
    seed: int
    mode: str                   # "analytic" | "cluster" | "kernel"
    scenario: Scenario
    workload: object            # AnalyticWorkload | ClusterWorkload

    def repro(self, policy: Optional[str] = None) -> str:
        cmd = (f"PYTHONPATH=src python -m benchmarks.torch_fuzz_soak "
               f"--mode {self.mode} --seed {self.seed}")
        if policy:
            cmd += f" --policy {policy}"
        return cmd


def make_analytic_case(seed: int) -> FuzzCase:
    rnd = random.Random(f"analytic-{seed}")
    w = draw_analytic_workload(rnd)
    horizon = rnd.randint(6, 12)
    events = draw_trace(rnd, dp=w.dp, pp=w.pp, horizon=horizon,
                        strategies=default_analytic_strategies(w))
    return FuzzCase(seed, "analytic",
                    Scenario(f"fuzz-analytic-{seed}", tuple(events), horizon),
                    w)


def make_cluster_case(seed: int) -> FuzzCase:
    rnd = random.Random(f"cluster-{seed}")
    w = draw_cluster_workload(rnd)
    horizon = rnd.randint(3, 5)
    events = draw_trace(rnd, dp=w.dp, pp=w.pp, horizon=horizon,
                        strategies=default_cluster_strategies(),
                        max_events=3, p_event=0.7)
    return FuzzCase(seed, "cluster",
                    Scenario(f"fuzz-cluster-{seed}", tuple(events), horizon),
                    w)


def make_kernel_case(seed: int) -> FuzzCase:
    """Kernel-mode cluster fuzzing (the reference's ``make_pallas_case``,
    from its seed string, so a seed names the same case in both packages):
    the same trace grammar with the dense or the ssm family drawn, on the
    card, where ``run_case`` holds the kernels' cluster to its CPU twin
    under the tolerance-tier :class:`KernelConsistencyChecker`.  Traces are
    shorter than plain cluster mode, as the reference's are."""
    rnd = random.Random(f"pallas-{seed}")
    w = dataclasses.replace(draw_cluster_workload(rnd),
                            family=rnd.choice(("dense", "ssm")))
    horizon = rnd.randint(2, 3)
    events = draw_trace(rnd, dp=w.dp, pp=w.pp, horizon=horizon,
                        strategies=default_cluster_strategies(),
                        max_events=2, p_event=0.7)
    return FuzzCase(seed, "kernel",
                    Scenario(f"fuzz-kernel-{seed}", tuple(events), horizon),
                    w)


def make_case(mode: str, seed: int):
    if mode == "analytic":
        return make_analytic_case(seed)
    if mode == "cluster":
        return make_cluster_case(seed)
    if mode == "kernel":
        return make_kernel_case(seed)
    if mode == "chaos":
        return make_chaos_case(seed)
    raise ValueError(f"unknown fuzz mode {mode!r}")


POLICY_NAMES = ("elaswave", "torchft", "oobleck")


def make_policy(name: str, hw: Optional[HardwareSpec] = None):
    """Fresh policy per run — OobleckPolicy caches templates keyed by config
    identity, so instances must not leak across workloads."""
    from repro_torch.core.policies import (ElasWavePolicy, OobleckPolicy,
                                           TorchFTPolicy)
    if name == "elaswave":
        return ElasWavePolicy(hw=hw)
    if name == "torchft":
        return TorchFTPolicy()
    if name == "oobleck":
        return OobleckPolicy(hw=hw)
    raise ValueError(f"unknown policy {name!r}")


def run_case(case: FuzzCase, policy: Optional[str] = None, checkers=None,
             **runner_kw):
    """Run one fuzz case with the default invariant checkers attached.

    Numeric cases default to ``default_cluster_checkers`` for the
    workload's device: on the card the tolerance-tier kernel checker with
    its CPU twin; on the CPU the bit-exact parameter checker with its
    seed-path twin (``fast_path=False``), so that invariant 1 is never
    dropped in silence.

    An :class:`InvariantViolation` is re-raised with the fuzz seed and the
    one-line repro command appended, so a red CI log is actionable as-is.
    """
    from .runner import AnalyticScenarioRunner, ClusterScenarioRunner
    try:
        if case.mode == "analytic":
            pol = make_policy(policy or "elaswave", hw=case.workload.hw)
            cks = (default_analytic_checkers() if checkers is None
                   else checkers)
            return AnalyticScenarioRunner(case.scenario, case.workload, pol,
                                          checkers=cks, **runner_kw).run()
        cks = (default_cluster_checkers(device=case.workload.device)
               if checkers is None else checkers)
        return ClusterScenarioRunner(case.scenario, case.workload,
                                     checkers=cks, **runner_kw).run()
    except InvariantViolation as e:
        raise InvariantViolation(
            f"{e}\n  fuzz seed {case.seed} ({case.mode}); reproduce with:\n"
            f"  {case.repro(policy)}") from e


def shrink_case(case: FuzzCase,
                fails: Callable[[FuzzCase], bool]) -> FuzzCase:
    """Greedy event-deletion minimization: repeatedly drop any single event
    whose removal keeps the trace legal AND still failing.  Terminates when
    no single deletion reproduces the failure (1-minimal trace)."""
    current = case
    progress = True
    while progress:
        progress = False
        evs = list(current.scenario.events)
        for i in range(len(evs)):
            cand_events = evs[:i] + evs[i + 1:]
            w = current.workload
            if not trace_is_legal(cand_events, w.dp, w.pp):
                continue
            try:
                cand_scn = Scenario(current.scenario.name,
                                    tuple(cand_events),
                                    current.scenario.horizon)
            except ValueError:
                continue
            cand = dataclasses.replace(current, scenario=cand_scn)
            try:
                still_fails = fails(cand)
            except Exception:
                still_fails = True          # any crash counts as failing
            if still_fails:
                current = cand
                progress = True
                break
    return current


# ---------------------------------------------------------------------------
# detection chaos: the four guarantees under IMPERFECT detection
# ---------------------------------------------------------------------------
# The trace fuzzer above injects *perfectly detected* events.  The chaos
# layer instead perturbs the detection plane itself — probes are dropped,
# delayed, duplicated, reordered, and flapped; snapshot shards are silently
# corrupted — and lets the ElasticController decide what happened.  The
# checked property set grows by one: on top of the four paper invariants, a
# false-positive eviction must never be PERMANENT (the falsely-evicted rank
# resurrects through the normal SCALE_OUT path once its heartbeats reappear)
# and every truly-dead rank must still be evicted.
#
# Three chaos classes (drawn from the seed):
#
# * ``flap_only`` — no real failures at all; every eviction the controller
#   commits is by definition a false positive and must be healed by the end
#   of the settle window.  Runs under the FULL four-checker stack (the
#   invariant-1 twin receives the identical event sequence, so even a false
#   eviction + rejoin must keep the twins together: within the kernel
#   tolerance on the card, bit-identical on the CPU).
# * ``mixed``    — real kills and preemption notices interleaved with probe
#   chaos; the controller must evict the dead, drain the doomed, and heal
#   everything else.
# * ``corrupt``  — snapshot shards are bit-flipped at the recovery read
#   point: drains re-derive bit-for-bit from the departing device;
#   detected failures degrade to the tolerance-tier master rebuild
#   (``degraded`` recorded).  The invariant-1 twin is dropped (a rebuilt
#   shard legitimately differs by its zeroed Adam moments): the kernel
#   checker on the card, the parameter checker on the CPU; dataflow / RNG /
#   MTTR invariants still run.

CHAOS_CLASSES = ("flap_only", "mixed", "corrupt")


@dataclasses.dataclass(frozen=True)
class ChaosAction:
    """One ground-truth action of a chaos schedule (what REALLY happened,
    regardless of what the perturbed probes make it look like)."""
    step: int
    kind: str           # kill | notice | mem | corrupt_kill | corrupt_drain
    rank: int
    deadline: float = 120.0
    component: str = "master"
    value: float = 0.0  # mem: reported used fraction


@dataclasses.dataclass
class ChaosCase:
    """A fully-reproducible detection-chaos input: seed -> (workload,
    ground-truth schedule, chaos class).  Probe perturbations are drawn at
    run time from a seed-derived stream, so a seed is a complete repro."""
    seed: int
    chaos_class: str
    workload: ClusterWorkload
    actions: Tuple[ChaosAction, ...]
    horizon: int
    mode: str = "chaos"

    @property
    def scenario(self) -> Scenario:     # for artifact/shrink tooling parity
        return Scenario(f"fuzz-chaos-{self.seed}", (), self.horizon,
                        description=f"chaos class {self.chaos_class}")

    def repro(self, policy=None) -> str:
        return (f"PYTHONPATH=src python -m benchmarks.torch_fuzz_soak "
                f"--mode chaos --seed {self.seed}")


def make_chaos_case(seed: int) -> ChaosCase:
    rnd = random.Random(f"chaos-{seed}")
    chaos_class = rnd.choice(("flap_only", "flap_only", "mixed", "mixed",
                              "corrupt"))
    pp = rnd.choice((1, 2))
    dp = 3                      # real kills leave >= 2, false positives >= 1
    num_micro = rnd.choice((1, 2))
    w = ClusterWorkload(family="dense", num_layers=2 * pp, dropout_rate=0.0,
                        dp=dp, pp=pp, global_batch=dp * num_micro,
                        num_micro=num_micro, seq_len=8,
                        seed=rnd.randrange(10 ** 6))
    horizon = rnd.randint(4, 6)
    actions: List[ChaosAction] = []
    removed = {p: 0 for p in range(pp)}     # truth removals per stage

    def pick_rank():
        pool = [r for r in range(dp * pp)
                if removed[r % pp] < dp - 1
                and all(a.rank != r for a in actions)]
        return rnd.choice(pool) if pool else None

    if chaos_class == "mixed":
        for kind in ("kill", "notice"):
            if kind == "notice" and rnd.random() < 0.4:
                continue
            r = pick_rank()
            if r is None:
                continue
            removed[r % pp] += 1
            actions.append(ChaosAction(step=rnd.randint(1, horizon - 1),
                                       kind=kind, rank=r,
                                       deadline=rnd.choice((0.05, 120.0))))
        if rnd.random() < 0.7:              # an OOM ramp on a live rank
            live = [r for r in range(dp * pp)
                    if all(a.rank != r for a in actions)]
            r = rnd.choice(live)
            for i, frac in enumerate((0.5, 0.7, 0.85, 0.97)):
                if i >= horizon:
                    break
                actions.append(ChaosAction(step=i, kind="mem", rank=r,
                                           value=frac))
    elif chaos_class == "corrupt":
        for _ in range(rnd.randint(1, 2)):
            r = pick_rank()
            if r is None:
                break
            removed[r % pp] += 1
            actions.append(ChaosAction(
                step=rnd.randint(1, horizon - 1),
                kind=rnd.choice(("corrupt_kill", "corrupt_drain")),
                rank=r, component=rnd.choice(("master", "mu", "nu"))))
    return ChaosCase(seed, chaos_class, w, tuple(actions), horizon)


INVARIANT_1 = ("kernel-consistency", "parameter-consistency")


def default_chaos_checkers(case: ChaosCase):
    """``default_cluster_checkers`` for the case's device, less the
    invariant-1 twin in the ``corrupt`` class."""
    checkers = default_cluster_checkers(device=case.workload.device)
    if case.chaos_class == "corrupt":
        checkers = [c for c in checkers if c.name not in INVARIANT_1]
    return checkers


class DetectionChaosRunner:
    """Drive a VirtualCluster through a chaos case: ground-truth actions
    mutate reality, perturbed probes feed the ElasticController, and
    whatever the controller decides is executed — then the settle window
    must heal every false verdict.

    Probe perturbation knobs (drawn per case): drop, duplicate, one-round
    delay, reorder, and flap (a live rank's heartbeat reads false)."""

    def __init__(self, case: ChaosCase, checkers=None):
        self.case = case
        self.workload = case.workload
        if checkers is None:
            checkers = default_chaos_checkers(case)
        self.checkers = checkers

    # -- probe synthesis ---------------------------------------------------
    def _probes(self, cl, rnd, truth_dead, delayed, chaotic,
                p_flap, p_drop, p_dup, p_delay):
        """Truthful probes for every grid rank (dead ranks are silent;
        unregistered-but-alive ranks still probe, feeding resurrection),
        perturbed when ``chaotic``."""
        from repro_torch.core.agent import Probe
        base_t = 0.1
        out = list(delayed)
        delayed.clear()
        for rank in range(cl.dp0 * cl.pp):
            if rank in truth_dead:
                continue                      # the dead emit nothing
            hb = True
            if chaotic and rnd.random() < p_flap:
                hb = False                    # transient blip
            p = Probe(cl.step_count, rank, heartbeat=hb,
                      step_seconds=base_t,
                      mem_used=float(cl.mem_used[rank // cl.pp,
                                                 rank % cl.pp]))
            if chaotic and rnd.random() < p_drop:
                continue                      # lost on the wire
            if chaotic and rnd.random() < p_delay:
                delayed.append(p)             # arrives next round, stale
                continue
            out.append(p)
            if chaotic and rnd.random() < p_dup:
                out.append(Probe(p.step, p.rank, p.heartbeat,
                                 p.step_seconds, p.mem_used))
        if chaotic:
            rnd.shuffle(out)                  # reordered delivery
        return out

    # -- main loop ---------------------------------------------------------
    def run(self):
        case = self.case
        cl = self.workload.make_cluster()
        rnd = random.Random(f"chaos-exec-{case.seed}")
        p_flap = rnd.uniform(0.05, 0.3)
        p_drop = rnd.uniform(0.0, 0.2)
        p_dup = rnd.uniform(0.0, 0.3)
        p_delay = rnd.uniform(0.0, 0.15)
        for c in self.checkers:
            c.on_cluster_start(self, cl)
        truth_dead: set = set()
        delayed: List = []
        expected_degraded = 0
        got_degraded = 0
        by_step: Dict[int, List[ChaosAction]] = {}
        for a in case.actions:
            by_step.setdefault(a.step, []).append(a)

        def apply_ev(ev):
            nonlocal got_degraded
            rec = cl.apply_event(ev)
            got_degraded += int(rec.get("degraded", 0))
            for c in self.checkers:
                c.after_cluster_event(cl.step_count, ev, cl, rec)
            return rec

        def cell(rank):
            return rank // cl.pp, rank % cl.pp

        step = 0
        settle_left = None
        while True:
            chaotic = step < case.horizon
            for act in by_step.get(step, ()):   # ground truth mutates reality
                d, p = cell(act.rank)
                if act.kind == "kill":
                    truth_dead.add(act.rank)
                elif act.kind == "mem":
                    cl.inject_mem_pressure(d, p, act.value)
                elif act.kind in ("notice", "corrupt_kill", "corrupt_drain"):
                    if act.kind.startswith("corrupt"):
                        # bit rot at the recovery read point: corrupt the
                        # holder's stored copy of this rank's shard (shard
                        # index = position in the stage's surviving group)
                        j = cl.stages[p].dp_ranks.index(d)
                        cl.snapshots[p].corrupt_shard(j, act.component)
                    if act.kind == "corrupt_kill":
                        truth_dead.add(act.rank)
                        expected_degraded += 1
                        apply_ev(ElasticEvent(EventKind.FAIL_STOP,
                                              cl.step_count, (act.rank,)))
                    else:                       # notice / corrupt_drain
                        truth_dead.add(act.rank)
                        apply_ev(ElasticEvent(EventKind.PREEMPT_NOTICE,
                                              cl.step_count, (act.rank,),
                                              deadline=act.deadline))
            probes = self._probes(cl, rnd, truth_dead, delayed, chaotic,
                                  p_flap, p_drop, p_dup, p_delay)
            events = cl.controller.observe(probes)
            for ev in events:
                apply_ev(ev)
            loss = cl.train_step()
            for c in self.checkers:
                c.after_cluster_step(cl.step_count - 1, cl, loss)
            step += 1
            if step >= case.horizon:
                if settle_left is None:         # size the settle window once
                    settle_left = cl.agent.max_confirm_misses() + 4
                else:
                    settle_left -= 1
                stable = (not events
                          and all(h.state.value == "healthy"
                                  for h in cl.agent.health.values())
                          and self._grid_matches_truth(cl, truth_dead))
                if stable or settle_left <= 0:
                    break
        self._final_asserts(cl, truth_dead, expected_degraded, got_degraded)
        return cl

    @staticmethod
    def _grid_matches_truth(cl, truth_dead) -> bool:
        for rank in range(cl.dp0 * cl.pp):
            d, p = rank // cl.pp, rank % cl.pp
            if bool(cl.alive[d, p]) != (rank not in truth_dead):
                return False
        return True

    def _final_asserts(self, cl, truth_dead, expected_degraded,
                       got_degraded):
        falsely_evicted = []
        missed_evictions = []
        for rank in range(cl.dp0 * cl.pp):
            d, p = rank // cl.pp, rank % cl.pp
            if rank in truth_dead:
                if bool(cl.alive[d, p]) or rank in cl.agent.times:
                    missed_evictions.append(rank)
            else:
                if not bool(cl.alive[d, p]) or rank not in cl.agent.times:
                    falsely_evicted.append(rank)
        if falsely_evicted:
            raise InvariantViolation(
                f"[detection-chaos] class {self.case.chaos_class}: ranks "
                f"{falsely_evicted} are PERMANENTLY evicted although their "
                f"workers are alive (false positive not healed by "
                f"resurrection)")
        if missed_evictions:
            raise InvariantViolation(
                f"[detection-chaos] class {self.case.chaos_class}: dead "
                f"ranks {missed_evictions} were never evicted")
        if got_degraded != expected_degraded:
            raise InvariantViolation(
                f"[detection-chaos] class {self.case.chaos_class}: expected "
                f"{expected_degraded} tolerance-tier (degraded) shard "
                f"rebuilds, recovery records show {got_degraded}")
        import numpy as _np
        if not all(_np.isfinite(l) for l in cl.losses):
            raise InvariantViolation(
                f"[detection-chaos] class {self.case.chaos_class}: "
                f"non-finite loss after chaotic recovery")


def run_chaos_case(case: ChaosCase, checkers=None):
    """Run one detection-chaos case; violations carry the one-line repro."""
    try:
        return DetectionChaosRunner(case, checkers=checkers).run()
    except InvariantViolation as e:
        raise InvariantViolation(
            f"{e}\n  chaos seed {case.seed} ({case.chaos_class}); reproduce "
            f"with:\n  {case.repro()}") from e


# ---------------------------------------------------------------------------
# detector-level chaos sweep (no cluster: pure control-plane, sub-ms/seed)
# ---------------------------------------------------------------------------
def run_detector_chaos(seed: int) -> None:
    """Property check of Agent + ElasticController alone under probe chaos —
    no numerics, so hundreds of seeds cost milliseconds.  A membership shim
    plays the executor: FAIL_STOP unregisters the rank, SCALE_OUT
    re-registers it.  Asserts: no permanent false evictions, every
    truly-dead rank confirmed, stuck grants recovered.  Raises
    ``AssertionError`` (with the seed) on violation."""
    from repro_torch.core.agent import Agent, Probe
    from repro_torch.core.controller import ElasticController
    rnd = random.Random(f"detchaos-{seed}")
    pp = rnd.choice((1, 2, 3))
    dp = rnd.randint(2, 4)
    n = dp * pp
    agent = Agent(n, miss_limit=2, stage_of={r: r % pp for r in range(n)})
    ctl = ElasticController(agent, grant_timeout=4)
    flap_only = rnd.random() < 0.5
    truth_dead: set = set()
    horizon = rnd.randint(8, 16)
    p_flap = rnd.uniform(0.1, 0.4)
    p_drop = rnd.uniform(0.0, 0.25)
    p_dup = rnd.uniform(0.0, 0.3)
    stuck_rank = None
    if rnd.random() < 0.3:                  # a grant that never joins
        stuck_rank = n + 7
        ctl.grant(stuck_rank, "phantom capacity")

    def observe(chaotic: bool):
        probes = []
        for r in range(n):
            if r in truth_dead:
                continue
            hb = not (chaotic and rnd.random() < p_flap)
            if chaotic and rnd.random() < p_drop:
                continue
            probes.append(Probe(0, r, hb, 0.1))
            if chaotic and rnd.random() < p_dup:
                probes.append(Probe(0, r, hb, 0.1))
        if chaotic:
            rnd.shuffle(probes)
        for ev in ctl.observe(probes):
            if ev.kind == EventKind.FAIL_STOP:
                for r in ev.ranks:
                    agent.remove_rank(r)
            elif ev.kind == EventKind.SCALE_OUT:
                for r in ev.ranks:
                    agent.add_rank(r, stage=r % pp)
                    ctl.note_join(r)

    for step in range(horizon):
        if not flap_only and rnd.random() < 0.15:
            # a real kill that keeps the stage non-empty in truth
            pool = [r for r in range(n) if r not in truth_dead
                    and sum(1 for q in range(n)
                            if q % pp == r % pp and q not in truth_dead) >= 2]
            if pool:
                truth_dead.add(rnd.choice(pool))
        observe(chaotic=True)
    for _ in range(agent.max_confirm_misses() + 2):     # settle: clean probes
        observe(chaotic=False)

    alive_regs = set(agent.ranks)
    false_perm = [r for r in range(n)
                  if r not in truth_dead and r not in alive_regs]
    assert not false_perm, \
        (f"detector-chaos seed {seed}: permanent false eviction of {false_perm}"
         f" ({'flap-only' if flap_only else 'mixed'} trace)")
    missed = [r for r in truth_dead if r in alive_regs]
    assert not missed, \
        f"detector-chaos seed {seed}: dead ranks {missed} never evicted"
    if stuck_rank is not None:
        assert any(g.rank == stuck_rank for g in ctl.stuck_grants()), \
            (f"detector-chaos seed {seed}: granted-but-never-joined rank "
             f"{stuck_rank} was not recovered as a stuck grant")
