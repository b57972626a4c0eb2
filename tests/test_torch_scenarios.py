"""The port's scenario specs, metrics and invariant checkers against the JAX
package's, on the CPU.

Spec: every ``Scenario`` builder, the legality ``ValueError``s,
``node_shrink_cells`` and capacity-trace replays give the reference's
events and descriptions.  ``ScenarioResult`` survives a JSON round trip.
The reference's injected-violation tests, ported: a shard corruptor, the
naive rank-addressed RNG, a tampered communicator and a batch mutator must
each be caught by the port's checkers.  ``tiny_config`` gives every family's
config field for field, and building a block the port has not ported still
raises.  On a CPU cluster the default checkers run: the parameter twin on
the seed path holds the fast path with ``==``; the kernel-consistency
checker's card twin raises without a card, so it never passes in silence.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core.events import (ElasticEvent as JEvent,  # noqa: E402
                               EventKind as JKind, burst as j_burst)
from repro.core.clusterview import FailureDomainMap as JDomains  # noqa: E402
from repro.models.registry import tiny_config as j_tiny  # noqa: E402
from repro.scenarios import spec as j_spec  # noqa: E402
from repro.scenarios.fuzz import (make_analytic_case,  # noqa: E402
                                  make_cluster_case)

from repro_torch.core import zero as t_zero  # noqa: E402
from repro_torch.core.clusterview import FailureDomainMap  # noqa: E402
from repro_torch.core.communicator import DynamicCommunicator  # noqa: E402
from repro_torch.core.cost_model import HardwareSpec  # noqa: E402
from repro_torch.core.events import ElasticEvent, EventKind, burst  # noqa: E402
from repro_torch.core.invariants import (  # noqa: E402
    DataflowConsistencyChecker, InvariantChecker, InvariantViolation,
    KernelConsistencyChecker, MttrBoundChecker, ParameterConsistencyChecker,
    RngConsistencyChecker, default_analytic_checkers,
    default_cluster_checkers)
from repro_torch.core.policies import ElasWavePolicy  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.scenarios import (SCENARIOS, AnalyticScenarioRunner,  # noqa: E402
                                   AnalyticWorkload, ClusterScenarioRunner,
                                   ClusterWorkload, Scenario, ScenarioResult,
                                   get_scenario, node_shrink_cells,
                                   run_scenario, validate_event_legality)


def fields_of(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def to_port_events(events):
    return tuple(ElasticEvent(**{**fields_of(e),
                                 "kind": EventKind(e.kind.value)})
                 for e in events)


def to_port_analytic(case):
    w = case.workload
    return Scenario(case.scenario.name, to_port_events(case.scenario.events),
                    case.scenario.horizon), AnalyticWorkload(
        **{**fields_of(w), "cfg": ModelConfig(**fields_of(w.cfg)),
           "hw": HardwareSpec(**fields_of(w.hw))})


class CpuWorkload(ClusterWorkload):
    """Pins every cluster it makes to the CPU, the kernel-consistency
    checker's twin too: a same-device twin, whose only differences from
    the run are the ones a trace injects."""

    def make_cluster(self, **overrides):
        return super().make_cluster(**{**overrides, "device": "cpu"})


def to_port_cluster(case, workload=ClusterWorkload, **over):
    kw = fields_of(case.workload)
    assert kw.pop("use_pallas") is False
    return (Scenario(case.scenario.name, to_port_events(case.scenario.events),
                     case.scenario.horizon),
            workload(**{**kw, "device": "cpu", **over}))


def shrink_case(make, seeds=range(60)):
    for seed in seeds:
        c = make(seed)
        if any(e.is_shrink for e in c.scenario.events):
            return c
    raise RuntimeError("no shrink-bearing seed in range")


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------
def _builder_pairs():
    """(reference scenario, port scenario) for every builder."""
    jd, td = JDomains(24, 4), FailureDomainMap(24, 4)
    out = []
    for mod, Ev, Kind, bst, dom, pkg in (
            (j_spec, JEvent, JKind, j_burst, jd, "ref"),
            (None, ElasticEvent, EventKind, burst, td, "port")):
        S = j_spec.Scenario if pkg == "ref" else Scenario
        base = S("mixed", (Ev(Kind.FAIL_STOP, 5, (1,)),
                           Ev(Kind.FAIL_SLOW, 2, (0,), slow_factor=1.2),
                           Ev(Kind.FAIL_SLOW, 2, (3,), slow_factor=1.4)), 7)
        pre = S.preempt_notice("pre", 2, (4, 1), 9, deadline=30.0,
                               rejoin_step=6)
        out.append([
            base,
            S.single("single", Kind.FAIL_SLOW, 2, (3,), 5, slow_factor=1.6),
            S.fail_stop_burst("burst", 3, (6, 1), 7),
            S.cascade("cascade", [(0, 1.25), (2, 1.5)], 2, 2, 9,
                      absorb_freq=((0, 2), 1.4, 6)),
            S.cascade("cascade-plain", [(1, 2.0)], 0, 1, 3),
            S.domain_burst("dom", 1, (2, 0), dom, 6, regrow_step=4),
            S.domain_burst("dom-slow", 1, (1,), dom, 3, kind=Kind.SCALE_IN),
            S.shrink_regrow("sr", 3, 2, 5, 8),
            S.from_capacity_trace("cap", [(100, 0), (50, 1), (50, 2),
                                          (50, 0)], dp=4, pp=3),
            S.from_capacity_trace("cap-degraded", [(30, 2), (20, 1)],
                                  dp=3, pp=2),
            pre, pre.reactive_twin(),
            S.migration_probe("mig", [(0,), (1, 2), (3,)], src=0, dst=1),
        ])
    return list(zip(*out))


def test_scenario_builders_match_reference():
    for a, b in _builder_pairs():
        assert a.describe() == b.describe()
        assert a.event_steps == b.event_steps
        for s in range(a.horizon):
            assert [e.describe() for e in a.events_at(s)] == \
                [e.describe() for e in b.events_at(s)]
        assert [dataclasses.astuple(e)[1:] for e in a.events] == \
            [dataclasses.astuple(e)[1:] for e in b.events]
        assert [e.kind.value for e in a.events] == \
            [e.kind.value for e in b.events]


@pytest.mark.parametrize("n_nodes,dp,pp", [(1, 4, 2), (3, 8, 3), (5, 3, 2),
                                           (4, 4, 4), (2, 2, 1)])
def test_node_shrink_cells_match_reference(n_nodes, dp, pp):
    assert node_shrink_cells(n_nodes, dp, pp) == \
        j_spec.node_shrink_cells(n_nodes, dp, pp)


ILLEGAL = [
    ("dup", [("fail_stop", 1, (2, 2))]),
    ("live-rejoin", [("scale_out", 1, (0,))]),
    ("refail", [("fail_stop", 1, (3,)), ("scale_in", 2, (3,))]),
    ("neg-step", [("fail_stop", -1, (0,))]),
    ("neg-rank", [("fail_slow", 0, (-2,))]),
    ("rejoin-first", [("scale_out", 1, (2,)), ("fail_stop", 2, (2,))]),
]


@pytest.mark.parametrize("name,trace", ILLEGAL)
def test_illegal_traces_raise_reference_errors(name, trace):
    errs = []
    for Ev, Kind, S in ((JEvent, JKind, j_spec.Scenario),
                        (ElasticEvent, EventKind, Scenario)):
        evs = tuple(Ev(Kind(k), s, r) for k, s, r in trace)
        with pytest.raises(ValueError) as ei:
            S(name, evs, horizon=5)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="outside horizon"):
        Scenario("late", (ElasticEvent(EventKind.FAIL_STOP, 4, (0,)),), 4)
    validate_event_legality((ElasticEvent(EventKind.FAIL_SLOW, 1, (0,)),
                             ElasticEvent(EventKind.FAIL_SLOW, 2, (0,))))


def test_library_matches_reference():
    from repro.scenarios.library import SCENARIOS as J_SCENARIOS
    assert list(SCENARIOS) == list(J_SCENARIOS)
    for name in SCENARIOS:
        (a, wa), (b, wb) = J_SCENARIOS[name](), get_scenario(name)
        assert a.describe() == b.describe()
        da, db = wa.describe(), wb.describe()
        assert da.pop("use_pallas") is False and db.pop("device") is None
        assert da == db
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("no_such_scenario")


def test_scenario_result_json_round_trip(tmp_path):
    case = make_analytic_case(3)
    scn, w = to_port_analytic(case)
    res = AnalyticScenarioRunner(scn, w, ElasWavePolicy(w.hw),
                                 checkers=default_analytic_checkers()).run()
    path = res.write(tmp_path / "arts")
    assert path.name == f"{scn.name}.json"
    back = ScenarioResult(**json.loads(path.read_text()))
    assert back.to_json() == res.to_json()
    assert back.mttr_total == res.mttr_total
    assert json.loads(back.to_json())["mode"] == "analytic"


# ---------------------------------------------------------------------------
# the checkers on clusters (CPU), and injected violations
# ---------------------------------------------------------------------------
STACK = (DataflowConsistencyChecker, RngConsistencyChecker, MttrBoundChecker)


def test_cluster_fuzz_case_upholds_invariants():
    """A reference fuzz trace with a shrink through the port's runner: the
    dataflow, RNG and MTTR checkers pass, and a same-device kernel twin
    (spot check off) stays within the kernel-consistency bounds."""
    scn, w = to_port_cluster(shrink_case(make_cluster_case), CpuWorkload)
    res = ClusterScenarioRunner(
        scn, w, checkers=[KernelConsistencyChecker(spot_check=False),
                          *(c() for c in STACK)]).run()
    assert len(res.steps) == scn.horizon and res.recoveries
    assert all(np.isfinite(res.summary["losses"]))


def test_kernel_consistency_bounds_are_the_reference_s():
    """The port's checker keeps the reference's four bounds, and its
    ``loss_within`` and ``param_atol`` (which the card smoke's float32
    twins use) state the reference checker's loss and state tests."""
    from repro.core.invariants import KernelConsistencyChecker as JKCC
    for k in ("LOSS_RTOL", "LOSS_ATOL", "PARAM_RTOL", "PARAM_ATOL0"):
        assert getattr(KernelConsistencyChecker, k) == getattr(JKCC, k)
    _, w = to_port_cluster(shrink_case(make_cluster_case))
    cl = w.make_cluster()
    cl.train_step()
    assert cl.opt_step >= 1
    assert KernelConsistencyChecker.param_atol(cl) == \
        JKCC.PARAM_ATOL0 + 2.0 * cl.adam.lr * cl.opt_step
    b = 2.5
    edge = JKCC.LOSS_ATOL + JKCC.LOSS_RTOL * b
    assert KernelConsistencyChecker.loss_within(b + edge / 2, b)
    assert not KernelConsistencyChecker.loss_within(b + 2 * edge, b)


class _ShardCorruptor(InvariantChecker):
    """Flips one master-weight element after each step (a silent bit
    error)."""
    name = "shard-corruptor"

    def after_cluster_step(self, step, cluster, loss):
        cluster.stages[0].flat["master"][0] += 1.0


def test_injected_shard_corruption_is_caught():
    scn, w = to_port_cluster(shrink_case(make_cluster_case), CpuWorkload)
    with pytest.raises(InvariantViolation, match="kernel-consistency"):
        ClusterScenarioRunner(
            scn, w, checkers=[_ShardCorruptor(),
                              KernelConsistencyChecker(
                                  spot_check=False)]).run()


def test_layout_check_catches_a_wrong_ownership_map(monkeypatch):
    """The parameter checker's layout half re-derives every shard through
    ``zero.Layout``; an ownership map that disagrees with the stage's is
    caught."""
    _, w = to_port_cluster(shrink_case(make_cluster_case))
    cl = w.make_cluster()
    chk = ParameterConsistencyChecker()
    for p, st in enumerate(cl.stages):
        chk._check_layout("start", p, st)
    assert len(cl.stages[0].dp_ranks) >= 2
    orig = t_zero.Layout.owner_intervals
    monkeypatch.setattr(t_zero.Layout, "owner_intervals",
                        lambda self, j: orig(self, self.dp - 1 - j))
    with pytest.raises(InvariantViolation,
                       match="parameter-consistency.*zero.Layout"):
        chk._check_layout("start", 0, cl.stages[0])


def test_naive_rng_mode_is_caught():
    """The paper's rank-addressed ablation moves surviving samples' streams
    on the first dataflow resize (§4.4)."""
    scn, w = to_port_cluster(shrink_case(make_cluster_case),
                             rng_mode="naive")
    with pytest.raises(InvariantViolation, match="rng-consistency"):
        ClusterScenarioRunner(scn, w, checkers=[c() for c in STACK]).run()


class _TamperedComm(DynamicCommunicator):
    """A communicator whose committed edits cost twice the truth."""

    def apply(self, delta, policy="edit"):
        stats = super().apply(delta, policy)
        stats.seconds *= 2.0
        return stats


def test_tampered_communicator_is_caught():
    scn, w = to_port_analytic(shrink_case(make_analytic_case))
    with pytest.raises(InvariantViolation, match="mttr-throughput"):
        AnalyticScenarioRunner(scn, w, ElasWavePolicy(hw=w.hw),
                               comm_factory=_TamperedComm,
                               checkers=default_analytic_checkers()).run()


class _BatchMutator(InvariantChecker):
    """Silently shrinks the global batch after the first event (§4.1)."""
    name = "batch-mutator"

    def after_analytic_event(self, step, event, view, comm, extra):
        view.global_batch -= 1


def test_mutated_global_batch_is_caught():
    scn, w = to_port_analytic(shrink_case(make_analytic_case))
    with pytest.raises(InvariantViolation, match="dataflow-consistency"):
        AnalyticScenarioRunner(
            scn, w, ElasWavePolicy(hw=w.hw),
            checkers=[_BatchMutator(), DataflowConsistencyChecker()]).run()


def test_cpu_cluster_checkers_do_not_pass_in_silence():
    """``default_cluster_checkers(device="cpu")`` holds invariant 1 with the
    seed-path twin: a shrink-bearing trace passes every checker, the twin
    run through each event and step (its loss trajectory equals the
    run's); the card checkers' spot check raises without a card."""
    scn, w = to_port_cluster(shrink_case(make_cluster_case))
    cks = default_cluster_checkers(device="cpu")
    assert [type(c) for c in cks] == [ParameterConsistencyChecker, *STACK]
    res = run_scenario(scn, w, checkers=cks)
    assert len(res.steps) == scn.horizon and res.recoveries
    twin = cks[0].twin
    assert twin is not None and twin.fast_path is False
    assert twin.losses == res.summary["losses"]
    assert twin.step_count == scn.horizon
    card = default_cluster_checkers(device="cuda")
    assert [type(c) for c in card] == [KernelConsistencyChecker, *STACK]
    assert [type(c) for c in default_cluster_checkers()] == \
        [type(c) for c in card]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_scenario(scn, w, checkers=card)
        with pytest.raises(RuntimeError, match="CUDA"):
            run_scenario(scn, w, checkers=[KernelConsistencyChecker(
                spot_check=False)])


# ---------------------------------------------------------------------------
# tiny_config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid",
                                    "audio", "vlm"])
def test_tiny_config_matches_reference(family):
    a, b = j_tiny(family), R.tiny_config(family)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    over = dict(num_layers=6, dropout_rate=0.1)
    assert dataclasses.asdict(j_tiny(family, **over)) == \
        dataclasses.asdict(R.tiny_config(family, **over))
    assert R.flat_layer_types(b) == [
        t for pat, rep in a.block_pattern() for t in list(pat) * rep]
    gen = torch.Generator().manual_seed(0)
    # every family's decoder layers build (moe and hybrid since the MoE
    # slice), each with the reference's sublayers
    for i in range(b.num_layers):
        p = R.init_layer(gen, b, i)
        assert ("moe" in p) == R.flat_layer_types(b)[i].endswith("moe")
