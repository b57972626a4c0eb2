"""The port's recovery policies and analytic scenario runner against the JAX
package's, on the reference's own analytic fuzz traces.

``repro.scenarios.fuzz.make_analytic_case(seed)`` draws a workload (dense,
MoE or SSM tiny configs at dp 2-6, pp 1-4, with or without failure domains)
and a legal trace (bursts, rejoins, fail-slow, DVFS, shrink/regrow,
directed migrations, domain bursts, preemptions).  Each case is translated
field by field into the port's types and run through both packages'
``AnalyticScenarioRunner`` under the ElasWave, TorchFT and Oobleck policies,
the port's run with its ``default_analytic_checkers()`` attached.  The
results must be equal in every field but the measured
``decide_wall_seconds``.  Each policy's ``decide`` (ReCycle included) must
be equal on seeded views; the legacy dict/set communicator and the
control-plane helpers the policies and the runner use must be equal with
``==``: no tolerance.
"""
import dataclasses
import enum
import random
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import agent as j_agent  # noqa: E402
from repro.core import clusterview as j_cv  # noqa: E402
from repro.core import communicator as j_comm  # noqa: E402
from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import legacy_comm as j_legacy  # noqa: E402
from repro.core import pipeline as j_pipe  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core.planners import dataflow as j_df  # noqa: E402
from repro.core.planners import graph as j_graph  # noqa: E402
from repro.scenarios import runner as j_runner  # noqa: E402
from repro.scenarios.fuzz import (POLICY_NAMES, make_analytic_case,  # noqa: E402
                                  make_policy)

from repro_torch.core import agent as t_agent  # noqa: E402
from repro_torch.core import clusterview as t_cv  # noqa: E402
from repro_torch.core import communicator as t_comm  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import events as t_events  # noqa: E402
from repro_torch.core import legacy_comm as t_legacy  # noqa: E402
from repro_torch.core import pipeline as t_pipe  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core.invariants import default_analytic_checkers  # noqa: E402
from repro_torch.core.planners import dataflow as t_df  # noqa: E402
from repro_torch.core.planners import graph as t_graph  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.scenarios import (AnalyticScenarioRunner,  # noqa: E402
                                   AnalyticWorkload, Scenario)

SEEDS = range(40)


def norm(x):
    """A plain-Python image of ``x`` that two packages' objects share."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.tolist())
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return sorted(norm(v) for v in x)
    return x


def fields_of(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def to_port_event(e):
    kw = fields_of(e)
    kw["kind"] = t_events.EventKind(e.kind.value)
    return t_events.ElasticEvent(**kw)


def to_port_case(case):
    """The reference's fuzz case in the port's types, field by field."""
    w = case.workload
    tw = AnalyticWorkload(
        **{**fields_of(w), "cfg": ModelConfig(**fields_of(w.cfg)),
           "hw": t_cost.HardwareSpec(**fields_of(w.hw))})
    s = case.scenario
    return Scenario(s.name, tuple(to_port_event(e) for e in s.events),
                    s.horizon, s.description), tw


def port_policy(name, hw):
    return {"elaswave": lambda: t_pol.ElasWavePolicy(hw=hw),
            "torchft": t_pol.TorchFTPolicy,
            "oobleck": lambda: t_pol.OobleckPolicy(hw=hw)}[name]()


def without_wall(result) -> dict:
    d = dataclasses.asdict(result)
    for s in d["steps"]:
        assert s.pop("decide_wall_seconds") >= 0.0
    return norm(d)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_analytic_fuzz_traces_match_reference(policy):
    """About 40 seeds x 3 policies: the port's ``ScenarioResult`` equals the
    reference's but for the wall clocks, and the port's analytic checkers
    (dataflow consistency, MTTR/throughput with the legacy-communicator
    oracle) pass on every trace."""
    n_events = 0
    for seed in SEEDS:
        case = make_analytic_case(seed)
        want = j_runner.AnalyticScenarioRunner(
            case.scenario, case.workload,
            make_policy(policy, hw=case.workload.hw)).run()
        scn, w = to_port_case(case)
        assert w.describe() == case.workload.describe()
        assert scn.describe() == case.scenario.describe()
        got = AnalyticScenarioRunner(
            scn, w, port_policy(policy, w.hw),
            checkers=default_analytic_checkers()).run()
        assert without_wall(got) == without_wall(want), (policy, seed)
        assert got.to_json().count("\n") == want.to_json().count("\n")
        n_events += len(case.scenario.events)
    assert n_events > len(SEEDS)


def test_legacy_comm_factory_matches_reference():
    """The runner with the dict/set oracle as its communicator gives the
    reference's result with the same oracle."""
    for seed in range(0, 40, 4):
        case = make_analytic_case(seed)
        want = j_runner.AnalyticScenarioRunner(
            case.scenario, case.workload,
            make_policy("elaswave", hw=case.workload.hw),
            comm_factory=j_legacy.LegacyDynamicCommunicator).run()
        scn, w = to_port_case(case)
        got = AnalyticScenarioRunner(
            scn, w, port_policy("elaswave", w.hw),
            comm_factory=t_legacy.LegacyDynamicCommunicator,
            checkers=default_analytic_checkers()).run()
        assert without_wall(got) == without_wall(want), seed


def _seeded_views(seed):
    """A reference and a port view over the same fuzz workload, with seeded
    dead, slow and clocked ranks (every stage keeps a survivor in half)."""
    case = make_analytic_case(seed)
    _, w = to_port_case(case)
    rng = np.random.default_rng(seed)
    dp, pp = w.dp, w.pp
    alive = rng.random((dp, pp)) > 0.25
    if seed % 2:
        alive[0] = True
    slow = np.where(rng.random((dp, pp)) > 0.7,
                    np.round(1.0 + rng.random((dp, pp)), 2), 1.0)
    freq = np.round(1.0 + 0.15 * rng.random((dp, pp)), 3)
    jseg, tseg = case.workload.build_seg(), w.build_seg()
    jv = case.workload.build_view(jseg, alive=alive.copy(), slow=slow.copy())
    tv = w.build_view(tseg, alive=alive.copy(), slow=slow.copy())
    jv.freq[:], tv.freq[:] = freq, freq
    return case.workload, w, jseg, tseg, jv, tv


@pytest.mark.parametrize("name", ["elaswave", "elaswave-nodvfs-v2",
                                  "recycle", "torchft", "oobleck"])
def test_policy_decide_on_seeded_views(name):
    for seed in range(24):
        jw, tw, jseg, tseg, jv, tv = _seeded_views(seed)
        if name == "recycle":
            jp, tp = j_pol.ReCyclePolicy(), t_pol.ReCyclePolicy()
        elif name == "elaswave-nodvfs-v2":
            jp = j_pol.ElasWavePolicy(hw=jw.hw, use_dvfs=False, pipeline_v=2)
            tp = t_pol.ElasWavePolicy(hw=tw.hw, use_dvfs=False, pipeline_v=2)
        else:
            jp, tp = make_policy(name, hw=jw.hw), port_policy(name, tw.hw)
        a, b = jp.decide(jseg, jv), tp.decide(tseg, tv)
        assert norm(a) == norm(b), (name, seed)
        # the views are read, never written
        assert norm(jv.alive) == norm(tv.alive)


def test_oobleck_templates_cached_by_config_identity():
    """Templates are keyed by ``id(seg.cfg)``: a fresh policy a run stays
    necessary, as in the reference."""
    _, w, _, seg, _, view = _seeded_views(1)
    pol = t_pol.OobleckPolicy(hw=w.hw)
    pol.decide(seg, view)
    n = len(pol._templates)
    assert n >= 1 and all(k[0] == id(seg.cfg) for k in pol._templates)
    pol.decide(seg, view)
    assert len(pol._templates) == n
    pol.decide(w.build_seg(), view)
    assert len(pol._templates) == n        # same cfg object, same keys
    w2 = dataclasses.replace(w, cfg=dataclasses.replace(w.cfg))
    pol.decide(w2.build_seg(), view)
    assert len(pol._templates) == 2 * n
    assert t_pol.ClusterView is t_cv.ClusterView
    assert t_pol.GroupDelta is t_cv.GroupDelta
    assert t_pol.FailureDomainMap is t_cv.FailureDomainMap


# --------------------------------------------------------------------------
# the legacy communicator and the control-plane helpers
# --------------------------------------------------------------------------
LAYOUTS = [(2, 2, 1), (4, 2, 1), (2, 4, 2), (3, 3, 1)]
POLICIES = ("edit", "partial_rebuild", "full_rebuild")


def _trace(dp, pp, tp, seed, steps=4):
    rng = random.Random(seed)
    n = dp * pp * tp
    out = []
    for _ in range(steps):
        rem = tuple(sorted(rng.sample(range(n), rng.randint(1, max(1, n // 4)))))
        adds = tuple((f"dp_stage{(r // tp) % pp}_tp{r % tp}", r)
                     for r in rem[:rng.randint(0, len(rem))])
        out.append((rem, adds, rng.choice(POLICIES)))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_legacy_communicator_matches_reference_and_vectorized(layout):
    dp, pp, tp = layout
    groups = t_comm.build_hybrid_groups(dp, pp, tp)
    for seed in range(6):
        ja = j_legacy.LegacyDynamicCommunicator(groups)
        ta = t_legacy.LegacyDynamicCommunicator(groups)
        tv = t_comm.DynamicCommunicator(groups)
        for rem, adds, policy in _trace(dp, pp, tp, seed):
            assert ja.affected_groups(rem) == ta.affected_groups(rem) \
                == tv.affected_groups(rem)
            jd = j_cv.GroupDelta(remove=rem, add=adds)
            td = t_cv.GroupDelta(remove=rem, add=adds)
            for pol in POLICIES:
                assert norm(ja.price(jd, pol)) == norm(ta.price(td, pol)) \
                    == norm(tv.price(td, pol))
            assert norm(ja.apply(jd, policy)) == norm(ta.apply(td, policy)) \
                == norm(tv.apply(td, policy))
            assert ja.groups == ta.groups == tv.groups
            assert ja.links == ta.links == tv.links
            assert ja.all_ranks() == ta.all_ranks() == tv.all_ranks()
        assert norm(ja.history) == norm(ta.history)
        c = ta.clone()
        assert c.groups == ta.groups and c.links == ta.links
        with pytest.raises(ValueError):
            ta.apply(td, "bogus")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_communicator_clone_and_deprecated_shims(layout):
    dp, pp, tp = layout
    groups = t_comm.build_hybrid_groups(dp, pp, tp)
    ja, ta = j_comm.DynamicCommunicator(groups), t_comm.DynamicCommunicator(groups)
    for seed in range(4):
        (rem, adds, _), *_ = _trace(dp, pp, tp, seed, steps=1)
        jc, tc = ja.clone(), ta.clone()
        assert jc.groups == tc.groups and jc.links == tc.links
        assert tc.history == [] and tc.links == ta.links
        for shim in ("edit", "partial_rebuild"):
            jcc, tcc = jc.clone(), tc.clone()
            with pytest.warns(DeprecationWarning, match=shim):
                b = getattr(tcc, shim)(remove=rem, add=adds)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                a = getattr(jcc, shim)(remove=rem, add=adds)
            assert norm(a) == norm(b)
            assert jcc.groups == tcc.groups and jcc.links == tcc.links
        new = {k: [r for r in v if r not in rem] for k, v in groups.items()}
        with pytest.warns(DeprecationWarning, match="full_rebuild"):
            b = tc.full_rebuild(new)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            a = jc.full_rebuild(new)
        assert norm(a) == norm(b) and norm(jc.history) == norm(tc.history)
        assert jc.links == tc.links
        # the clone is independent of its source
        assert ta.groups == groups


def _seg_pair(seed):
    case = make_analytic_case(seed)
    _, w = to_port_case(case)
    return case.workload, w, case.workload.build_seg(), w.build_seg()


@pytest.mark.parametrize("seed", range(0, 40, 5))
def test_cost_model_vec_queries(seed):
    jw, tw, ja, ta = _seg_pair(seed)
    L = tw.cfg.num_layers
    rng = np.random.default_rng(seed)
    a = rng.integers(0, L, size=7)
    b = np.minimum(L - 1, a + rng.integers(0, L, size=7))
    mbs = rng.integers(1, 5, size=7)
    infl = rng.integers(1, 4, size=7)
    dpw = rng.integers(0, 4, size=7)
    freq = np.round(1.0 + 0.2 * rng.random(7), 3)
    nb = rng.integers(0, 3, size=7)
    assert norm(ja.seg_fwd_flops_vec(a, b, mbs)) == \
        norm(ta.seg_fwd_flops_vec(a, b, mbs))
    assert norm(ja.seg_mem_vec(a, b, mbs, infl, dpw)) == \
        norm(ta.seg_mem_vec(a, b, mbs, infl, dpw))
    for hw in (None, tw.hw):
        assert norm(j_cost.mini_step_time_vec(
            ja, a, b, mbs, freq, neighbor_ranks=nb,
            hw=None if hw is None else jw.hw)) == \
            norm(t_cost.mini_step_time_vec(ta, a, b, mbs, freq,
                                           neighbor_ranks=nb, hw=hw))
    # the vector queries agree with the scalar ones where the reference
    # says they do (flops exactly)
    assert list(ta.seg_fwd_flops_vec(a, b, mbs)) == \
        [ta.seg_fwd_flops(int(x), int(y), int(m)) for x, y, m in zip(a, b, mbs)]


@pytest.mark.parametrize("seed", range(12))
def test_pipeline_interleaved_and_dp_pp(seed):
    rng = np.random.default_rng(seed)
    P, M, dp = int(rng.integers(1, 5)), int(rng.integers(1, 7)), \
        int(rng.integers(1, 4))
    f = np.round(rng.random((dp, P)) + 0.1, 4)
    b = np.round(2 * f + rng.random((dp, P)), 4)
    p2p = float(rng.choice([0.0, 0.01]))
    for v in (1, 2, 3):
        st_j = [j_pipe.StageTiming(float(f[0, p]), float(b[0, p]), M)
                for p in range(P)]
        st_t = [t_pipe.StageTiming(float(f[0, p]), float(b[0, p]), M)
                for p in range(P)]
        assert norm(j_pipe.simulate_interleaved_1f1b(st_j, v, p2p)) == \
            norm(t_pipe.simulate_interleaved_1f1b(st_t, v, p2p))
    extra = {(int(rng.integers(0, dp)), int(rng.integers(0, P))):
             int(rng.integers(1, 4)) for _ in range(2)}
    fl, bl = f.tolist(), b.tolist()
    assert norm(j_pipe.simulate_dp_pp(fl, bl, M, p2p, extra)) == \
        norm(t_pipe.simulate_dp_pp(fl, bl, M, p2p, extra))


@pytest.mark.parametrize("seed", range(0, 40, 3))
def test_plan_graph_mem_check_and_plan_dataflow_view(seed):
    jw, tw, jseg, tseg, jv, tv = _seeded_views(seed)
    assert norm(j_graph.plan_graph(jseg, jv)) == norm(t_graph.plan_graph(tseg, tv))
    assert norm(j_graph.plan_graph(jseg, jv, hw=jw.hw)) == \
        norm(t_graph.plan_graph(tseg, tv, hw=tw.hw))
    L, P = tw.cfg.num_layers, tw.pp
    for cap in (tw.hw.hbm_bytes, 1.0):
        def mk(seg):
            return (lambda p, a, b: seg.seg_fwd_flops(a, b, 1) * (1 + p),
                    lambda p, a, b: seg.seg_mem(a, b, 1, 1))
        assert j_graph.mem_check_fails(L, P, *mk(jseg), [cap] * P) == \
            t_graph.mem_check_fails(L, P, *mk(tseg), [cap] * P)
    if int(tv.stage_width().min()) >= 1:
        assert norm(j_df.plan_dataflow_view(jv)) == \
            norm(t_df.plan_dataflow_view(tv))
    assert norm(j_df.plan_dataflow_view(jv, new_dp=1)) == \
        norm(t_df.plan_dataflow_view(tv, new_dp=1))


def test_agent_clear_slow():
    a = j_agent.Agent(4, stage_of={r: r % 2 for r in range(4)})
    b = t_agent.Agent(4, stage_of={r: r % 2 for r in range(4)})
    for ag, mod in ((a, j_agent), (b, t_agent)):
        for step in range(6):
            ag.observe([mod.Probe(step, r, heartbeat=True,
                                  step_seconds=3.0 if r == 1 else 1.0)
                        for r in range(4)])
    assert a.reported_slow == b.reported_slow == {1}
    a.clear_slow(1)
    b.clear_slow(1)
    b.clear_slow(3)                     # not reported: a no-op
    assert a.reported_slow == b.reported_slow == set()
