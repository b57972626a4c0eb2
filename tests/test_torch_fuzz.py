"""The port's trace fuzzer (``repro_torch.scenarios.fuzz``) against the JAX
package's (``repro.scenarios.fuzz``), control plane only, exact.

For seeds 0-99 of every mode, the port draws the reference's case: the
same workload fields (less ``device`` / ``use_pallas``), the same events
and horizon, and for chaos cases the same class and ground-truth actions;
the port's kernel mode is the reference's Pallas mode.  ``trace_is_legal``
agrees with the reference on every drawn trace, on every one-event
deletion of them and on the reference's legality cases.  Analytic cases
run through both packages' ``run_case`` under every policy with equal
results but for the measured wall clocks.  The shrinker, given the same
failing predicate, returns the same minimal trace.  The detector-only
chaos sweep passes 150 seeds, and the soak script's analytic sweep exits
0 with the reference's failure-record keys.  On a CPU cluster workload
``run_case`` with its default checkers raises ``NotImplementedError``
(invariant 1's seed-path twin) and never passes in silence.
"""
import dataclasses
import importlib.util
import itertools
from pathlib import Path

import pytest

pytest.importorskip("jax")

from repro.core.events import (ElasticEvent as JEvent,  # noqa: E402
                               EventKind as JKind)
from repro.scenarios import fuzz as j_fuzz  # noqa: E402
from repro.scenarios import spec as j_spec  # noqa: E402

from repro_torch.core.events import ElasticEvent, EventKind  # noqa: E402
from repro_torch.core.invariants import (  # noqa: E402
    DataflowConsistencyChecker, InvariantChecker, InvariantViolation)
from repro_torch.scenarios import (CHAOS_CLASSES, POLICY_NAMES,  # noqa: E402
                                   ClusterWorkload, FuzzCase, Scenario,
                                   fuzz, make_analytic_case, make_case,
                                   make_chaos_case, run_case,
                                   run_detector_chaos, shrink_case,
                                   trace_is_legal)
from test_torch_policies import norm, without_wall  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEEDS = range(100)
REF_MODE = {"analytic": "analytic", "cluster": "cluster", "kernel": "pallas",
            "chaos": "chaos"}


def _events(case):
    return [e.describe() for e in case.scenario.events]


def _workload_fields(w) -> dict:
    d = dataclasses.asdict(w)
    d.pop("use_pallas", None)
    d.pop("device", None)
    return norm(d)


def _to_ref_events(events):
    return [JEvent(**{**{f.name: getattr(e, f.name)
                         for f in dataclasses.fields(e)},
                      "kind": JKind(e.kind.value)}) for e in events]


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(REF_MODE))
def test_cases_are_the_reference_s(mode):
    for seed in SEEDS:
        got, want = make_case(mode, seed), j_fuzz.make_case(REF_MODE[mode],
                                                            seed)
        assert got.mode == mode and got.seed == seed
        assert _events(got) == _events(want), (mode, seed)
        assert got.scenario.horizon == want.scenario.horizon
        assert _workload_fields(got.workload) == \
            _workload_fields(want.workload), (mode, seed)
        if mode == "analytic":
            assert got.workload.describe() == want.workload.describe()
        else:
            assert got.workload.device is None     # the card
        if mode == "chaos":
            assert got.chaos_class == want.chaos_class
            assert norm(got.actions) == norm(want.actions)
        assert got.repro() == want.repro().replace(
            "benchmarks.fuzz_soak", "benchmarks.torch_fuzz_soak").replace(
            "--mode pallas", "--mode kernel")


def test_sample_draws():
    """The cases the card's smoke and the CPU twins run."""
    k0, k6, k7 = (fuzz.make_kernel_case(s) for s in (0, 6, 7))
    assert (k0.workload.family, k0.workload.dp, k0.workload.pp) == \
        ("dense", 3, 2)
    assert _events(k0) == ["fail_stop@1 ranks=[1, 3]"]
    assert (k6.workload.family, k6.workload.dp, k6.workload.pp,
            k6.workload.dropout_rate) == ("ssm", 2, 1, 0.1)
    assert _events(k6) == ["fail_stop@1 ranks=[0]",
                           "fail_slow@2 ranks=[1] x1.5"]
    assert k7.workload.family == "ssm"
    assert [e.kind for e in k7.scenario.events] == [EventKind.SCALE_IN,
                                                    EventKind.SCALE_OUT]
    c6 = fuzz.make_cluster_case(6)
    assert (c6.workload.dp, c6.workload.pp) == (3, 2)
    assert [e.kind for e in c6.scenario.events] == [EventKind.FAIL_STOP,
                                                    EventKind.FAIL_SLOW]
    assert c6.scenario.events[1].slow_factor == 2.0
    assert [make_chaos_case(s).chaos_class for s in (0, 1, 3)] == \
        ["corrupt", "mixed", "flap_only"]
    c1 = make_chaos_case(1)
    assert c1.workload.pp == make_chaos_case(3).workload.pp == 2
    assert [a.kind for a in c1.actions][:2] == ["kill", "notice"]
    assert {a.kind for a in c1.actions[2:]} == {"mem"}


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown fuzz mode"):
        make_case("pallas", 0)


def test_chaos_classes_and_repro_lines_covered():
    seen = set()
    for seed in range(40):
        c = make_chaos_case(seed)
        assert c.chaos_class in CHAOS_CLASSES
        assert f"--mode chaos --seed {seed}" in c.repro()
        if c.chaos_class == "flap_only":
            assert c.actions == ()
        seen.add(c.chaos_class)
    assert seen == set(CHAOS_CLASSES)


def test_cluster_traces_never_inject_migrate_and_respect_budget():
    for seed in range(60):
        for c in (fuzz.make_cluster_case(seed), fuzz.make_kernel_case(seed)):
            assert all(e.kind != EventKind.MIGRATE for e in c.scenario.events)
            assert len(c.scenario.events) <= 4


# ---------------------------------------------------------------------------
# legality
# ---------------------------------------------------------------------------
def test_trace_is_legal_agrees_on_drawn_traces_and_deletions():
    n_illegal = 0
    for mode, seed in itertools.product(("analytic", "cluster", "kernel"),
                                        SEEDS):
        case = make_case(mode, seed)
        w = case.workload
        evs = list(case.scenario.events)
        assert trace_is_legal(evs, w.dp, w.pp), (mode, seed)
        for i in range(len(evs)):
            cand = evs[:i] + evs[i + 1:]
            got = trace_is_legal(cand, w.dp, w.pp)
            assert got == j_fuzz.trace_is_legal(_to_ref_events(cand), w.dp,
                                                w.pp), (mode, seed, i)
            n_illegal += not got
    assert n_illegal > 0


def _legality_cases(E, K):
    """The reference's ``TestEventLegality`` traces: (events, dp, pp)."""
    return [
        ([E(K.FAIL_STOP, 0, (0, 2)), E(K.FAIL_STOP, 1, (4,))], 3, 2),
        ([E(K.FAIL_STOP, 0, (0, 2))], 3, 2),
        ([E(K.FAIL_STOP, 0, (99,))], 2, 2),
        ([E(K.FAIL_STOP, 0, (1, 1))], 2, 2),
        ([E(K.SCALE_OUT, 0, (2,))], 2, 2),
        ([E(K.FAIL_STOP, 0, (1,)), E(K.SCALE_IN, 1, (1,))], 2, 2),
        ([E(K.FAIL_STOP, -1, (1,))], 2, 2),
        ([E(K.FAIL_STOP, 0, (-3,))], 2, 2),
        ([E(K.SCALE_IN, 2, (1,)), E(K.SCALE_OUT, 1, (1,))], 2, 2),
        ([E(K.SCALE_IN, 1, (1,)), E(K.SCALE_OUT, 2, (1,))], 2, 2),
        ([E(K.FAIL_SLOW, 0, (0,), slow_factor=1.5),
          E(K.FAIL_SLOW, 1, (0,), slow_factor=2.0)], 2, 2),
    ]


def test_trace_is_legal_agrees_on_the_reference_s_legality_cases():
    got = [trace_is_legal(e, dp, pp)
           for e, dp, pp in _legality_cases(ElasticEvent, EventKind)]
    want = [j_fuzz.trace_is_legal(e, dp, pp)
            for e, dp, pp in _legality_cases(JEvent, JKind)]
    assert got == want
    assert got == [False, True, False, False, False, False, False, False,
                   False, True, True]


# ---------------------------------------------------------------------------
# analytic runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_analytic_run_case_matches_reference(policy):
    for seed in range(40):
        got = run_case(make_analytic_case(seed), policy=policy)
        want = j_fuzz.run_case(j_fuzz.make_analytic_case(seed),
                               policy=policy)
        assert without_wall(got) == without_wall(want), (policy, seed)


class _BatchMutator(InvariantChecker):
    """Silently shrinks the global batch after the first event (§4.1)."""
    name = "batch-mutator"

    def after_analytic_event(self, step, event, view, comm, extra):
        view.global_batch -= 1


def test_violation_carries_the_seed_and_the_repro_line():
    case = next(c for c in map(make_analytic_case, range(60))
                if any(e.is_shrink for e in c.scenario.events))
    with pytest.raises(InvariantViolation, match="dataflow-consistency") as ei:
        run_case(case, policy="elaswave",
                 checkers=[_BatchMutator(), DataflowConsistencyChecker()])
    msg = str(ei.value)
    assert f"fuzz seed {case.seed} (analytic)" in msg
    assert (f"python -m benchmarks.torch_fuzz_soak --mode analytic "
            f"--seed {case.seed} --policy elaswave") in msg


# ---------------------------------------------------------------------------
# the shrinker
# ---------------------------------------------------------------------------
def _shrink_both(case, fails):
    """``shrink_case`` of both packages on the same case and predicate."""
    j_case = j_fuzz.FuzzCase(
        case.seed, case.mode,
        j_spec.Scenario(case.scenario.name,
                        tuple(_to_ref_events(case.scenario.events)),
                        case.scenario.horizon),
        j_spec.ClusterWorkload(**{
            k: v for k, v in dataclasses.asdict(case.workload).items()
            if k != "device"}))
    return (_events(shrink_case(case, fails)),
            _events(j_fuzz.shrink_case(j_case, fails)))


def test_shrinker_matches_reference_on_drawn_traces():
    """Predicate: the trace still kills some rank of stage 0, or straggles
    at x >= 2 (a crash counts as failing on both sides)."""
    def fails(c):
        evs = c.scenario.events
        if any(e.is_shrink and any(r % c.workload.pp == 0 for r in e.ranks)
               for e in evs):
            return True
        return any(e.kind.value == "fail_slow" and e.slow_factor >= 2
                   for e in evs)

    shrunk = 0
    for seed in range(40):
        case = fuzz.make_cluster_case(seed)
        if not fails(case):
            continue
        got, want = _shrink_both(case, fails)
        assert got == want, seed
        assert len(got) <= len(case.scenario.events)
        shrunk += len(got) < len(case.scenario.events)
    assert shrunk > 0


def test_shrinker_minimizes_to_single_event():
    wl = ClusterWorkload(dp=3, pp=1, global_batch=6, num_micro=1, seq_len=8,
                         num_layers=2)
    events = (
        ElasticEvent(EventKind.FAIL_STOP, 0, (1,)),
        ElasticEvent(EventKind.DVFS_SET, 1, (0,), freq=1.1),
        ElasticEvent(EventKind.FAIL_SLOW, 2, (0,), slow_factor=3.0),
        ElasticEvent(EventKind.SCALE_OUT, 3, (1,)),
        ElasticEvent(EventKind.FAIL_SLOW, 4, (2,), slow_factor=1.5),
    )
    case = FuzzCase(0, "cluster", Scenario("shrink-me", events, 6), wl)

    def fails(c):
        return any(e.kind.value == "fail_slow" and e.slow_factor >= 2
                   for e in c.scenario.events)

    got, want = _shrink_both(case, fails)
    assert got == want == ["fail_slow@2 ranks=[0] x3"]


def test_shrinker_never_emits_illegal_traces():
    wl = ClusterWorkload(dp=2, pp=1, global_batch=4, num_micro=1, seq_len=8,
                         num_layers=2)
    events = (
        ElasticEvent(EventKind.SCALE_IN, 0, (1,)),
        ElasticEvent(EventKind.SCALE_OUT, 1, (1,)),
        ElasticEvent(EventKind.FAIL_SLOW, 2, (0,), slow_factor=2.0),
    )
    case = FuzzCase(0, "cluster", Scenario("dep", events, 4), wl)
    seen = []

    def fails(c):
        assert trace_is_legal(c.scenario.events, wl.dp, wl.pp)
        seen.append(tuple(_events(c)))
        return any(e.kind.value == "fail_slow" for e in c.scenario.events)

    small = shrink_case(case, fails)
    assert _events(small) == ["fail_slow@2 ranks=[0] x2"]
    assert seen


# ---------------------------------------------------------------------------
# detection chaos without a cluster
# ---------------------------------------------------------------------------
def test_detector_chaos_150_seeds():
    for seed in range(150):
        run_detector_chaos(seed)


def test_chaos_checkers_drop_only_invariant_1_in_the_corrupt_class():
    names = {}
    for seed in (0, 1, 3):
        case = make_chaos_case(seed)
        names[case.chaos_class] = [c.name
                                   for c in fuzz.default_chaos_checkers(case)]
        cpu = dataclasses.replace(case, workload=dataclasses.replace(
            case.workload, device="cpu"))
        cpu_names = [c.name for c in fuzz.default_chaos_checkers(cpu)]
        assert cpu_names == [n.replace("kernel-", "parameter-")
                             for n in names[case.chaos_class]]
    rest = ["dataflow-consistency", "rng-consistency", "mttr-bound"]
    assert names["corrupt"] == rest
    assert names["mixed"] == names["flap_only"] == ["kernel-consistency",
                                                    *rest]


# ---------------------------------------------------------------------------
# no silent pass on the CPU
# ---------------------------------------------------------------------------
def test_cpu_cluster_case_with_default_checkers_raises():
    case = fuzz.make_cluster_case(6)
    cpu = dataclasses.replace(case, workload=dataclasses.replace(
        case.workload, device="cpu"))
    with pytest.raises(NotImplementedError, match="fast_path=False"):
        run_case(cpu)


# ---------------------------------------------------------------------------
# the soak script
# ---------------------------------------------------------------------------
def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_soak_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_soak_analytic_sweep_and_failure_record(tmp_path, capsys):
    soak, j_soak = _load("torch_fuzz_soak"), _load("fuzz_soak")
    assert soak.main(["--mode", "analytic", "--traces", "20",
                      "--out", str(tmp_path)]) == 0
    assert "fuzz soak: 60 runs, 0 failures" in capsys.readouterr().out
    assert not tmp_path.exists() or not any(tmp_path.iterdir())
    err = RuntimeError("boom")
    for mode, seed in (("analytic", 3), ("kernel", 6), ("chaos", 0)):
        got = soak._case_record(make_case(mode, seed), "elaswave", err)
        want = j_soak._case_record(j_fuzz.make_case(REF_MODE[mode], seed),
                                   "elaswave", err)
        assert list(got) == list(want), mode
        assert got["events"] == want["events"]
        assert got["repro"].startswith(
            "PYTHONPATH=src python -m benchmarks.torch_fuzz_soak")
