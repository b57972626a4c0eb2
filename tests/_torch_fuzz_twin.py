"""Shared by the port's fuzz twin tests: one drawn case through the JAX
package on its fast path and through the port on the CPU, from the
reference's initial weights, with the planner's measured wall clock pinned
to 0 on both sides (``RefWorkload`` and ``PortWorkload`` of
``tests/test_torch_scenario_cluster.py``).

Not a test module: nothing here is collected.
"""
import dataclasses

from repro.core import invariants as j_inv
from repro.core.invariants import KernelConsistencyChecker as JKCC
from repro.scenarios import fuzz as j_fuzz
from repro.scenarios import runner as j_runner

from repro_torch.core import invariants as t_inv
from repro_torch.core.invariants import KernelConsistencyChecker as KCC
from repro_torch.scenarios import fuzz

from test_torch_scenario_cluster import PortWorkload, RefWorkload

# the numeric checkers both sides run: dataflow, RNG and MTTR (invariant 1
# needs the seed-path twin on the CPU, which the port has not)
STACK = ("DataflowConsistencyChecker", "RngConsistencyChecker",
         "MttrBoundChecker")


def ref_checkers():
    return [getattr(j_inv, n)() for n in STACK]


def port_checkers():
    return [getattr(t_inv, n)() for n in STACK]


def twin_workloads(j_w, w):
    """The reference's drawn workload on its plain path and the port's on
    the CPU; the two must be the same draw."""
    j_kw = dataclasses.asdict(j_w)
    j_kw["use_pallas"] = False
    kw = dataclasses.asdict(w)
    assert kw.pop("device") is None
    assert {k: v for k, v in j_kw.items() if k != "use_pallas"} == kw
    RefWorkload.initial = []
    return RefWorkload(**j_kw), PortWorkload(**kw, device="cpu")


def port_from_ref(port_w):
    """Hands the reference's one recorded cluster's weights to the port."""
    (init,) = RefWorkload.initial
    PortWorkload.init_params = init
    return port_w


def loss_within(a: float, b: float) -> bool:
    assert KCC.LOSS_ATOL == JKCC.LOSS_ATOL and KCC.LOSS_RTOL == JKCC.LOSS_RTOL
    return KCC.loss_within(a, b)


def run_cluster_case(mode: str, seed: int):
    """Cluster or kernel ``mode`` case ``seed`` through both packages' runs:
    the reference's ``ClusterScenarioRunner`` and the port's ``run_case``.
    Returns (port result, reference result, port case)."""
    j_case = j_fuzz.make_case("pallas" if mode == "kernel" else mode, seed)
    case = fuzz.make_case(mode, seed)
    assert [e.describe() for e in case.scenario.events] == \
        [e.describe() for e in j_case.scenario.events]
    ref_w, port_w = twin_workloads(j_case.workload, case.workload)
    want = j_runner.ClusterScenarioRunner(j_case.scenario, ref_w,
                                          checkers=ref_checkers()).run()
    port_case = dataclasses.replace(case, workload=port_from_ref(port_w))
    got = fuzz.run_case(port_case, checkers=port_checkers())
    return got, want, case


def run_chaos(seed: int):
    """Chaos case ``seed`` through both packages' ``DetectionChaosRunner``.
    Returns (port cluster, reference cluster, port case)."""
    j_case = j_fuzz.make_chaos_case(seed)
    case = fuzz.make_chaos_case(seed)
    ref_w, port_w = twin_workloads(j_case.workload, case.workload)
    want = j_fuzz.run_chaos_case(dataclasses.replace(j_case, workload=ref_w),
                                 checkers=ref_checkers())
    got = fuzz.run_chaos_case(
        dataclasses.replace(case, workload=port_from_ref(port_w)),
        checkers=port_checkers())
    return got, want, case
