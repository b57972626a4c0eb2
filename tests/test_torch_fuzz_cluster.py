"""Drawn fuzz cases through the port's ``run_case`` on the CPU, against the
JAX package's cluster runner on its fast path.

Cluster seeds 4 (dense, dp 2, pp 1: a fail-slow, a fail-stop, a DVFS
setpoint) and 6 (dense, dp 3, pp 2, dropout 0.1: a fail-stop, then a
fail-slow x2), and kernel seed 6 (ssm, dp 2, pp 1, dropout 0.1: a
fail-stop of rank 0, then a fail-slow x1.5 of rank 1), each as both
packages draw it, run from the reference's initial weights with the
dataflow, RNG and MTTR checkers on both sides, torch on one thread.  The
planner's measured wall clock is pinned to 0 on both sides.

Held exactly: recovery records, and each step's ``step_time``,
``throughput``, ``dp_width`` and ``alive``.  Held within the loss bound of
the reference's ``KernelConsistencyChecker``: losses.
"""
import math

import pytest

pytest.importorskip("jax")

from _torch_fuzz_twin import loss_within, run_cluster_case  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: E402,F401

# (mode, seed): each step's DP width
CASES = {("cluster", 4): [2, 1, 1, 1], ("cluster", 6): [3, 2, 2],
         ("kernel", 6): [2, 1, 1]}


@pytest.mark.parametrize("mode,seed", list(CASES))
def test_fuzz_case_matches_reference(mode, seed):
    got, want, case = run_cluster_case(mode, seed)
    assert got.recoveries == want.recoveries
    assert len(got.recoveries) == len(case.scenario.events)
    assert got.mttr_total == want.mttr_total
    assert len(got.steps) == len(want.steps) == case.scenario.horizon
    for a, b in zip(got.steps, want.steps):
        for k in ("step", "step_time", "throughput", "dp_width", "alive"):
            assert a[k] == b[k], (mode, seed, a["step"], k)
        assert math.isfinite(a["loss"])
        assert loss_within(a["loss"], b["loss"]), (mode, seed, a, b)
    assert [s["dp_width"] for s in got.steps] == CASES[mode, seed]
    for k in ("n_recoveries", "mttr_total", "final_step_time"):
        assert got.summary[k] == want.summary[k]
