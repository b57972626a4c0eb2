"""Two named cluster scenarios through the port's ``ClusterScenarioRunner``
on the CPU, against the JAX package's runner on its fast path.

``concurrent_burst`` (two ranks of different stages fail in one step) and
``shrink_regrow`` (a scale-in, then the same worker rejoins) run as their
library workloads (dense, 8 layers, dp 4, pp 2, dropout 0.1) on both
packages from the reference's initial weights.  The reference runs plain
jnp with no checkers; the port runs with its dataflow, RNG and MTTR
checkers attached.  The planner's measured wall clock is pinned to 0 on
both sides, so that the recovery records can be held exactly.

Held exactly: recovery records, and each step's ``step_time``,
``throughput``, ``dp_width`` and ``alive``.  Held within the loss bound of
the reference's ``KernelConsistencyChecker``: losses.

The reference's clusters of one workload share their jitted per-item
gradient functions (``_scan_grad_cache``, keyed by batch size and item
count; ``_loss_fn`` reads only ``cfg`` and ``use_pallas``, equal across
them), so that the second scenario does not compile them again.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro.scenarios import get_scenario as j_get  # noqa: E402
from repro.scenarios import runner as j_runner  # noqa: E402
from repro.scenarios import spec as j_spec  # noqa: E402

from repro_torch.core.invariants import (  # noqa: E402
    DataflowConsistencyChecker, MttrBoundChecker, RngConsistencyChecker)
from repro_torch.scenarios import (ClusterScenarioRunner,  # noqa: E402
                                   ClusterWorkload, get_scenario)
from _torch_threads import torch_one_thread  # noqa: E402,F401


def _pin_planner_clock(cl):
    plan = cl.engine.plan
    cl.engine.plan = lambda *a, **k: dataclasses.replace(plan(*a, **k),
                                                         plan_seconds=0.0)
    return cl


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class RefWorkload(j_spec.ClusterWorkload):
    """The reference's workload, recording each cluster's initial weights;
    its clusters share their jitted gradient functions."""
    initial = []
    grad_fns = {}

    def make_cluster(self, **kw):
        cl = _pin_planner_clock(super().make_cluster(**kw))
        self.initial.append((_np(cl.stem), _np(cl.layer_params),
                             _np(cl.head)))
        key = (repr(cl.cfg), cl.use_pallas)
        cl._scan_grad_cache = self.grad_fns.setdefault(key,
                                                       cl._scan_grad_cache)
        return cl


class PortWorkload(ClusterWorkload):
    """The port's workload on the CPU, from given initial weights."""
    init_params = None

    def make_cluster(self, **kw):
        kw.setdefault("init_params", self.init_params)
        return _pin_planner_clock(super().make_cluster(**kw))


@pytest.mark.parametrize("name", ["concurrent_burst", "shrink_regrow"])
def test_library_scenario_matches_reference(name):
    j_scn, j_w = j_get(name)
    scn, w = get_scenario(name)
    assert scn.describe() == j_scn.describe()
    ref_w = RefWorkload(**dataclasses.asdict(j_w))
    RefWorkload.initial = []
    want = j_runner.ClusterScenarioRunner(j_scn, ref_w).run()
    (init,) = RefWorkload.initial
    kw = dataclasses.asdict(w)
    assert kw.pop("device") is None
    port_w = PortWorkload(**kw, device="cpu")
    PortWorkload.init_params = init
    got = ClusterScenarioRunner(
        scn, port_w, checkers=[DataflowConsistencyChecker(),
                               RngConsistencyChecker(),
                               MttrBoundChecker()]).run()

    assert got.recoveries == want.recoveries
    assert got.recoveries and got.mttr_total == want.mttr_total
    assert len(got.steps) == len(want.steps) == scn.horizon
    for a, b in zip(got.steps, want.steps):
        for k in ("step", "step_time", "throughput", "dp_width", "alive"):
            assert a[k] == b[k], (name, a["step"], k)
        assert abs(a["loss"] - b["loss"]) <= \
            KCC.LOSS_ATOL + KCC.LOSS_RTOL * abs(b["loss"]), (name, a, b)
    widths = [s["dp_width"] for s in got.steps]
    assert min(widths) == w.dp - 1
    assert (widths[-1] == w.dp) == (name == "shrink_regrow")
    assert set(got.summary) == set(want.summary)
    for k in ("n_recoveries", "mttr_total", "final_step_time"):
        assert got.summary[k] == want.summary[k]

