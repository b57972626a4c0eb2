"""The MLA family in the port's VirtualCluster on the CPU against the JAX
package's, from the reference's exact weights: deepseek-v3's smoke config
(MLA with a q_lora rank, one dense layer, then MoE).

Three train steps on dp=2, pp=2 (the MoE twins' grid of
tests/test_torch_moe_cluster.py, at the config's capacity factor 1.25, so
tokens drop), then the recovery sequence of tests/test_torch_recovery.py on
dp=4, pp=2 at capacity factor 16 (so that routing does not depend on which
samples share an item, as the reference tests MoE under recovery).  Held
exactly: stage structure, recovery records, live-remap plans, snapshot
integrity tiers and the communicator's ``OpStats``; held within the
reference's ``KernelConsistencyChecker`` bounds: losses and master/mu/nu
after every step.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import configs as JC  # noqa: E402
from repro.core.cluster import VirtualCluster as JCluster  # noqa: E402
from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.core.cluster import VirtualCluster  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402
from test_torch_recovery import (SEQUENCE, _norm, assert_state_close,  # noqa: E402
                                 run_twin, tiers)  # noqa: F401

ARCH = "deepseek_v3_671b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _twins(dp, pp, capacity_factor=None, **kw):
    cfg_j, cfg_t = JC.get_smoke_config(ARCH), C.get_smoke_config(ARCH)
    if capacity_factor is not None:
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=capacity_factor)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=capacity_factor)
    ref = JCluster(cfg_j, dp, pp, use_pallas=False, **kw)
    cl = VirtualCluster(cfg_t, dp, pp, device="cpu", init_params=(
        _np(ref.stem), _np(ref.layer_params), _np(ref.head)), **kw)
    return ref, cl


def test_train_steps_twin_vs_reference():
    ref, cl = _twins(2, 2, global_batch=8, num_micro=2, seq_len=16)
    for st, js in zip(cl.stages, ref.stages):
        assert st.entries == js.entries and st.sizes == js.sizes
        for c in ("master", "mu", "nu"):
            np.testing.assert_array_equal(st.flat[c].numpy(), js.flat[c])
    for step in range(3):
        a, b = cl.train_step(), ref.train_step()
        assert abs(a - b) <= KCC.LOSS_ATOL + KCC.LOSS_RTOL * abs(b), \
            (step, a, b)
        assert_state_close(ref, cl, f"step {step}")
    assert cl.layer_assignment == ref.layer_assignment


def test_recovery_sequence_twin_vs_reference(tiers):
    ref, cl = _twins(4, 2, capacity_factor=16.0, global_batch=16,
                     num_micro=2, seq_len=16)
    logs = run_twin(ref, cl, SEQUENCE)
    assert tiers["port"] == tiers["ref"]
    assert len(cl.recoveries) == 6
    assert len([e for e in logs["port"] if e[0] == "remap"]) == 5
    assert _norm(cl.comm.history) == _norm(ref.comm.history)
    assert len(cl.comm.history) > 0
