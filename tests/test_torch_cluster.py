"""The port's VirtualCluster train step on the CPU against the JAX package's,
from the reference's exact initial weights.

The reference runs with its Pallas kernels (interpret mode) and with its
plain jnp path; structure (stage entries, sizes, dp_ranks, shard sizes) must
match exactly, losses and master/mu/nu within the bounds of the reference's
``core.invariants.KernelConsistencyChecker``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core.cluster import VirtualCluster as JCluster  # noqa: E402
from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro.models.registry import tiny_config as j_tiny  # noqa: E402
from repro_torch.core.cluster import VirtualCluster  # noqa: E402
from repro_torch.models.registry import tiny_config  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: E402,F401

KW = dict(global_batch=8, num_micro=2, seq_len=16)
STEPS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("layout", ["interleaved", "contiguous"])
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_train_step_twin_vs_reference(family, layout, use_pallas):
    ref = JCluster(j_tiny(family), 2, 2, zero_layout=layout,
                   use_pallas=use_pallas, **KW)
    cl = VirtualCluster(tiny_config(family), 2, 2, zero_layout=layout,
                        device="cpu", init_params=(
                            _np(ref.stem), _np(ref.layer_params),
                            _np(ref.head)), **KW)
    for st, js in zip(cl.stages, ref.stages):
        assert st.entries == js.entries and st.sizes == js.sizes
        assert st.dp_ranks == js.dp_ranks
        np.testing.assert_array_equal(st.table.shard_sizes,
                                      js.table.shard_sizes)
        for c in ("master", "mu", "nu"):
            np.testing.assert_array_equal(st.flat[c].numpy(), js.flat[c])
    assert cl.layer_assignment == ref.layer_assignment
    for step in range(STEPS):
        a, b = cl.train_step(), ref.train_step()
        assert abs(a - b) <= KCC.LOSS_ATOL + KCC.LOSS_RTOL * abs(b), (step, a, b)
        atol = KCC.PARAM_ATOL0 + 2.0 * ref.adam.lr * ref.opt_step
        for st, js in zip(cl.stages, ref.stages):
            for c in ("master", "mu", "nu"):
                np.testing.assert_allclose(st.full(c).numpy(), js.full(c),
                                           rtol=KCC.PARAM_RTOL, atol=atol)
    assert cl.opt_step == ref.opt_step == STEPS
    assert cl.per_rank_mbs == ref.per_rank_mbs
    assert cl.grad_weights == ref.grad_weights
    # params were written back from the masters (fp32 here: exactly)
    for st in cl.stages:
        full = st.full("master")
        for pos, e in enumerate(st.entries):
            s_, e_ = st.table.layer_interval(pos)
            tree = cl.stem if e == -1 else cl.head if e == -2 \
                else cl.layer_params[e]
            with torch.no_grad():
                vec = cl.flattener.flatten_entry(e, tree)
            assert torch.equal(vec, full[s_:e_])


def test_ring_snapshot_equals_device_shards_bitwise():
    cl = VirtualCluster(tiny_config("dense", num_layers=2), 2, 2,
                        device="cpu", **KW)
    cl.run(2)
    assert len(cl.snapshot_seconds) == 2
    for st, pool in zip(cl.stages, cl.snapshots):
        for c in ("master", "mu", "nu"):
            shards = st.table.split(st.flat[c].numpy())
            for i in range(pool.n):
                np.testing.assert_array_equal(pool.host[i][c],
                                              shards[pool.backup_rank(i)])


def test_unported_options_and_recovery_raise():
    """The seed path still raises; dropout trains (it no longer raises),
    in both rng modes; the control plane's ``hw`` / ``mem_cap`` are
    accepted and recovery runs (it no longer raises), returning the
    reference's record schema."""
    from repro.core.cluster import _recovery_record
    from repro_torch.core.cost_model import HardwareSpec
    cfg = tiny_config("dense", num_layers=2)
    with pytest.raises(NotImplementedError, match="fast_path"):
        VirtualCluster(cfg, 2, 2, fast_path=False, device="cpu", **KW)
    for mode in ("reshard", "naive"):
        drop = VirtualCluster(tiny_config("dense", num_layers=2,
                                          dropout_rate=0.1), 2, 2,
                              rng_mode=mode, device="cpu", **KW)
        losses = drop.run(2)
        assert len(losses) == 2 and all(np.isfinite(losses))
        np.testing.assert_array_equal(drop.base_key, [0, 0])
    hw = HardwareSpec(peak_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9)
    cl = VirtualCluster(cfg, 2, 2, device="cpu", hw=hw, mem_cap=40e9, **KW)
    assert cl.hw is hw and cl.engine.mem_cap == 40e9
    rec = cl.recover_fail_stop(0, 1)
    assert set(rec) == set(_recovery_record())
    assert cl.recoveries == [rec] and cl.stages[1].dp_ranks == [1]
    # the ssm family trains; its decode and prefill-with-state branches
    # wait for the serving slice
    from repro_torch.models.mamba import apply_mamba
    ssm = VirtualCluster(tiny_config("ssm", num_layers=2), 2, 2,
                         device="cpu", **KW)
    p = ssm.layer_params[0]["mamba"]
    state = {"ssm": None, "conv": None}
    for seq in (1, 8):              # single-token decode, prefill-with-state
        with pytest.raises(NotImplementedError, match="serving slice"):
            apply_mamba(p, ssm.cfg, torch.zeros(1, seq, ssm.cfg.d_model),
                        state=state)
