"""The port's train step and recovery at dropout 0.1 on the CPU against the
JAX package's fast path, from the reference's exact initial weights.

The masks are the reference's bit for bit (``test_torch_threefry.py``), so
the twins hold under the same bounds as the dropout-free twins
(``test_torch_cluster.py``, ``test_torch_recovery.py``): losses and
master/mu/nu within ``KernelConsistencyChecker``'s, records, plans,
tiers and layouts exactly.  Both ``rng_mode``s: ``"reshard"`` addresses
each sample's stream by its global id, ``"naive"`` by (rank, slot), so the
two draw different masks and neither may be confused with the other.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import cluster as j_cluster  # noqa: E402
from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.layers import RngCtx as JRngCtx  # noqa: E402
from repro_torch.core import cluster as t_cluster  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.threefry import key_from_seed  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.layers import RngCtx  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_recovery import SEQUENCE, run_twin, tiers  # noqa: E402,F401
from _torch_threads import torch_one_thread  # noqa: E402,F401

RATE = 0.1
KW = dict(global_batch=8, num_micro=2, seq_len=16)
STEPS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _twins(family, dp, pp, cfg_kw, rng_mode="reshard", **kw):
    ref = j_cluster.VirtualCluster(
        JR.tiny_config(family, dropout_rate=RATE, **cfg_kw), dp, pp,
        rng_mode=rng_mode, use_pallas=False, **kw)
    cl = t_cluster.VirtualCluster(
        R.tiny_config(family, dropout_rate=RATE, **cfg_kw), dp, pp,
        rng_mode=rng_mode, device="cpu",
        init_params=(_np(ref.stem), _np(ref.layer_params), _np(ref.head)),
        **kw)
    return ref, cl


def _assert_state_close(ref, cl):
    atol = KCC.PARAM_ATOL0 + 2.0 * ref.adam.lr * ref.opt_step
    for st, js in zip(cl.stages, ref.stages):
        for c in ("master", "mu", "nu"):
            np.testing.assert_allclose(st.full(c).numpy(), js.full(c),
                                       rtol=KCC.PARAM_RTOL, atol=atol)


@pytest.mark.parametrize("rng_mode", ["reshard", "naive"])
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_dropout_train_step_twin_vs_reference(family, rng_mode, monkeypatch):
    ref, cl = _twins(family, 2, 2, {}, rng_mode, **KW)
    calls = []
    dropout = ops.dropout

    def counted(x, key, sample_ids, rate):
        calls.append(tuple(sample_ids.tolist()))
        return dropout(x, key, sample_ids, rate)
    monkeypatch.setattr(ops, "dropout", counted)
    for step in range(STEPS):
        a, b = cl.train_step(), ref.train_step()
        assert abs(a - b) <= KCC.LOSS_ATOL + KCC.LOSS_RTOL * abs(b), \
            (step, a, b)
        _assert_state_close(ref, cl)
    # one dropout an op: attention and MLP a dense layer, the mixer an ssm
    # layer; 4 items a step
    ops_per_layer = 2 if family == "dense" else 1
    assert len(calls) == STEPS * 4 * cl.cfg.num_layers * ops_per_layer
    ids = set(calls)
    if rng_mode == "naive":        # (rank, slot) addressed: 2 ranks, 2 slots
        assert ids == {(0, 1), (100003, 100004)}
    else:                          # the global sample ids of each item
        assert len(ids) == STEPS * 4
        assert sorted(i for t in ids for i in t) == list(
            range(STEPS * KW["global_batch"]))


def test_rng_modes_draw_different_masks():
    """The same cluster at the two modes: the losses differ (other masks),
    and each equals the reference's at its mode (the test above)."""
    losses = {}
    for mode in ("reshard", "naive"):
        cl = t_cluster.VirtualCluster(
            R.tiny_config("dense", num_layers=2, dropout_rate=RATE), 2, 2,
            rng_mode=mode, device="cpu", **KW)
        losses[mode] = cl.run(2)
    assert losses["reshard"] != losses["naive"]


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_block_with_dropout_vs_reference(family):
    """One block forward and its input gradient at dropout 0.1 against the
    reference's ``apply_layer`` under its own RngCtx: the layer's fold and
    each op's fold agree, so the outputs agree to float32 rounding and the
    dropped elements are the same ones."""
    jcfg = JR.tiny_config(family, dropout_rate=RATE)
    cfg = R.tiny_config(family, dropout_rate=RATE)
    params = _np(JR.init_layer(jax.random.key(4), jcfg, 1))
    rs = np.random.default_rng(2)
    x = rs.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    sids = np.array([3, 77, 100003], np.int32)
    pos = np.broadcast_to(np.arange(16)[None], (3, 16)).copy()
    jkey = jax.random.fold_in(jax.random.key(0), np.uint32(5))

    def jf(x):
        ctx = JRngCtx(step_key=jkey, sample_ids=jnp.asarray(sids),
                      deterministic=False)
        return JR.apply_layer(params, jcfg, 1, x, jnp.asarray(pos), ctx)[0]
    y_ref = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    g_ref = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jf(x) ** 2)))(
        jnp.asarray(x)))

    _, (tp,), _ = params_from_numpy({}, [params], {}, "cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    ctx = RngCtx(step_key=np.asarray(jax.random.key_data(jkey)),
                 sample_ids=torch.from_numpy(sids), deterministic=False)
    y, _ = R.apply_layer(tp, cfg, 1, tx, torch.from_numpy(pos), ctx)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), g_ref, rtol=1e-4, atol=1e-4)
    # without dropout the block's output differs: the masks did act
    y0, _ = R.apply_layer(tp, cfg, 1, tx.detach(), torch.from_numpy(pos),
                          RngCtx(step_key=key_from_seed(0)))
    assert not torch.allclose(y0, y.detach(), rtol=1e-3, atol=1e-3)


def test_dropout_recovery_sequence_twin_vs_reference(tiers):  # noqa: F811
    """The recovery twins' sequence on the reference's elastic config at
    dropout 0.1 (8 layers, dp=4, pp=2, global batch 16): failed ranks'
    samples move to survivors and keep their streams.  One ZeRO layout:
    the masks do not depend on it, and ``test_torch_recovery.py`` runs
    the sequence under both."""
    ref, cl = _twins("dense", 4, 2, dict(num_layers=8), global_batch=16,
                     num_micro=2, seq_len=16)
    logs = run_twin(ref, cl, SEQUENCE)
    assert tiers["port"] == tiers["ref"]
    assert "rebuilt" in tiers["port"] and "rederived" in tiers["port"]
    assert len(cl.recoveries) == 6
    assert any(r["rng_moves"] > 0 for r in cl.recoveries)
    assert len([e for e in logs["port"] if e[0] == "remap"]) == 5
