"""The moe and hybrid families in the port's model and VirtualCluster on
the CPU against the JAX package's, from the reference's exact weights.

The per-layer model (attention and Mamba2 blocks with MoE MLPs): loss and
every parameter's gradient, in ``ravel_pytree`` order, within the dense
model twin's bounds (``FWD``/``GRAD`` of tests/test_torch_model.py: float32
sums in another order); the entry flattener bitwise, the float32 router
beside bf16 experts included.  The cluster: 3 train steps, stage structure
exactly equal, losses and master/mu/nu within the reference's
``KernelConsistencyChecker`` bounds, as tests/test_torch_cluster.py holds
the dense and ssm families.  The tiny moe config routes at the default
capacity factor 1.25, so tokens drop.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.core.cluster import VirtualCluster as JCluster  # noqa: E402
from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import RngCtx as JRngCtx  # noqa: E402
from repro_torch.core.cluster import VirtualCluster  # noqa: E402
from repro_torch.core.statespace import (EntryFlattener, flatten_leaves,  # noqa: E402
                                         tree_leaves)
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import RngCtx  # noqa: E402
from repro_torch.weights import params_from_numpy, params_from_stacked  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=2e-5)
KW = dict(global_batch=8, num_micro=2, seq_len=16)
STEPS = 3
FAMILIES = {"moe": ("moe", {}),
            "moe-row": ("moe", {"moe_row_dispatch": True}),
            "hybrid": ("hybrid", {})}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(name, **kw):
    family, over = FAMILIES[name]
    return JR.tiny_config(family, **over, **kw), \
        R.tiny_config(family, **over, **kw)


def _model(cfg_j):
    ks = jax.random.split(jax.random.key(3), cfg_j.num_layers + 2)
    stem = JR.init_stem(ks[0], cfg_j)
    layers = [JR.init_layer(ks[1 + i], cfg_j, i)
              for i in range(cfg_j.num_layers)]
    return stem, layers, JR.init_head(ks[-1], cfg_j)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_model_loss_and_grads_vs_reference(name):
    cfg_j, cfg_t = _cfgs(name)
    assert R.flat_layer_types(cfg_t) == [
        t for pat, rep in cfg_j.block_pattern() for t in list(pat) * rep]
    jp = _model(cfg_j)
    tp = params_from_numpy(*_np(jp), "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab_size, (2, 16)).astype(np.int32)

    def j_loss(stem, layers, head):
        x = JR.apply_stem(stem, cfg_j, jnp.asarray(toks))
        pos = jnp.broadcast_to(jnp.arange(16)[None], (2, 16))
        aux = 0.0
        for lid in range(cfg_j.num_layers):
            x, a = JR.apply_layer(layers[lid], cfg_j, lid, x, pos, JRngCtx())
            aux = aux + a
        logits = JR.apply_head(head, cfg_j, x)
        return JT.softmax_xent(logits[:, :-1], toks[:, 1:]) + aux

    jloss, jgrads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2)))(
        *jp)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    stem, layers, head = tp
    x = R.apply_stem(stem, cfg_t, torch.from_numpy(toks))
    pos = torch.arange(16)[None].expand(2, 16)
    aux = torch.zeros(())
    for lid in range(cfg_t.num_layers):
        x, a = R.apply_layer(layers[lid], cfg_t, lid, x, pos, RngCtx())
        aux = aux + a
    assert float(aux.detach()) > 0    # the MoE layers' load balancing
    loss = T.softmax_xent(R.apply_head(head, cfg_t, x)[:, :-1],
                          torch.from_numpy(toks[:, 1:])) + aux
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(flatten_leaves(grads).numpy(),
                               np.asarray(ravel_pytree(jgrads)[0]), **GRAD)


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_moe_entries_flatten_bitwise_in_bf16(family):
    """A bf16 MoE layer's leaves (``shared`` sorted between ``router`` and
    ``wg``, the router float32) flatten in ``ravel_pytree``'s order and
    values, and write back with each leaf's dtype."""
    cfg_j = JR.tiny_config(family, dtype="bfloat16", num_shared_experts=1)
    stem, layers, head = _model(cfg_j)
    lid = next(i for i, t in enumerate(JR.flat_layer_types(cfg_j))
               if t.endswith("moe"))
    tl = params_from_numpy(*_np((stem, layers, head)), "cpu")[1][lid]
    moe = tl["moe"]
    assert [id(t) for t in tree_leaves(moe)] == [id(moe["router"])] + [
        id(moe["shared"][k]) for k in ("wg", "wo", "wu")] + [
        id(moe[k]) for k in ("wg", "wo", "wu")]
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].dtype == torch.bfloat16
    fl = EntryFlattener()
    vec = fl.flatten_entry(lid, tl)
    want = np.asarray(ravel_pytree(layers[lid])[0])
    assert want.dtype == np.float32
    np.testing.assert_array_equal(vec.numpy(), want)
    fl.write_entry(lid, vec * 2)
    assert moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(fl.flatten_entry(lid, tl).numpy(),
                                  2 * want)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_step_twin_vs_reference(name):
    cfg_j, cfg_t = _cfgs(name)
    ref = JCluster(cfg_j, 2, 2, use_pallas=False, **KW)
    cl = VirtualCluster(cfg_t, 2, 2, device="cpu", init_params=(
        _np(ref.stem), _np(ref.layer_params), _np(ref.head)), **KW)
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


def test_params_from_stacked_carries_the_moe_subtree():
    """The reference's stacked whole-model tree (serving's layout) carries
    ``moe`` as it stands; the whole-model forward and its aux loss equal
    the reference's."""
    cfg_j, cfg_t = _cfgs("hybrid", num_shared_experts=1)
    params_j = JT.init_params(jax.random.key(1), cfg_j)
    params_t = params_from_stacked(cfg_t, params_j, "cpu")
    stem, layers, head = params_t
    types = R.flat_layer_types(cfg_t)
    assert [("moe" in p, "mlp" in p) for p in layers] == [
        (t.endswith("moe"), not t.endswith("moe")) for t in types]
    toks = np.random.default_rng(2).integers(
        0, cfg_t.vocab_size, (2, 16)).astype(np.int32)
    lj, _, aux_j = JT.forward(params_j, cfg_j, jnp.asarray(toks))
    lt, _, aux_t = T.forward(params_t, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FWD)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_relu2_moe_cluster_trains_unread_wu():
    """Under relu2 nothing reads the experts' ``wu``: its gradient is zero
    (the cluster materialises it) and AdamW's decay still moves it, as in
    the reference."""
    cfg_j, cfg_t = _cfgs("moe", activation="relu2", num_layers=2)
    kw = dict(KW, global_batch=4)
    ref = JCluster(cfg_j, 2, 1, use_pallas=False, **kw)
    cl = VirtualCluster(cfg_t, 2, 1, device="cpu", init_params=(
        _np(ref.stem), _np(ref.layer_params), _np(ref.head)), **kw)
    before = cl.layer_params[1]["moe"]["wu"].clone()
    a, b = cl.train_step(), ref.train_step()
    assert abs(a - b) <= KCC.LOSS_ATOL + KCC.LOSS_RTOL * abs(b)
    after = cl.layer_params[1]["moe"]["wu"]
    assert not torch.equal(before, after)
    np.testing.assert_allclose(after.detach().numpy(),
                               np.asarray(ref.layer_params[1]["moe"]["wu"]),
                               rtol=KCC.PARAM_RTOL, atol=KCC.PARAM_ATOL0)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e",
                                  "jamba_1p5_large_398b"])
def test_launcher_serves_the_moe_smoke_configs(arch, capsys):
    """``launch/serve.py --smoke`` serves both MoE configs' smoke sizes
    (the hybrid one's Mamba2, attention and MoE blocks) on the CPU."""
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--tokens", "4"])
    assert out["summary"]["completed"] == 4
    assert out["sequences"].shape == (4, 4)        # generated tokens
    assert "serving" in capsys.readouterr().out
