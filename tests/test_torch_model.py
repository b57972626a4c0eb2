"""The port's dense decoder on the CPU against ``repro.models.registry``.

Weights come from the reference (``jax.random`` init) through
``repro_torch.weights``; tokens and activations from numpy with a seed.  The
reference runs its plain jnp path; the port its kernels' plain versions.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro.models.layers import RngCtx as JRngCtx  # noqa: E402
from repro.models.transformer import softmax_xent as j_xent  # noqa: E402
from repro_torch.core.statespace import (EntryFlattener, flatten_leaves,  # noqa: E402
                                         tree_leaves)
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.layers import RngCtx  # noqa: E402
from repro_torch.models.transformer import softmax_xent  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ACTS = ["silu", "relu2", "gelu"]
FWD = dict(rtol=1e-4, atol=1e-5)      # fp32 forward, other summation order
GRAD = dict(rtol=1e-4, atol=2e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(act):
    cfg_j = JR.tiny_config("dense", activation=act)
    cfg_t = R.tiny_config("dense", activation=act)
    ks = jax.random.split(jax.random.key(7), cfg_j.num_layers + 2)
    stem = JR.init_stem(ks[0], cfg_j)
    layers = [JR.init_layer(ks[1 + i], cfg_j, i)
              for i in range(cfg_j.num_layers)]
    head = JR.init_head(ks[-1], cfg_j)
    ported = params_from_numpy(_np(stem), _np(layers), _np(head), "cpu")
    return cfg_j, cfg_t, (stem, layers, head), ported


def _tokens(cfg, B=2, S=16):
    rs = np.random.default_rng(0)
    return rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _j_loss(cfg, stem, layers, head, toks):
    x = JR.apply_stem(stem, cfg, toks)
    B, S, _ = x.shape
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    for lid in range(cfg.num_layers):
        x, _ = JR.apply_layer(layers[lid], cfg, lid, x, pos, JRngCtx())
    return j_xent(JR.apply_head(head, cfg, x)[:, :-1], toks[:, 1:])


def _t_loss(cfg, stem, layers, head, toks):
    x = R.apply_stem(stem, cfg, toks)
    B, S, _ = x.shape
    pos = torch.arange(S)[None].expand(B, S)
    for lid in range(cfg.num_layers):
        x, _ = R.apply_layer(layers[lid], cfg, lid, x, pos, RngCtx())
    return softmax_xent(R.apply_head(head, cfg, x)[:, :-1], toks[:, 1:])


@pytest.mark.parametrize("act", ACTS)
def test_layer_stem_head_forward(act):
    cfg_j, cfg_t, (stem, layers, head), (tstem, tlayers, thead) = _model(act)
    toks = _tokens(cfg_j)
    x = np.asarray(JR.apply_stem(stem, cfg_j, jnp.asarray(toks)))
    np.testing.assert_array_equal(
        R.apply_stem(tstem, cfg_t, torch.from_numpy(toks)).numpy(), x)
    rs = np.random.default_rng(1)
    h = rs.standard_normal((2, 16, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16))
    for lid in range(cfg_j.num_layers):
        want, _ = JR.apply_layer(layers[lid], cfg_j, lid, jnp.asarray(h),
                                 jnp.asarray(pos), JRngCtx())
        got, aux = R.apply_layer(tlayers[lid], cfg_t, lid, torch.from_numpy(h),
                                 torch.from_numpy(pos.copy()), RngCtx())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
        assert float(aux) == 0.0
    np.testing.assert_allclose(
        R.apply_head(thead, cfg_t, torch.from_numpy(h)).numpy(),
        np.asarray(JR.apply_head(head, cfg_j, jnp.asarray(h))), **FWD)


@pytest.mark.parametrize("act", ACTS)
def test_loss_and_model_grads(act):
    cfg_j, cfg_t, jparams, tparams = _model(act)
    toks = _tokens(cfg_j)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda s, l, h: _j_loss(cfg_j, s, l, h, jnp.asarray(toks)),
        argnums=(0, 1, 2)))(*jparams)
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = _t_loss(cfg_t, *tparams, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    # model-flat order of the port == ravel_pytree order of the reference
    np.testing.assert_allclose(flatten_leaves(grads).numpy(),
                               np.asarray(ravel_pytree(jgrads)[0]), **GRAD)


def test_softmax_xent_vs_reference():
    rs = np.random.default_rng(2)
    logits = rs.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rs.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rs.random((3, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = j_xent(jnp.asarray(logits), jnp.asarray(labels),
                      None if m is None else jnp.asarray(m))
        got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("act", ACTS)
def test_entry_flattener_matches_ravel_pytree_bitwise(act):
    _, _, (stem, layers, head), (tstem, tlayers, thead) = _model(act)
    fl = EntryFlattener()
    for e, jt, tt in [(-1, stem, tstem), (0, layers[0], tlayers[0]),
                      (-2, head, thead)]:
        np.testing.assert_array_equal(fl.flatten_entry(e, tt).numpy(),
                                      np.asarray(ravel_pytree(jt)[0]))
    whole = flatten_leaves(tree_leaves((tstem, tlayers, thead)))
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(ravel_pytree((stem, layers, head))[0]))


def test_entry_flattener_writes_back_with_leaf_dtype():
    """bf16 leaves round to nearest even on write-back, as ravel_pytree's
    unravel does."""
    tree = {"b": torch.zeros(3, dtype=torch.bfloat16), "a": torch.zeros(2)}
    fl = EntryFlattener()
    fl.flatten_entry(0, tree)
    vec = np.array([0.1, 0.2, 1.00390625, 1.01171875, 3.3], np.float32)
    fl.write_entry(0, torch.from_numpy(vec))
    _, unravel = ravel_pytree({"b": jnp.zeros(3, jnp.bfloat16),
                               "a": jnp.zeros(2)})
    want = unravel(jnp.asarray(vec))
    np.testing.assert_array_equal(tree["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(tree["b"].float().numpy(),
                                  np.asarray(want["b"], np.float32))


def test_params_carry_bf16_leaves_exactly():
    x = jnp.asarray(np.random.default_rng(3).standard_normal(64),
                    jnp.bfloat16)
    (t,), _, _ = params_from_numpy([np.asarray(x)], [], {}, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


def test_unported_paths_raise():
    """MLA still raises; an MoE block builds (since the MoE slice, with the
    reference's leaves: router, experts and no dense MLP) and returns its
    load-balancing loss; dropout at a positive rate runs (the reference's
    masks, ``test_torch_threefry.py``): kept elements are scaled by
    fl32(1 / fl32(0.9)), the rest are zero."""
    with pytest.raises(NotImplementedError, match="not ported"):
        R.init_layer(torch.Generator().manual_seed(0),
                     R.tiny_config("dense", use_mla=True), 0)
    moe, moe_j = R.tiny_config("moe"), JR.tiny_config("moe")
    p = R.init_layer(torch.Generator().manual_seed(0), moe, 1)
    want = JR.init_layer(jax.random.key(0), moe_j, 1)
    assert sorted(p) == sorted(want) and "mlp" not in p
    assert sorted(p["moe"]) == sorted(want["moe"])
    h = torch.randn(2, 8, moe.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, aux = R.apply_layer(p, moe, 1, h, torch.arange(8)[None].expand(2, 8),
                           RngCtx())
    assert y.shape == h.shape and float(aux) > 0
    cfg = R.tiny_config("dense", dropout_rate=0.1)
    x = torch.ones(2, 8, cfg.d_model)
    from repro_torch.kernels.threefry import fold_in, key_from_seed
    from repro_torch.models.layers import dropout
    ctx = RngCtx(step_key=fold_in(key_from_seed(0), 0),
                 sample_ids=torch.tensor([0, 1], dtype=torch.int32),
                 deterministic=False)
    y = dropout(x, 0.1, ctx)
    scale = float(np.float32(1) / np.float32(0.9))
    assert set(y.unique().tolist()) == {0.0, scale}
    assert 0.8 < float((y != 0).float().mean()) < 1.0
    assert not torch.equal(y[0], y[1])          # per-sample streams
