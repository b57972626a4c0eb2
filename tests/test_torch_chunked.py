"""The port's chunked attention path (``cfg.attn_chunked``: online softmax
in plain tensor code) on the CPU against the JAX package: ``_sdpa_chunked``
at the reference's ``TestChunkedAttention`` shapes, with per-row offsets
and a v head of its own width, the model's loss and gradients, and the
chunked prefill into a cache with and without MLA (the reference's
``TestChunkedPrefill``).

Weights come from the reference (``jax.random`` init) through
``repro_torch.weights``; activations and tokens from numpy with a seed.
Tolerances: float32 within ``FWD``/``GRAD`` (the ``flash_attention`` tier
of ``kernels/ops.py``: the same online softmax, sums in other orders);
bf16 inputs within ``BF16`` (the ``flash_attention_bf16`` tier: float32
math rounded once to bf16 on both sides).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.core.statespace import flatten_leaves, tree_leaves  # noqa: E402
from repro_torch.kernels.ops import TOLERANCE_TIERS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.weights import params_from_numpy, params_from_stacked  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

FWD = dict(TOLERANCE_TIERS["flash_attention"])
GRAD = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(TOLERANCE_TIERS["flash_attention_bf16"])
CHUNKS = dict(attn_chunked=True, attn_chunk_q=8, attn_chunk_kv=8)
MLA = dict(use_mla=True, q_lora_rank=32, kv_lora_rank=32, qk_rope_dim=16,
           qk_nope_dim=16, v_head_dim=24)


def _qkv(B, S, T_, H, Hkv, hd, hv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T_, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, T_, Hkv, hv)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


@pytest.mark.parametrize("S,cq,ckv", [(96, 32, 48), (200, 64, 64),
                                      (128, 512, 1024)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_the_reference_and_the_full_form(S, cq, ckv, causal):
    """The reference's TestChunkedAttention shapes: [2, S, 4, 32] over 2
    kv heads, against the reference's chunked form and the port's plain
    one."""
    q, k, v = _qkv(2, S, S, 4, 2, 32, 32)
    want = JL._sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                            causal=causal, chunk_q=cq, chunk_kv=ckv)
    got = L._sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, chunk_q=cq, chunk_kv=ckv)
    _close(got, want, FWD)
    full = L._sdpa_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    _close(got, full.numpy(), dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_row_offsets_and_a_narrower_v_head(dtype):
    """Queries at per-row offsets into a longer key sequence (a prefill
    into a cache), v head 24 against q·k's 32, ragged chunks."""
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, FWD),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}[dtype]
    q, k, v = _qkv(3, 10, 29, 4, 2, 32, 24, seed=1)
    off = np.array([0, 7, 19])
    want = JL._sdpa_chunked(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            causal=True, chunk_q=4, chunk_kv=8,
                            q_offset=jnp.asarray(off, jnp.int32))
    got = L._sdpa_chunked(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          causal=True, chunk_q=4, chunk_kv=8,
                          q_offset=torch.from_numpy(off))
    assert got.dtype == tdt and got.shape == (3, 10, 4, 24)
    _close(got, want, tol)


def _per_layer(cfg_j):
    ks = jax.random.split(jax.random.key(7), cfg_j.num_layers + 2)
    stem = JR.init_stem(ks[0], cfg_j)
    layers = [JR.init_layer(ks[1 + i], cfg_j, i)
              for i in range(cfg_j.num_layers)]
    head = JR.init_head(ks[-1], cfg_j)
    np_ = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    return (stem, layers, head), params_from_numpy(np_(stem), np_(layers),
                                                   np_(head), "cpu")


def test_model_loss_and_grads():
    """The tiny dense model (2 layers) under ``attn_chunked`` (chunks of 8
    over 16 tokens): loss and every gradient against the reference's
    chunked layers."""
    cfg_j = JR.tiny_config("dense", num_layers=2, **CHUNKS)
    cfg_t = R.tiny_config("dense", num_layers=2, **CHUNKS)
    jparams, tparams = _per_layer(cfg_j)
    toks = np.random.default_rng(1).integers(
        0, cfg_j.vocab_size, (2, 16)).astype(np.int32)

    def j_loss(params):
        stem, layers, head = params
        x = JR.apply_stem(stem, cfg_j, jnp.asarray(toks))
        pos = jnp.broadcast_to(jnp.arange(16)[None], (2, 16))
        for lid in range(cfg_j.num_layers):
            x, _ = JR.apply_layer(layers[lid], cfg_j, lid, x, pos,
                                  JL.RngCtx())
        return JT.softmax_xent(JR.apply_head(head, cfg_j, x)[:, :-1],
                               jnp.asarray(toks)[:, 1:])

    jloss, jgrads = jax.value_and_grad(j_loss)(jparams)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    stem, layers, head = tparams
    x = R.apply_stem(stem, cfg_t, torch.from_numpy(toks))
    pos = torch.arange(16)[None].expand(2, 16)
    for lid in range(cfg_t.num_layers):
        x, _ = R.apply_layer(layers[lid], cfg_t, lid, x, pos, L.RngCtx())
    loss = T.softmax_xent(R.apply_head(head, cfg_t, x)[:, :-1],
                          torch.from_numpy(toks)[:, 1:])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(flatten_leaves(grads).numpy(),
                               np.asarray(ravel_pytree(jgrads)[0]), **GRAD)


@pytest.mark.parametrize("mla", [False, True])
def test_chunked_prefill_into_cache(mla):
    """The reference's TestChunkedPrefill: a 12-token prefill and one
    decode step, chunked, against the reference's chunked model from the
    same weights, and against the port's unchunked one."""
    kw = dict(MLA, capacity_factor=16.0) if mla else {}
    family = "moe" if mla else "dense"
    cfg_j = JR.tiny_config(family, **kw, **CHUNKS)
    cfg_t = R.tiny_config(family, **kw, **CHUNKS)
    pj = JT.init_params(jax.random.key(0), cfg_j)
    pt = params_from_stacked(cfg_t, pj, "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, (2, 12)).astype(np.int32)
    lj, cj = JT.prefill(pj, cfg_j, jnp.asarray(toks),
                        JT.init_caches(cfg_j, 2, 16))
    lj2, _ = JT.decode_step(pj, cfg_j, jnp.asarray(toks[:, :1]), cj, 12)
    outs = []
    for c in (cfg_t, dataclasses.replace(cfg_t, attn_chunked=False)):
        lt, ct = T.prefill(pt, c, torch.as_tensor(toks),
                           T.init_caches(c, 2, 16))
        lt2, _ = T.decode_step(pt, c, torch.as_tensor(toks[:, :1]), ct, 12)
        outs.append((lt, lt2))
    _close(outs[0][0], lj, FWD)
    _close(outs[0][1], lj2, FWD)
    for a, b in zip(*outs):
        _close(a, b.numpy(), dict(rtol=3e-4, atol=3e-4))
