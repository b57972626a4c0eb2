"""The port's MLA layer (deepseek-v3's latent attention) on the CPU
against the JAX package: ``apply_mla`` in the training form (forward and
gradients), prefill and decode with the latent cache, ``rows=`` and the
absorbed decode.

Weights come from the reference (``jax.random`` init) through
``repro_torch.weights``; activations and tokens from numpy with a seed.
The layer config is the reference's ``TestMlaAbsorption`` one (q_lora 32,
kv_lora 32, qk 16 nope + 16 rope, v head 24), and the same without a
q_lora rank (``wq``).  The whole model, its flat order and a serving
engine: tests/test_torch_mla_model.py; the cluster:
tests/test_torch_mla_cluster.py.  Tolerances: float32 ``FWD``/``GRAD`` (the
``flash_attention`` tier of ``kernels/ops.py``, sums in other orders); bf16
within ``BF16``, the ``flash_attention_bf16`` tier: both sides round the
same products to bf16, in other orders.
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
from repro_torch.weights import params_from_numpy  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

FWD = dict(TOLERANCE_TIERS["flash_attention"])
GRAD = dict(rtol=1e-4, atol=2e-5)
BF16 = dict(TOLERANCE_TIERS["flash_attention_bf16"])
MLA = dict(use_mla=True, q_lora_rank=32, kv_lora_rank=32, qk_rope_dim=16,
           qk_nope_dim=16, v_head_dim=24, capacity_factor=16.0)
VARIANTS = {"q_lora": MLA, "wq": dict(MLA, q_lora_rank=0)}
MAX_LEN = 16


def _cfgs(variant="q_lora", **kw):
    over = dict(VARIANTS[variant], **kw)
    return JR.tiny_config("moe", **over), R.tiny_config("moe", **over)


def _layer(cfg_j, seed=0):
    """The reference's MLA params and the port's copy of them."""
    p = JL.init_mla(jax.random.key(seed), cfg_j)
    (tp,), _, _ = params_from_numpy([jax.tree.map(np.asarray, p)], [], {},
                                    "cpu")
    return p, tp


def _x(cfg, B=2, S=9, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return x, np.broadcast_to(np.arange(S)[None], (B, S)).copy()


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


def _j(a, dtype):
    return jnp.asarray(a, dtype)


def _t(a, dtype):
    return torch.as_tensor(a).to(dtype)


DTYPES = {"float32": (jnp.float32, torch.float32, FWD),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("offset", [False, True])
def test_sdpa_plain_matches_the_reference(dtype, offset):
    """The plain attention MLA calls by name: aligned (the lower triangle)
    or over a cache at per-row offsets, a v head narrower than q·k's."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    B, S, H, Hkv, hd, hv = 2, 6, 4, 2, 32, 24
    T_ = 10 if offset else S
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T_, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T_, Hkv, hv)).astype(np.float32)
    off = np.array([0, 4]) if offset else None
    want = JL._sdpa(_j(q, jdt), _j(k, jdt), _j(v, jdt), True,
                    q_offset=None if off is None else jnp.asarray(off))
    got = L._sdpa_plain(_t(q, tdt), _t(k, tdt), _t(v, tdt), True,
                        None if off is None else torch.as_tensor(off))
    assert got.dtype == tdt and got.shape == (B, S, H, hv)
    _close(got, want, tol)


def test_sdpa_plain_without_an_offset_needs_equal_lengths():
    """S != T without a cache offset is the enc-dec model's
    cross-attention, which waits for its slice."""
    q = torch.zeros(1, 3, 2, 8)
    with pytest.raises(NotImplementedError, match="not ported"):
        L._sdpa_plain(q, torch.zeros(1, 5, 2, 8), torch.zeros(1, 5, 2, 8),
                      True)


def test_init_mla_leaves_match_the_reference():
    """Both variants' leaves, shapes and dtypes are the reference's."""
    for variant in VARIANTS:
        cfg_j, cfg_t = _cfgs(variant)
        want = JL.init_mla(jax.random.key(0), cfg_j)
        got = L.init_mla(torch.Generator().manual_seed(0), cfg_t)
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                            got) == \
            jax.tree.map(lambda a: (a.shape, a.dtype.name), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_training_form_forward_and_grads(variant):
    cfg_j, cfg_t = _cfgs(variant)
    p, tp = _layer(cfg_j)
    x, pos = _x(cfg_j)
    w = np.random.default_rng(3).standard_normal(
        (2, 9, cfg_j.d_model)).astype(np.float32)

    def jloss(p, x):
        y, _ = JL.apply_mla(p, cfg_j, x, jnp.asarray(pos))
        return jnp.sum(y * w), y

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(p, jnp.asarray(x))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, cache = L.apply_mla(tp, cfg_t, xt, torch.from_numpy(pos))
    assert cache is None
    _close(y, want, FWD)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                [xt] + leaves)
    _close(grads[0], gx, GRAD)
    np.testing.assert_allclose(flatten_leaves(grads[1:]).numpy(),
                               np.asarray(ravel_pytree(gp)[0]), **GRAD)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("absorb", [False, True])
def test_prefill_and_decode_with_the_latent_cache(dtype, absorb):
    """A prefill of 5 tokens at index 0, then three decode steps at per-row
    positions from 5 and 3 (the second row writing over its prompt's
    tail): outputs and both latent caches against the reference after
    every call."""
    jdt, tdt, tol = DTYPES[dtype]
    cfg_j, cfg_t = _cfgs(dtype=dtype, mla_absorb=absorb)
    p, _ = _layer(cfg_j)
    p = jax.tree.map(lambda a: a.astype(jdt) if a.ndim > 1 else a, p)
    (tp,), _, _ = params_from_numpy([jax.tree.map(np.asarray, p)], [], {},
                                    "cpu")
    cj = JT.init_block_cache(cfg_j, "attn", 2, MAX_LEN)
    ct = T.init_block_cache(cfg_t, "attn", 2, MAX_LEN)
    x, pos = _x(cfg_j, S=5)
    want, cj = JL.apply_mla(p, cfg_j, _j(x, jdt), jnp.asarray(pos),
                            kv_cache=cj, cache_index=0)
    got, ct2 = L.apply_mla(tp, cfg_t, _t(x, tdt), torch.from_numpy(pos),
                           kv_cache=ct, cache_index=0)
    assert ct2 is ct and got.dtype == tdt
    _close(got, want, tol)
    rng = np.random.default_rng(4)
    at = np.array([5, 3])
    for _ in range(3):
        x = rng.standard_normal((2, 1, cfg_j.d_model)).astype(np.float32)
        want, cj = JL.apply_mla(p, cfg_j, _j(x, jdt),
                                jnp.asarray(at[:, None]), kv_cache=cj,
                                cache_index=jnp.asarray(at, jnp.int32))
        got, _ = L.apply_mla(tp, cfg_t, _t(x, tdt),
                             torch.from_numpy(at[:, None].copy()),
                             kv_cache=ct, cache_index=torch.from_numpy(at))
        _close(got, want, tol)
        for k in ("c_kv", "k_rope"):
            _close(ct[k], cj[k], tol)
        at = at + 1


def test_absorbed_decode_matches_the_expanded_form():
    """The reference's TestMlaAbsorption: the whole model's decode logits
    after an 8-token prefill, absorbed against expanded, in the port."""
    _, cfg_t = _cfgs()
    params = R.init_model(torch.Generator().manual_seed(0), cfg_t)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, (2, 9)))
    outs = []
    for c in (cfg_t, dataclasses.replace(cfg_t, mla_absorb=True)):
        caches = T.init_caches(c, 2, MAX_LEN)
        _, caches = T.prefill(params, c, toks[:, :8], caches)
        lg, _ = T.decode_step(params, c, toks[:, 8:9], caches, 8)
        outs.append(lg.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("absorb", [False, True])
def test_decode_rows_write_only_their_latent_caches(absorb):
    _, cfg_t = _cfgs(mla_absorb=absorb)
    tp = L.init_mla(torch.Generator().manual_seed(0), cfg_t)
    cache = T.init_block_cache(cfg_t, "attn", 2, MAX_LEN)
    x = torch.randn(2, 4, cfg_t.d_model,
                    generator=torch.Generator().manual_seed(1))
    L.apply_mla(tp, cfg_t, x, torch.arange(4)[None].expand(2, 4),
                kv_cache=cache, cache_index=0)
    before = {k: v.clone() for k, v in cache.items()}
    step = torch.randn(2, 1, cfg_t.d_model,
                       generator=torch.Generator().manual_seed(2))
    at = torch.tensor([4, 4])
    full, _ = L.apply_mla(tp, cfg_t, step, at[:, None],
                          kv_cache={k: v.clone() for k, v in before.items()},
                          cache_index=at)
    part, _ = L.apply_mla(tp, cfg_t, step, at[:, None], kv_cache=cache,
                          cache_index=at, rows=torch.tensor([1]))
    torch.testing.assert_close(part[1], full[1], rtol=0, atol=0)
    for k in cache:
        torch.testing.assert_close(cache[k][0], before[k][0], rtol=0, atol=0)
        assert not torch.equal(cache[k][1], before[k][1])
