"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's wrappers (Pallas kernels in interpret mode) and oracles.

Inputs come from numpy with a seed and go through both packages.  Forward
outputs are held within ``TOLERANCE_TIERS``; gradients against ``jax.grad``
of the reference wrappers (whose custom VJPs differentiate the oracles);
fused AdamW bitwise against ``adam_update_flat_np``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.optim.adam import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim.adam import adam_update_flat_np as j_adam_np  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.optim.adam import AdamConfig, adam_update_flat_  # noqa: E402
from repro_torch.optim.adam import adam_update_flat_np  # noqa: E402


def _rand(rs, shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _close(a, b, tier):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tier)


@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 96), (300, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_vs_reference(shape, dtype):
    rs = np.random.default_rng(1)
    x, s = _rand(rs, shape), _rand(rs, (shape[-1],))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    out = ops.rmsnorm(tx, torch.from_numpy(s), eps=1e-5)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tier = ops.TOLERANCE_TIERS["rmsnorm" if dtype == "float32"
                               else "rmsnorm_bf16"]
    _close(out.float(), jops.rmsnorm(jx, jnp.asarray(s), eps=1e-5), tier)
    _close(out.float(), jref.rmsnorm_reference(jx, jnp.asarray(s)), tier)


def test_rmsnorm_grads_vs_jax():
    rs = np.random.default_rng(2)
    x, s, g = _rand(rs, (3, 5, 32)), _rand(rs, (32,)), _rand(rs, (3, 5, 32))
    jgx, jgs = jax.grad(lambda a, b: jnp.sum(jops.rmsnorm(a, b) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    gx, gs = torch.autograd.grad(ops.rmsnorm(tx, ts), (tx, ts),
                                 torch.from_numpy(g))
    tier = ops.TOLERANCE_TIERS["rmsnorm"]
    _close(gx, jgx, dict(rtol=tier["rtol"] * 10, atol=tier["atol"] * 10))
    _close(gs, jgs, dict(rtol=tier["rtol"] * 10, atol=tier["atol"] * 10))


@pytest.mark.parametrize("S,H,Hkv,hd", [(16, 4, 2, 16), (64, 8, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_vs_reference(S, H, Hkv, hd, causal):
    rs = np.random.default_rng(3)
    B = 2
    q, k, v = (_rand(rs, (B, S, n, hd)) for n in (H, Hkv, Hkv))
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert out.shape == (B, S, H, hd)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    _close(out, want, ops.TOLERANCE_TIERS["flash_attention"])
    from repro.models.layers import _sdpa
    _close(out, _sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal), ops.TOLERANCE_TIERS["flash_attention"])


def test_flash_attention_bf16_within_declared_tier():
    rs = np.random.default_rng(4)
    q, k, v = (_rand(rs, (1, 32, n, 16)) for n in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    want = jops.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                  for a in (q, k, v)))
    _close(out.float(), want, ops.TOLERANCE_TIERS["flash_attention_bf16"])


def test_flash_attention_grads_vs_jax():
    rs = np.random.default_rng(5)
    q, k, v = (_rand(rs, (2, 16, n, 16)) for n in (4, 2, 2))
    g = _rand(rs, (2, 16, 4, 16))
    jg = jax.grad(lambda a, b, c: jnp.sum(jops.flash_attention(a, b, c) * g),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tg = torch.autograd.grad(ops.flash_attention(*ts), ts, torch.from_numpy(g))
    for a, b in zip(tg, jg):
        _close(a, b, dict(rtol=1e-4, atol=1e-5))


def test_flash_attention_head_divisibility_raises():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="H=4.*Hkv=3"):
        ops.flash_attention(q, kv, kv)


# 200_003: enough elements that a float32 sqrt off by one ulp (~0.7% of
# elements for torch.sqrt on CPU) would show
@pytest.mark.parametrize("n", [33, 4097, 200_003])
@pytest.mark.parametrize("step", [1, 7])
def test_adam_plain_bitwise_vs_numpy_oracle(n, step):
    rs = np.random.default_rng(n + step)
    st = {"master": _rand(rs, n), "mu": _rand(rs, n, 1e-3),
          "nu": np.abs(_rand(rs, n, 1e-6))}
    g = _rand(rs, n, 1e-2)
    want = adam_update_flat_np(g, st, step, AdamConfig())
    ref_want = j_adam_np(g, st, step, JAdamConfig())
    dev = {c: torch.from_numpy(v.copy()) for c, v in st.items()}
    adam_update_flat_(torch.from_numpy(g), dev, step, AdamConfig())
    for c in ("master", "mu", "nu"):
        assert np.array_equal(want[c], ref_want[c])
        assert np.array_equal(dev[c].numpy(), want[c]), c


def test_adam_shape_mismatch_raises():
    with pytest.raises(ValueError, match="mismatched"):
        ops.fused_adam_(torch.zeros(3), torch.zeros(3), torch.zeros(4),
                        torch.zeros(3), step=1)
