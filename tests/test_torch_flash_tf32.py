"""The float32 flash-attention route (``csrc/flash_attention_tf32.cu``) on the
CPU.

The kernel runs only on the card, so its arithmetic is emulated here in
plain torch, tile by tile as the kernel does it: every operand split into
TF32 hi + lo halves (rounded to nearest, ties away from zero, by an integer
add and a mask), three products per pair (lo.hi + hi.lo, then hi.hi), head
dims and keys in the kernel's k-slot order, the products of two 8-dim steps
of q.k^T and of one 32-key tile of P.V summed from zero before they reach
the running sums, and the online softmax in the exp2 domain over 32-key
tiles of 128-row q blocks.  The emulation is held to the
``flash_attention`` tier against the port's plain version and against the
JAX package's wrapper (Pallas in interpret mode) on the same numpy inputs,
and one TF32 product is shown to miss the tier where three hold.  The
dispatch of float32 to the new route, the explicit CUDA-core entry and the
copy of layouts ``cp.async`` cannot read are tested with the launch
monkeypatched.
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: E402,F401

BLOCK_M, BLOCK_N, GROUP = 128, 32, 2
TIER = ops.TOLERANCE_TIERS["flash_attention"]
# the kernel's k-slot order within an 8-wide step: slot t holds element
# 2t, slot t + 4 element 2t + 1
SLOTS = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def tf32_round(x):
    """The kernel's ``tf32_bits``: float32 rounded to 10 explicit mantissa
    bits, to nearest with ties away from zero (cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def products(a, b, n):
    """a [.., m, 8] @ b [.., 8, n'] as the kernel's mma.sync chain: three
    TF32 products lo.hi, hi.lo, hi.hi (n = 3) or hi.hi alone (n = 1)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if n == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def emulate_tf32(q, k, v, causal, n_products=3):
    """The 3xTF32 kernel's arithmetic in plain torch (float32 on the CPU):
    q [B,S,H,hd], k/v [B,S,Hkv,hd] float32 -> [B,S,H,hd] float32."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    qf = q.transpose(1, 2)                                   # [B,H,S,hd]
    kf, vf = (t.repeat_interleave(rep, 2).transpose(1, 2) for t in (k, v))
    scale_log2 = torch.tensor(hd ** -0.5, dtype=torch.float32) \
        * torch.tensor(math.log2(math.e), dtype=torch.float32)
    out = torch.empty_like(qf)
    for q0 in range(0, S, BLOCK_M):
        rows = torch.arange(q0, q0 + BLOCK_M)[:, None]
        qt = torch.zeros((B, H, BLOCK_M, hd))
        qt[:, :, :S - q0] = qf[:, :, q0:q0 + BLOCK_M]       # zero-filled
        m = torch.full((B, H, BLOCK_M), -1e30)              # exp2 domain
        l = torch.zeros((B, H, BLOCK_M))
        acc = torch.zeros((B, H, BLOCK_M, hd))
        kv_end = min(S, q0 + BLOCK_M) if causal else S
        for k0 in range(0, kv_end, BLOCK_N):
            keys = torch.arange(k0, k0 + BLOCK_N)[None, :]
            kt = torch.zeros((B, H, BLOCK_N, hd))
            vt = torch.zeros((B, H, BLOCK_N, hd))
            kt[:, :, :S - k0] = kf[:, :, k0:k0 + BLOCK_N]
            vt[:, :, :S - k0] = vf[:, :, k0:k0 + BLOCK_N]
            s = torch.zeros((B, H, BLOCK_M, BLOCK_N))
            for d0 in range(0, hd, 8 * GROUP):
                part = torch.zeros_like(s)
                for d in range(d0, d0 + 8 * GROUP, 8):
                    dims = d + SLOTS
                    part += products(qt[..., dims],
                                     kt[..., dims].transpose(-1, -2),
                                     n_products)
                s = s + part
            s = torch.where(keys >= S, -math.inf, s)
            if causal:
                s = torch.where(keys > rows, torch.tensor(-1e30), s)
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            alpha = torch.exp2(m - m_new)
            # one FFMA: s * scale_log2 - m rounded once
            p = torch.exp2((s.double() * scale_log2.double()
                            - m_new.double()[..., None]).float())
            l = l * alpha + p.sum(-1)
            part = torch.zeros_like(acc)
            for j in range(0, BLOCK_N, 8):
                ks = j + SLOTS
                part += products(p[..., ks], vt[..., ks, :], n_products)
            acc = acc * alpha[..., None] + part
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0:q0 + BLOCK_M] = o[:, :, :S - q0]
    return out.transpose(1, 2)


def _inputs(seed, S, H, Hkv, hd, qscale=1.0, B=2):
    rs = np.random.default_rng(seed)
    return [(rs.standard_normal((B, S, n, hd)) * sc).astype(np.float32)
            for n, sc in ((H, qscale), (Hkv, 1.0), (Hkv, 1.0))]


def _within(a, b, tier=TIER):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, **tier)


def _misses(got, want, tier=TIER):
    err = (got.double() - want.double()).abs()
    return int((err > tier["atol"] + tier["rtol"] * want.double().abs())
               .sum())


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_tf32_emulation_within_tier(hd, causal, H, Hkv):
    q, k, v = _inputs(20 + hd + H * Hkv + causal, 256, H, Hkv, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = emulate_tf32(tq, tk, tv, causal)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    _within(got, ref.gqa_attention_reference(tq, tk, tv, causal=causal))
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal)
    _within(got, np.asarray(want))


@pytest.mark.parametrize("S", [16, 200, 300])
def test_tf32_emulation_ragged_sequence(S):
    """S below one 32-key tile (the tiny twins' 16) and S not a multiple
    of the 128-row q block or the key tile: zero-filled rows and keys
    masked."""
    hd = 16 if S == 16 else 64
    q, k, v = _inputs(S, S, 4, 2, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for causal in (True, False):
        _within(emulate_tf32(tq, tk, tv, causal),
                ref.gqa_attention_reference(tq, tk, tv, causal=causal))
    if S == 16:          # the Pallas kernel needs S % block == 0
        want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=True)
        _within(emulate_tf32(tq, tk, tv, True), np.asarray(want))


@pytest.mark.parametrize("hd", [64, 128])
def test_tf32_emulation_peaked_softmax(hd):
    """q x 4: the softmax is dominated by a few keys per row."""
    q, k, v = _inputs(40 + hd, 256, 4, 4, hd, qscale=4.0)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = emulate_tf32(tq, tk, tv, True)
    _within(got, ref.gqa_attention_reference(tq, tk, tv, causal=True))
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=True)
    _within(got, np.asarray(want))


@pytest.mark.parametrize("hd,qscale", [(64, 1.0), (128, 1.0), (128, 4.0)])
def test_one_tf32_product_misses_the_tier_three_hold(hd, qscale):
    """The reason for three products: against the float64 evaluation of the
    same function, one TF32 product per pair misses the flash_attention
    tier on most elements; three miss none."""
    q, k, v = _inputs(60 + hd, 256, 4, 4, hd, qscale=qscale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    exact = ref.gqa_attention_reference(tq.double(), tk.double(), tv.double(),
                                        causal=True)
    one = _misses(emulate_tf32(tq, tk, tv, True, n_products=1), exact)
    three = _misses(emulate_tf32(tq, tk, tv, True, n_products=3), exact)
    assert one > exact.numel() // 2, (one, exact.numel())
    assert three == 0


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + 3 * ulp / 2,
                      one + ulp / 2 - 2.0 ** -23, one + 0.75 * ulp])
    assert tf32_round(x).tolist() == [one + ulp, -(one + ulp), one + 2 * ulp,
                                      one, one + ulp]
    rs = np.random.default_rng(1)
    r = torch.from_numpy(rs.standard_normal(10_000).astype(np.float32))
    hi, lo = split(r)
    rel = ((hi.double() + lo.double()) - r.double()).abs() / r.double().abs()
    assert float(rel.max()) <= 2.0 ** -22
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())


def test_float64_witness_of_the_plain_version():
    """``ref.mha_reference`` computes in float64 for float64 operands and in
    float32 for float32 ones (the plain version the kernels are held to)."""
    q, k, v = _inputs(3, 64, 2, 2, 32, B=1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    f32 = ref.gqa_attention_reference(tq, tk, tv, causal=True)
    f64 = ref.gqa_attention_reference(tq.double(), tk.double(), tv.double(),
                                      causal=True)
    assert f32.dtype == torch.float32 and f64.dtype == torch.float64
    assert not torch.equal(f64.float(), f32)
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture
def recorded_launches(monkeypatch):
    """Launch nothing: record (counter, entry, args) of each launch."""
    calls = []
    monkeypatch.setattr(fa, "_require_card", lambda *ts: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, entry, *args:
                        calls.append((kernel, entry, args)))
    return calls


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_float32_takes_the_tf32_route(recorded_launches, hd):
    q = torch.zeros(1, 40, 4, hd)
    kv = torch.zeros(1, 40, 2, hd)
    assert fa.uses_tf32(torch.float32, hd)
    assert not fa.uses_tf32(torch.bfloat16, hd)
    fa.flash_attention_cuda(q, kv, kv, False)
    ((kernel, entry, args),) = recorded_launches
    assert (kernel, entry) == ("flash_attention_tf32",
                               "repro_flash_attention_tf32")
    assert len(args) == len(_build.SIGNATURES[entry])       # stream last
    assert args[4:9] == (1, 40, 4, 2, hd)
    assert args[9:18] == (40 * 4 * hd, 4 * hd, hd, 40 * 2 * hd, 2 * hd, hd,
                          40 * 2 * hd, 2 * hd, hd)
    assert args[18:20] == (0, hd ** -0.5)


def test_tf32_route_copies_what_cp_async_cannot_read(recorded_launches):
    """A view 4 bytes off a 16-byte boundary is copied contiguous; a fused
    projection's aligned views go in place."""
    H, Hkv, hd = 4, 2, 64
    x = torch.zeros(1, 32, (H + 2 * Hkv) * hd)
    q = x[..., :H * hd].unflatten(-1, (H, hd))
    k = x[..., H * hd:(H + Hkv) * hd].unflatten(-1, (Hkv, hd))
    v = x[..., (H + Hkv) * hd:].unflatten(-1, (Hkv, hd))
    flat = torch.zeros(32 * H * hd + 1)
    off = flat[1:].view(1, 32, H, hd)
    fa.flash_attention_cuda(q, k, v, True)
    fa.flash_attention_cuda(off, k, v, True)
    (_, _, inplace), (_, _, copied) = recorded_launches
    assert inplace[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert inplace[9:12] == q.stride()[:3]
    assert copied[0] != off.data_ptr() and copied[0] % 16 == 0
    assert copied[9:12] == (32 * H * hd, H * hd, hd)
    assert copied[1:3] == (k.data_ptr(), v.data_ptr())


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128),
                                      (torch.float32, 16),
                                      (torch.bfloat16, 32)])
def test_cuda_cores_entry_launches_the_cuda_core_kernel(recorded_launches,
                                                        dtype, hd):
    q = torch.zeros(1, 32, 4, hd, dtype=dtype)
    fa.flash_attention_cuda_cores(q, q, q, True)
    ((kernel, entry, args),) = recorded_launches
    assert (kernel, entry) == ("flash_attention", "repro_flash_attention")
    assert len(args) == len(_build.SIGNATURES[entry])


@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_cores_entry_refuses_bf16_at_tensor_core_widths(
        recorded_launches, hd):
    q = torch.zeros(1, 32, 4, hd, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no CUDA-core kernel"):
        fa.flash_attention_cuda_cores(q, q, q, True)
    assert recorded_launches == []


def test_cuda_cores_entry_requires_card():
    q = torch.zeros(1, 32, 4, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda_cores(q, q, q, True)
