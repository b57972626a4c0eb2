"""The bf16 flash-attention route at head_dim 16/32
(``csrc/flash_attention_bf16_mma.cu``) on the CPU.

The kernel runs only on the card, so its arithmetic is emulated here in
plain torch, tile by tile as the kernel does it: bf16 q.k^T products summed
per 16-dim step into float32 scores, the online softmax in the exp2 domain
over 64-key tiles of 128-row q blocks (one FFMA and one exp2 a score), P
split into bf16 hi + lo halves rounded as the kernel's conversion
instruction rounds them (to nearest even), and P.V added to the accumulator
one 16-key step at a time, hi then lo.  The emulation is held to the
``flash_attention_bf16`` tier against the port's plain version and against
the JAX package's wrapper (Pallas in interpret mode) on the same numpy
inputs.  The dispatch of bf16 at head_dim 16/32 to the route, the copy of
layouts ``cp.async`` cannot read, and the launch counter are tested with
the launch monkeypatched.
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

BLOCK_M, BLOCK_N, STEP = 128, 64, 16
TIER = ops.TOLERANCE_TIERS["flash_attention_bf16"]
ENTRY = "repro_flash_attention_bf16_mma"


def bf16_round(x):
    """The kernel's ``cvt.rn.bf16x2.f32``: float32 to bf16 (kept in
    float32), to nearest even."""
    return x.bfloat16().float()


def emulate_bf16_mma(q, k, v, causal, split_p=True):
    """The kernel's arithmetic in plain torch (float32 on the CPU): q
    [B,S,H,hd], k/v [B,S,Hkv,hd] bf16 -> [B,S,H,hd] bf16.  ``split_p``
    False rounds P to bf16 once instead of splitting it."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    qf = q.float().transpose(1, 2)                          # [B,H,S,hd]
    kf, vf = (t.float().repeat_interleave(rep, 2).transpose(1, 2)
              for t in (k, v))
    scale_log2 = torch.tensor(hd ** -0.5, dtype=torch.float32) \
        * torch.tensor(math.log2(math.e), dtype=torch.float32)
    out = torch.empty_like(qf)
    for q0 in range(0, S, BLOCK_M):
        rows = torch.arange(q0, q0 + BLOCK_M)[:, None]
        qt = torch.zeros((B, H, BLOCK_M, hd))
        qt[:, :, :S - q0] = qf[:, :, q0:q0 + BLOCK_M]       # zero rows
        m = torch.full((B, H, BLOCK_M), -1e30)              # exp2 domain
        l = torch.zeros((B, H, BLOCK_M))
        acc = torch.zeros((B, H, BLOCK_M, hd))
        kv_end = min(S, q0 + BLOCK_M) if causal else S
        for k0 in range(0, kv_end, BLOCK_N):
            keys = torch.arange(k0, k0 + BLOCK_N)[None, :]
            kt = torch.zeros((B, H, BLOCK_N, hd))
            vt = torch.zeros((B, H, BLOCK_N, hd))
            kt[:, :, :S - k0] = kf[:, :, k0:k0 + BLOCK_N]   # zero-filled
            vt[:, :, :S - k0] = vf[:, :, k0:k0 + BLOCK_N]
            # bf16 x bf16 products are exact in float32: each 16-dim
            # step's sum goes into the score accumulator
            s = torch.zeros((B, H, BLOCK_M, BLOCK_N))
            for d in range(0, hd, STEP):
                s = s + qt[..., d:d + STEP] @ kt[..., d:d + STEP].transpose(
                    -1, -2)
            s = torch.where(keys >= S, -math.inf, s)
            if causal:
                s = torch.where(keys > rows, torch.tensor(-1e30), s)
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            alpha = torch.exp2(m - m_new)
            # one FFMA: s * scale_log2 - m rounded once
            p = torch.exp2((s.double() * scale_log2.double()
                            - m_new.double()[..., None]).float())
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            p_hi = bf16_round(p)
            halves = (p_hi, bf16_round(p - p_hi)) if split_p else (p_hi,)
            for j in range(0, BLOCK_N, STEP):
                for half in halves:
                    acc = acc + half[..., j:j + STEP] @ vt[..., j:j + STEP, :]
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0:q0 + BLOCK_M] = o[:, :, :S - q0]
    return out.bfloat16().transpose(1, 2)


def _inputs(seed, S, H, Hkv, hd, qscale=1.0, B=2):
    rs = np.random.default_rng(seed)
    return [(rs.standard_normal((B, S, n, hd)) * sc).astype(np.float32)
            for n, sc in ((H, qscale), (Hkv, 1.0), (Hkv, 1.0))]


def _bf16(arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


def _jax(arrays, causal):
    out = jops.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                 for a in arrays), causal=causal)
    return np.asarray(out.astype(jnp.float32))


def _within(a, b, tier=TIER):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, **tier)


def _misses(got, want, tier=TIER):
    err = (got.double() - want.double()).abs()
    return int((err > tier["atol"] + tier["rtol"] * want.double().abs())
               .sum())


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_bf16_mma_emulation_within_tier(hd, causal, H, Hkv):
    arrays = _inputs(30 + hd + H * Hkv + causal, 256, H, Hkv, hd)
    tq, tk, tv = _bf16(arrays)
    got = emulate_bf16_mma(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _within(got.float(), ref.gqa_attention_reference(
        tq, tk, tv, causal=causal).float())
    _within(got.float(), _jax(arrays, causal))


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("S", [16, 200, 300])
def test_bf16_mma_emulation_ragged_sequence(S, hd):
    """S below one 64-key tile (the tiny twins' 16 in the CPU tests) and S
    not a multiple of the 128-row q block or the key tile: zero-filled rows
    and keys masked."""
    arrays = _inputs(S + hd, S, 4, 2, hd)
    tq, tk, tv = _bf16(arrays)
    for causal in (True, False):
        _within(emulate_bf16_mma(tq, tk, tv, causal).float(),
                ref.gqa_attention_reference(tq, tk, tv,
                                            causal=causal).float())
    if S == 16:          # the Pallas kernel needs S % block == 0
        _within(emulate_bf16_mma(tq, tk, tv, True).float(),
                _jax(arrays, True))


@pytest.mark.parametrize("hd", [16, 32])
def test_bf16_mma_emulation_peaked_softmax(hd):
    """q x 4: the softmax is dominated by a few keys per row."""
    arrays = _inputs(50 + hd, 256, 4, 4, hd, qscale=4.0)
    tq, tk, tv = _bf16(arrays)
    got = emulate_bf16_mma(tq, tk, tv, True)
    _within(got.float(), ref.gqa_attention_reference(
        tq, tk, tv, causal=True).float())
    _within(got.float(), _jax(arrays, True))


@pytest.mark.parametrize("hd", [16, 32])
def test_one_rounding_of_p_is_counted(hd):
    """Why P goes through P.V as two bf16 halves: the elements that one
    rounding of P puts outside the tier of the plain version are counted
    and printed (not asserted); the split puts none there."""
    counts = {}
    for qscale in (1.0, 4.0):
        tq, tk, tv = _bf16(_inputs(70 + hd, 512, 4, 4, hd, qscale=qscale))
        want = ref.gqa_attention_reference(tq, tk, tv, causal=True).float()
        for split in (True, False):
            counts[qscale, split] = _misses(
                emulate_bf16_mma(tq, tk, tv, True, split).float(), want)
    print(f"head_dim {hd}, 2 x 512 x 4 heads x {hd} outputs: outside "
          f"flash_attention_bf16 with P rounded once "
          f"{counts[1.0, False]} (q x 1), {counts[4.0, False]} (q x 4); "
          f"with P split {counts[1.0, True]}, {counts[4.0, True]}")
    assert counts[1.0, True] == counts[4.0, True] == 0


def test_p_split_keeps_sixteen_bits():
    """hi = bf16(p) rounds ties to even, lo = bf16(p - hi) carries the rest:
    hi + lo is p to 2^-16 of it, where hi alone is off by up to 2^-9."""
    tie = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])
    assert bf16_round(tie).tolist() == [1.0, 1.0 + 2.0 ** -6]
    rs = np.random.default_rng(0)
    p = torch.from_numpy(rs.random(10_000).astype(np.float32))
    hi = bf16_round(p)
    lo = bf16_round(p - hi)
    assert torch.equal(p - hi, (p.double() - hi.double()).float())
    rel = ((hi.double() + lo.double()) - p.double()).abs() / p.double()
    assert float(rel.max()) <= 2.0 ** -16
    assert float(((hi.double() - p.double()).abs() / p.double()).max()) \
        > 2.0 ** -10


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


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_small_head_dims_take_the_mma_route(recorded_launches, hd,
                                                 causal):
    q = torch.zeros(1, 40, 4, hd, dtype=torch.bfloat16)
    kv = torch.zeros(1, 40, 2, hd, dtype=torch.bfloat16)
    assert fa.uses_bf16_mma(torch.bfloat16, hd)
    assert not fa.uses_sm90(torch.bfloat16, hd)
    assert not fa.uses_tf32(torch.bfloat16, hd)
    fa.flash_attention_cuda(q, kv, kv, causal)
    ((kernel, entry, args),) = recorded_launches
    assert (kernel, entry) == ("flash_attention_bf16_mma", ENTRY)
    assert len(args) == len(_build.SIGNATURES[entry])       # stream last
    assert args[:3] == (q.data_ptr(), kv.data_ptr(), kv.data_ptr())
    assert args[4:9] == (1, 40, 4, 2, hd)
    assert args[9:18] == (40 * 4 * hd, 4 * hd, hd, 40 * 2 * hd, 2 * hd, hd,
                          40 * 2 * hd, 2 * hd, hd)
    assert args[18:20] == (int(causal), hd ** -0.5)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 16),
                                      (torch.float32, 32)])
def test_mma_route_is_bf16_at_16_and_32_only(dtype, hd):
    assert not fa.uses_bf16_mma(dtype, hd)


def test_bf16_mma_route_copies_what_cp_async_cannot_read(recorded_launches):
    """A view 2 bytes off a 16-byte boundary, and one whose head_dim stride
    is 2, are copied contiguous; a fused projection's aligned views go in
    place."""
    H, Hkv, hd = 4, 2, 32
    x = torch.zeros(1, 32, (H + 2 * Hkv) * hd, dtype=torch.bfloat16)
    q = x[..., :H * hd].unflatten(-1, (H, hd))
    k = x[..., H * hd:(H + Hkv) * hd].unflatten(-1, (Hkv, hd))
    v = x[..., (H + Hkv) * hd:].unflatten(-1, (Hkv, hd))
    flat = torch.zeros(32 * H * hd + 1, dtype=torch.bfloat16)
    off = flat[1:].view(1, 32, H, hd)
    wide = torch.zeros(1, 32, Hkv, 2 * hd, dtype=torch.bfloat16)[..., ::2]
    fa.flash_attention_cuda(q, k, v, True)
    fa.flash_attention_cuda(off, k, v, True)
    fa.flash_attention_cuda(q, k, wide, True)
    (_, _, inplace), (_, _, copied), (_, _, strided) = recorded_launches
    assert inplace[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert inplace[9:18] == (*q.stride()[:3], *k.stride()[:3],
                             *v.stride()[:3])
    assert copied[0] != off.data_ptr() and copied[0] % 16 == 0
    assert copied[9:12] == (32 * H * hd, H * hd, hd)
    assert copied[1:3] == (k.data_ptr(), v.data_ptr())
    assert strided[2] != wide.data_ptr()
    assert strided[15:18] == (32 * Hkv * hd, Hkv * hd, hd)


def test_bf16_mma_route_requires_card():
    q = torch.zeros(1, 32, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q, q, True)


def test_bf16_mma_failed_launch_raises_and_counts_nothing(monkeypatch):
    """A CUDA error from the C entry raises; the counter does not move and
    no other kernel is launched in its place."""
    monkeypatch.setattr(fa, "_require_card", lambda *ts: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    called = []

    class Library:
        def __getattr__(self, entry):
            return lambda *args: called.append(entry) or 700  # illegal addr

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    q = torch.zeros(1, 32, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match=ENTRY):
        fa.flash_attention_cuda(q, q, q, True)
    assert called == [ENTRY]
    assert set(_build.LAUNCHES.values()) == {0}
