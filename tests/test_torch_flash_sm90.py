"""The tensor-core flash-attention route and the fused-AdamW wrapper on the
CPU.

``csrc/flash_attention_sm90.cu`` runs only on the card, so its arithmetic is
emulated here in plain torch, tile by tile as the kernel does it: float32
scores from bf16 q/k, the scale folded into exp2, an online softmax over
128-key tiles, and P.V on P split into two bf16 halves (rounded as the
kernel rounds them).  The emulation is
held to the ``flash_attention_bf16`` tier against the port's plain version
and against the JAX package's wrapper (Pallas in interpret mode) on the same
numpy inputs.  The dispatch between the CUDA routes and the wrappers'
argument checks are tested with the launch monkeypatched.
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
from repro_torch.kernels import fused_adam as fadam  # noqa: E402

BLOCK_N = 128
TIER = ops.TOLERANCE_TIERS["flash_attention_bf16"]


def bf16_round(x):
    """The kernel's ``bf16_round_bits``: float32 to bf16 (kept in float32),
    rounding to nearest with ties away from zero by an integer add."""
    return ((x.view(torch.int32) + 0x8000) & -0x10000).view(torch.float32)


def emulate_sm90(q, k, v, causal, split_p=True):
    """The tensor-core kernel's arithmetic in plain torch (float32 on the
    CPU): q [B,S,H,hd], k/v [B,S,Hkv,hd] bf16 -> [B,S,H,hd] bf16."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    qf = q.float().transpose(1, 2)                          # [B,H,S,hd]
    kf, vf = (t.float().repeat_interleave(rep, 2).transpose(1, 2)
              for t in (k, v))
    scale_log2 = torch.tensor(hd ** -0.5, dtype=torch.float32) \
        * torch.tensor(math.log2(math.e), dtype=torch.float32)
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S), -1e30)           # in the exp2 domain
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, BLOCK_N):
        keys = torch.arange(k0, k0 + BLOCK_N)[None, :]
        kt = torch.zeros((B, H, BLOCK_N, hd))
        vt = torch.zeros((B, H, BLOCK_N, hd))
        kt[:, :, :S - k0] = kf[:, :, k0:k0 + BLOCK_N]     # TMA zero fill
        vt[:, :, :S - k0] = vf[:, :, k0:k0 + BLOCK_N]
        s = qf @ kt.transpose(-1, -2)                     # raw q.k
        s = torch.where(keys >= S, -math.inf, s)
        if causal:
            s = torch.where(keys > rows, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = bf16_round(p)
        pv = p_hi @ vt
        if split_p:
            pv = pv + bf16_round(p - p_hi) @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.bfloat16().transpose(1, 2)


def _inputs(seed, S, H, Hkv, hd, qscale=1.0):
    rs = np.random.default_rng(seed)
    return [(rs.standard_normal((2, S, n, hd)) * sc).astype(np.float32)
            for n, sc in ((H, qscale), (Hkv, 1.0), (Hkv, 1.0))]


def _within(a, b, tier=TIER):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, **tier)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_sm90_emulation_within_bf16_tier(hd, causal, H, Hkv):
    q, k, v = _inputs(10 + hd + H * Hkv + causal, 256, H, Hkv, hd)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = emulate_sm90(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _within(got.float(), ref.gqa_attention_reference(tq, tk, tv,
                                                     causal=causal).float())
    want = jops.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                  for a in (q, k, v)), causal=causal)
    _within(got.float(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("S", [200, 300])
def test_sm90_emulation_ragged_sequence(S):
    """S not a multiple of the 128-key tile: zero-filled keys masked."""
    q, k, v = _inputs(S, S, 4, 2, 64)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    for causal in (True, False):
        _within(emulate_sm90(tq, tk, tv, causal).float(),
                ref.gqa_attention_reference(tq, tk, tv,
                                            causal=causal).float())


def test_bf16_round_matches_torch_away_from_ties():
    rs = np.random.default_rng(0)
    x = torch.from_numpy(rs.standard_normal(10_000).astype(np.float32))
    assert torch.equal(bf16_round(x), x.bfloat16().float())
    tie = torch.tensor([1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8)])
    assert bf16_round(tie).tolist() == [1.0 + 2.0 ** -7,
                                        -(1.0 + 2.0 ** -6)]


def test_split_p_is_closer_to_fp32_p_than_one_rounding():
    """The reason P goes through P.V as two bf16 halves: on a peaked
    softmax (q x 4) one rounding of P moves the output much further from
    the float32 reference than the split does."""
    q, k, v = _inputs(7, 256, 4, 4, 128, qscale=4.0)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    exact = ref.gqa_attention_reference(tq.float(), tk.float(), tv.float(),
                                        causal=True)
    err = {split: float((emulate_sm90(tq, tk, tv, True, split).float()
                         - exact).abs().max()) for split in (True, False)}
    assert err[True] < err[False]
    _within(emulate_sm90(tq, tk, tv, True).float(),
            ref.gqa_attention_reference(tq, tk, tv, causal=True).float())


@pytest.fixture
def recorded_launches(monkeypatch):
    """Launch nothing: record (counters, entry, args) of each launch."""
    calls = []
    for mod in (fa, fadam):
        monkeypatch.setattr(mod, "_require_card", lambda *ts: None)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, entry, *args:
                        calls.append((kernel, entry, args)))
    return calls


@pytest.mark.parametrize("dtype,hd,entry", [
    (torch.bfloat16, 128, "repro_flash_attention_sm90"),
    (torch.bfloat16, 64, "repro_flash_attention_sm90"),
    (torch.float32, 128, "repro_flash_attention_tf32"),
    (torch.float32, 64, "repro_flash_attention_tf32"),
    (torch.bfloat16, 32, "repro_flash_attention_bf16_mma"),
    (torch.bfloat16, 16, "repro_flash_attention_bf16_mma"),
])
def test_flash_dispatch_by_dtype_and_head_dim(recorded_launches, dtype, hd,
                                              entry):
    q = torch.zeros(1, 32, 4, hd, dtype=dtype)
    kv = torch.zeros(1, 32, 2, hd, dtype=dtype)
    fa.flash_attention_cuda(q, kv, kv, True)
    ((kernel, got, args),) = recorded_launches
    assert got == entry
    assert kernel == entry[len("repro_"):]     # one counter per kernel
    assert len(args) == len(_build.SIGNATURES[entry])      # stream last
    # every route: strides pass through; causal, scale
    assert args[9:18] == (32 * 4 * hd, 4 * hd, hd,
                          32 * 2 * hd, 2 * hd, hd,
                          32 * 2 * hd, 2 * hd, hd)
    assert args[18:20] == (1, hd ** -0.5)


def test_flash_sm90_takes_projection_views_in_place(recorded_launches):
    """q, k, v as views of one fused projection, as a model may hand them:
    strides reach the kernel unchanged, no copy."""
    H, Hkv, hd = 4, 2, 128
    x = torch.zeros(2, 32, (H + 2 * Hkv) * hd, dtype=torch.bfloat16)
    q = x[..., :H * hd].unflatten(-1, (H, hd))
    k = x[..., H * hd:(H + Hkv) * hd].unflatten(-1, (Hkv, hd))
    v = x[..., (H + Hkv) * hd:].unflatten(-1, (Hkv, hd))
    fa.flash_attention_cuda(q, k, v, True)
    ((_, _, args),) = recorded_launches
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[9:12] == q.stride()[:3]


def _bad_views():
    hd = 128
    odd_row = torch.zeros(1, 32, 4 * hd + 4, dtype=torch.bfloat16)
    flat = torch.zeros(32 * 4 * hd + 8, dtype=torch.bfloat16)
    wide = torch.zeros(1, 32, 4, 2 * hd, dtype=torch.bfloat16)
    return {
        "stride": odd_row[..., :4 * hd].unflatten(-1, (4, hd)),
        "offset": flat[1:1 + 32 * 4 * hd].view(1, 32, 4, hd),
        "head_dim stride": wide[..., ::2],
    }


@pytest.mark.parametrize("what", ["stride", "offset", "head_dim stride"])
@pytest.mark.parametrize("operand", [0, 1])
def test_flash_sm90_unsupported_layout_raises(recorded_launches, what,
                                              operand):
    good = torch.zeros(1, 32, 4, 128, dtype=torch.bfloat16)
    ops_ = [good, good, good]
    ops_[operand] = _bad_views()[what]
    with pytest.raises(ValueError, match="flash_attention_cuda"):
        fa.flash_attention_cuda(*ops_, True)
    assert recorded_launches == []


def test_flash_counts_each_route_under_its_own_kernel(monkeypatch):
    """Each flash kernel has one counter, added to where it launches: the
    tensor-core launches (bf16 and float32) do not show under
    ``flash_attention``, which ``flash_attention_cuda`` no longer reaches."""
    monkeypatch.setattr(fa, "_require_card", lambda *ts: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)

    class Library:
        def __getattr__(self, entry):
            return lambda *args: 0                      # cudaSuccess

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    for dtype, hd, n in ((torch.bfloat16, 128, 3), (torch.float32, 128, 2),
                         (torch.bfloat16, 32, 1)):
        q = torch.zeros(1, 32, 4, hd, dtype=dtype)
        for _ in range(n):
            fa.flash_attention_cuda(q, q, q, True)
    assert _build.LAUNCHES == {"rmsnorm": 0, "flash_attention": 0,
                               "fused_adam": 0, "ssd_scan": 0,
                               "flash_attention_sm90": 3,
                               "ssd_scan_sm90": 0,
                               "flash_attention_tf32": 2,
                               "ssd_scan_sm90_f32": 0,
                               "flash_attention_bf16_mma": 1,
                               "threefry_dropout": 0}


def test_flash_requires_card():
    q = torch.zeros(1, 32, 4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q, q, True)


def test_fused_adam_wrapper_takes_unaligned_views(recorded_launches):
    bufs = [torch.zeros(101) for _ in range(4)]
    views = [b[1:] for b in bufs]
    fadam.fused_adam_cuda_(*views, ops.adam_scalars(1, b1=0.9, b2=0.95,
                                                    eps=1e-8, lr=3e-4,
                                                    weight_decay=0.1))
    ((kernels, entry, args),) = recorded_launches
    assert (kernels, entry) == ("fused_adam", "repro_fused_adam")
    assert args[:5] == (*(v.data_ptr() for v in views), 100)


@pytest.mark.parametrize("bad", ["dtype", "2-D", "size", "strided"])
def test_fused_adam_wrapper_rejects(recorded_launches, bad):
    good = [torch.zeros(64) for _ in range(4)]
    good[2] = {"dtype": torch.zeros(64, dtype=torch.float64),
               "2-D": torch.zeros(8, 8),
               "size": torch.zeros(63),
               "strided": torch.zeros(128)[::2]}[bad]
    sc = ops.adam_scalars(1, b1=0.9, b2=0.95, eps=1e-8, lr=3e-4,
                          weight_decay=0.1)
    with pytest.raises(ValueError, match="contiguous 1-D float32"):
        fadam.fused_adam_cuda_(*good, sc)
    assert recorded_launches == []


def test_fused_adam_wrapper_requires_card():
    t = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fadam.fused_adam_cuda_(t, t, t, t, {})
