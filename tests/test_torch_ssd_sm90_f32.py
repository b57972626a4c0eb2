"""The float32 tensor-core SSD-scan route (``csrc/ssd_scan_sm90_f32.cu``) on
the CPU.

The kernel runs only on the card, so its arithmetic is emulated here in
plain torch, phase by phase as the kernel does it: the within-chunk decay
summed in double, each difference rounded to float32 before exp;
chunk_state's S_c = (x o w)^T B, state_pass's float32 recurrence over the
chunks, and chunk_out's exp(cum) C H^T and M x with M = (C B^T) o L o dt.
Every product has two float32 operands, each split into three bf16 pieces,
and is issued as the six cross terms the kernel keeps (hi.lo, lo.hi,
mid.mid, hi.mid, mid.hi, hi.hi), in the kernel's chains: each 16-deep step
of a contraction sums its six terms from zero in the tensor core's
float32 accumulator, modelled as exact products whose running sum is
truncated to float32 after each term, and the step is then added to the
running float32 sum with a rounded add.  The emulation is held to the float32
``ssd_scan`` tier against the JAX package's sequential oracle on the same
numpy inputs (silu inputs, the model's), and to the float64 witness (the
tier scaled by the sum of |terms|) on signed inputs.  Cheaper splits are
shown to miss where the kernel's holds.  The float32 route's wrapper is
tested with the launch monkeypatched (the route table of all three routes
is ``tests/test_torch_ssd_sm90.py``'s dispatch test), and the float32 tiny
ssm configuration that takes the new route on the card (headdim 64, state
64, chunk 64) is held against the JAX package's fast path on the CPU.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.cluster import VirtualCluster as JCluster  # noqa: E402
from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.registry import tiny_config as j_tiny  # noqa: E402
from repro_torch.core.cluster import VirtualCluster  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models.registry import tiny_config  # noqa: E402

TIER = ops.TOLERANCE_TIERS["ssd_scan"]        # rtol 1e-4, atol 1e-5
PIECE = {"hi": 0, "mid": 1, "lo": 2}
#: the kernel's cross terms, in its order (smallest first)
KERNEL_TERMS = ("hi.lo", "lo.hi", "mid.mid", "hi.mid", "mid.hi", "hi.hi")
#: cheaper splits the kernel does not take
CHEAPER = {"no mid.mid": ("hi.lo", "lo.hi", "hi.mid", "mid.hi", "hi.hi"),
           "two pieces": ("mid.mid", "hi.mid", "mid.hi", "hi.hi")}
#: the float32 tiny ssm twin of chip_smoke.py phase 4: the smallest widths
#: of the tensor-core route, in float32
F32_SM90_SSM_TWIN = dict(dtype="float32", ssm_headdim=64, ssm_state=64,
                         ssm_chunk=64, num_layers=2)


def bf16_pieces(v):
    """v (float32) as the kernel's ``split3``: hi, mid, lo, each rounded to
    nearest even from what the earlier ones left, each remainder exact."""
    out = []
    for _ in PIECE:
        piece = v.bfloat16().float()
        out.append(piece)
        v = v - piece
    return out


def toward_zero(v):
    """float64 ``v`` as float32, rounded toward zero: the tensor core's
    float32 accumulator truncates."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def product(a, b, terms=KERNEL_TERMS, acc=None):
    """``acc`` (default 0) + a @ b as the kernel issues it: for each 16-deep
    step of the contraction, in order, the cross terms ``terms`` of the two
    operands' bf16 pieces summed from zero in one accumulator (each
    product exact, the sum truncated to float32 after each term), then
    added to the running float32 sum with a rounded add."""
    pa, pb = bf16_pieces(a), bf16_pieces(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 16):
        step = torch.zeros(out.shape, dtype=torch.float64)
        for term in terms:
            i, j = (PIECE[k] for k in term.split("."))
            step = toward_zero(step + pa[i][..., k0:k0 + 16].double()
                               @ pb[j][..., k0:k0 + 16, :].double()).double()
        out = out + step.float()
    return out


def emulate_f32_route(x, dt, A, B, C, chunk, terms=KERNEL_TERMS):
    """The float32 tensor-core kernel's arithmetic in plain torch.  x
    [b,s,h,p], B, C [b,s,g,n], dt [b,s,h], A [h], all float32; returns y
    [b,s,h,p] float32."""
    b, s, h, p = x.shape
    n = B.shape[3]
    nc = s // chunk

    def per_chunk(t, width):      # [b,s,heads,width] -> [b,h,nc,c,width]
        t = t.float().repeat_interleave(h // t.shape[2], 2)
        return t.reshape(b, nc, chunk, h, width).permute(0, 3, 1, 2, 4)

    xf, Bf, Cf = per_chunk(x, p), per_chunk(B, n), per_chunk(C, n)
    dtc = dt.float().reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    dA = dtc * A.float()[None, :, None, None]              # float32
    cum = torch.cumsum(dA.double(), dim=-1)                # double
    cum_last = cum[..., -1:]

    # chunk_state: S_c = (x o w)^T B
    w = dtc * torch.exp((cum_last - cum).float())
    S = product((xf * w[..., None]).transpose(-1, -2), Bf, terms)
    seg = torch.exp(cum_last[..., 0].float())              # [b,h,nc]

    # state_pass: H_0 = 0, H_{c+1} = seg_c H_c + S_c
    state = torch.zeros((b, h, p, n))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = seg[:, :, c, None, None] * state + S[:, :, c]
    H = torch.stack(entering, dim=2)

    # chunk_out: exp(cum_i) C_i H^T, then M x added to it step by step
    y = product(Cf, H.transpose(-1, -2), terms) \
        * torch.exp(cum.float())[..., None]
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    diff = torch.where(causal, cum[..., :, None] - cum[..., None, :],
                       torch.zeros((), dtype=torch.float64))
    M = product(Cf, Bf.transpose(-1, -2), terms) * torch.exp(diff.float()) \
        * dtc[..., None, :]
    M = torch.where(causal, M, torch.zeros(()))
    y = product(M, xf, terms, acc=y)
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)


@pytest.fixture
def one_thread():
    """CPU ``torch.exp`` split across threads has returned results many
    ulps off in some processes; one thread keeps it correctly rounded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, s, h, p, n, g, regime, act):
    """The card run's float32 inputs at a small size: x, B, C as views of
    one silu-activated (or signed normal) activation, and one of its two
    step-size regimes: dt of order 1 with |A| up to 16 (the state decays
    within a chunk), or dt in [1e-3, 1e-1] with |A| <= 1 (the state carries
    across chunks)."""
    rs = np.random.default_rng(seed)
    xBC = rs.standard_normal((1, s, h * p + 2 * g * n)).astype(np.float32)
    if act == "silu":
        xBC = xBC / (1 + np.exp(-xBC, dtype=np.float32))
    x = xBC[..., :h * p].reshape(1, s, h, p)
    B = xBC[..., h * p:h * p + g * n].reshape(1, s, g, n)
    C = xBC[..., h * p + g * n:].reshape(1, s, g, n)
    if regime == "typical":
        dt = np.log1p(np.exp(rs.standard_normal((1, s, h))))
        A = -np.linspace(1.0, 16.0, h)
    else:
        dt = 1e-3 + (1e-1 - 1e-3) * rs.random((1, s, h))
        A = -(0.05 + 0.95 * rs.random(h))
    return x, dt.astype(np.float32), A.astype(np.float32), B, C


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _witness_ratio(got, x, dt, A, Bh, Ch):
    """The largest error of ``got`` against the oracle in float64, as a
    share of the tier scaled by the sum of |terms| (the oracle on |x|,
    |B|, |C|)."""
    d = [t.double() for t in (x, dt, A, Bh, Ch)]
    y64 = ref.ssd_reference(*d)[0]
    terms = ref.ssd_reference(d[0].abs(), d[1], d[2], d[3].abs(),
                              d[4].abs())[0]
    err = (got.double() - y64).abs()
    return float((err / (TIER["atol"] + TIER["rtol"] * terms)).max())


@pytest.mark.parametrize("act", ["silu", "signed"])
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("regime", ["typical", "carried"])
def test_f32_emulation_within_tier(regime, g, chunk, act, one_thread):
    s, h, p, n = 512, 8, 64, 128
    x, dt, A, B, C = _inputs(s + chunk + 7 * g + (act == "silu"), s, h, p,
                             n, g, regime, act)
    tx, tdt, tA, tB, tC = _torch(x, dt, A, B, C)
    got = emulate_f32_route(tx, tdt, tA, tB, tC, chunk)
    assert got.dtype == torch.float32 and got.shape == (1, s, h, p)
    rep = h // g
    Bh, Ch = np.repeat(B, rep, 2), np.repeat(C, rep, 2)
    if act == "silu":
        want, _ = jref.ssd_reference(*map(jnp.asarray, (x, dt, A, Bh, Ch)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIER)
    else:
        # signed inputs cancel to y ~ 0 from terms in the hundreds: held to
        # the float64 witness, as chip_smoke.py holds the kernel
        assert _witness_ratio(got, tx, tdt, tA, *_torch(Bh, Ch)) <= 1.0


@pytest.mark.parametrize("p,n", [(16, 32), (32, 64)])
def test_f32_emulation_within_tier_at_narrow_widths(p, n, one_thread):
    s, h, g, chunk = 256, 4, 2, 64
    x, dt, A, B, C = _inputs(p + n, s, h, p, n, g, "typical", "silu")
    got = emulate_f32_route(*_torch(x, dt, A, B, C), chunk)
    want, _ = jref.ssd_reference(*map(jnp.asarray, (
        x, dt, A, np.repeat(B, h // g, 2), np.repeat(C, h // g, 2))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIER)


@pytest.mark.parametrize("cheaper", sorted(CHEAPER))
def test_cheaper_splits_miss_the_tier_where_the_kernels_holds(cheaper,
                                                               one_thread):
    """The reason for six cross terms of three pieces: at chunk 256 with
    order-1 steps y cancels from terms that sum to ~10-20, and dropping
    mid.mid (~2^-18 of a term), or splitting into two pieces, puts elements
    outside the ``ssd_scan`` tier of the JAX package's float32 oracle
    there; the kernel's split does not."""
    s, h, p, n, g, chunk = 512, 8, 64, 128, 1, 256
    arrays = _inputs(s + chunk + 7 * g + 1, s, h, p, n, g, "typical", "silu")
    x, dt, A, B, C = _torch(*arrays)
    want, _ = jref.ssd_reference(*map(jnp.asarray, (
        *arrays[:3], np.repeat(arrays[3], h, 2), np.repeat(arrays[4], h, 2))))
    want = torch.from_numpy(np.array(want)).double()
    tol = TIER["atol"] + TIER["rtol"] * want.abs()
    miss = {name: int(((emulate_f32_route(x, dt, A, B, C, chunk, terms)
                        .double() - want).abs() > tol).sum())
            for name, terms in (("kernel", KERNEL_TERMS),
                                (cheaper, CHEAPER[cheaper]))}
    assert miss["kernel"] == 0 and miss[cheaper] > 0


def test_pieces_hold_every_bit():
    rs = np.random.default_rng(1)
    v = torch.from_numpy(rs.standard_normal(10_000).astype(np.float32))
    hi, mid, lo = bf16_pieces(v)
    assert torch.equal(hi + mid + lo, v)
    for piece in (hi, mid, lo):
        assert torch.equal(piece, piece.bfloat16().float())
    assert bool((lo.abs() <= 2.0 ** -17 * v.abs()).all())


# ---------------------------------------------------------------------------
@pytest.fixture
def recorded_launches(monkeypatch):
    """Launch nothing: record (counter, entry, args) of each launch."""
    calls = []
    monkeypatch.setattr(ssd, "_require_card", lambda *ts: None)
    monkeypatch.setattr(ssd, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, entry, *args:
                        calls.append((kernel, entry, args)))
    return calls


def _views(s, h, p, g, n, dtype, pad=0, offset=0):
    """x, B, C as views of one [1, s, h*p + 2*g*n (+ pad)] activation, as
    the model hands them to the scan (``models/mamba.py``)."""
    width = h * p + 2 * g * n
    flat = torch.zeros(s * (width + pad) + offset, dtype=dtype)
    xBC = flat[offset:].view(1, s, width + pad)[..., :width]
    x = xBC[..., :h * p].reshape(1, s, h, p)
    B = xBC[..., h * p:h * p + g * n].reshape(1, s, g, n)
    C = xBC[..., h * p + g * n:].reshape(1, s, g, n)
    return x, torch.zeros(1, s, h), -torch.ones(h), B, C


def test_f32_route_takes_xbc_views_in_place(recorded_launches):
    """Float32 x, B and C as views of one activation reach the kernel with
    their own pointers and strides: no copy, no group broadcast; y is
    float32."""
    s, h, p, g, n = 512, 4, 64, 2, 128
    x, dt, A, B, C = _views(s, h, p, g, n, torch.float32)
    y = ssd.ssd_scan_cuda(x, dt, A, B, C, 256)
    assert y.shape == x.shape and y.dtype == torch.float32
    ((_, _, args),) = recorded_launches
    assert args[:5] == (x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr())
    assert args[10] is None                 # no final state: a null pointer
    assert args[11:18] == (1, s, h, g, p, n, 256)
    width = h * p + 2 * g * n
    assert args[18:21] == (s * width, width, p)              # x
    assert args[21:24] == dt.stride()
    assert args[24:27] == (s * width, width, n)              # B
    assert args[27:30] == (s * width, width, n)              # C


@pytest.mark.parametrize("what", ["row stride", "offset", "last stride"])
@pytest.mark.parametrize("operand", [0, 3, 4])
def test_f32_route_unaligned_view_raises(recorded_launches, what, operand):
    """A float32 view 16-byte cp.async cannot read raises: an activation
    row of 4 * (width + 1) bytes, a base 4 bytes off, a last stride of 2."""
    good = _views(256, 4, 64, 1, 128, torch.float32)
    bad = {"row stride": _views(256, 4, 64, 1, 128, torch.float32, pad=1),
           "offset": _views(256, 4, 64, 1, 128, torch.float32, offset=1)}
    if what == "last stride":
        wide = torch.zeros(1, 256, 4, 128)
        narrow = torch.zeros(1, 256, 1, 256)
        view = {0: wide[..., ::2], 3: narrow[..., ::2],
                4: narrow[..., ::2]}[operand]
    else:
        view = bad[what][operand]
    ins = list(good)
    ins[operand] = view
    assert ssd.uses_sm90_f32(view.dtype, 64, 128, 256)
    with pytest.raises(ValueError, match="ssd_scan_cuda"):
        ssd.ssd_scan_cuda(*ins, 256)
    assert recorded_launches == []


def test_failed_f32_launch_raises(monkeypatch):
    """A CUDA error from the float32 kernel raises and counts nothing; no
    other route runs in its place."""
    monkeypatch.setattr(ssd, "_require_card", lambda *ts: None)
    monkeypatch.setattr(ssd, "_stream", lambda t: 0)
    entries = []

    class Library:
        def __getattr__(self, entry):
            entries.append(entry)
            return lambda *args: 1                      # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    with pytest.raises(RuntimeError, match="repro_ssd_scan_sm90_f32 failed"):
        ssd.ssd_scan_cuda(*_views(256, 4, 64, 1, 128, torch.float32), 256)
    assert entries == ["repro_ssd_scan_sm90_f32"]
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
def test_f32_sm90_ssm_twin_vs_reference():
    """The float32 tiny ssm configuration of the card's phase 4 (headdim 64,
    state 64, chunk 64, seq 128), on the CPU against the JAX package's fast
    path from its exact initial weights, within the reference's
    kernel-consistency bounds, 3 steps."""
    kw = dict(global_batch=8, num_micro=2, seq_len=128)
    jr = JCluster(j_tiny("ssm", **F32_SM90_SSM_TWIN), 2, 2, **kw)
    cfg = tiny_config("ssm", **F32_SM90_SSM_TWIN)
    assert (cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk) == (64, 64, 64)
    assert ssd.uses_sm90_f32(cfg.torch_dtype, cfg.ssm_headdim, cfg.ssm_state,
                             cfg.ssm_chunk)
    cl = VirtualCluster(cfg, 2, 2, device="cpu", init_params=jax.tree.map(
        np.asarray, (jr.stem, jr.layer_params, jr.head)), **kw)
    for st, js in zip(cl.stages, jr.stages):
        assert st.entries == js.entries and st.sizes == js.sizes
        for c in ("master", "mu", "nu"):
            np.testing.assert_array_equal(st.flat[c].numpy(), js.flat[c])
    for step in range(3):
        a, b = cl.train_step(), jr.train_step()
        assert abs(a - b) <= KCC.LOSS_ATOL + KCC.LOSS_RTOL * abs(b), \
            (step, a, b)
        atol = KCC.PARAM_ATOL0 + 2.0 * jr.adam.lr * jr.opt_step
        for st, js in zip(cl.stages, jr.stages):
            for c in ("master", "mu", "nu"):
                np.testing.assert_allclose(st.full(c).numpy(), js.full(c),
                                           rtol=KCC.PARAM_RTOL, atol=atol)
    assert cl.opt_step == jr.opt_step == 3
