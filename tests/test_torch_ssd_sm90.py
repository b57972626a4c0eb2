"""The tensor-core SSD-scan route on the CPU.

``csrc/ssd_scan_sm90.cu`` runs only on the card, so its arithmetic is
emulated here in plain torch, phase by phase as the kernel does it: the
within-chunk decay summed in double, each difference rounded to float32
before exp; chunk_state's S_c = (x o w)^T B with x o w split into three
bf16 pieces; state_pass's float32 recurrence over the chunks, each entering
state split into three bf16 pieces; chunk_out's M = (C B^T) o L o dt split
into three bf16 pieces against x, plus exp(cum) C H^T; y rounded once to
bf16.  The emulation is held to the ``ssd_scan_bf16`` tier against the JAX
package's sequential oracle on the same numpy inputs.  The dispatch among
the CUDA routes and the wrapper's argument checks are tested with the
launch monkeypatched.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

TIER = ops.TOLERANCE_TIERS["ssd_scan_bf16"]     # rtol 1e-2, atol 1e-5
SPLIT_OPERANDS = ("xw", "M", "H")
KERNEL_PIECES = 3


def bf16_pieces(v, k=KERNEL_PIECES):
    """v (float32) as the sum of k bf16 pieces, as the kernel's ``split3``
    (k = 3): each piece rounded to nearest even from what the earlier ones
    left, each remainder exact."""
    out = torch.zeros_like(v)
    for _ in range(k):
        piece = v.bfloat16().float()
        out, v = out + piece, v - piece
    return out


def emulate_ssd_sm90_f32(x, dt, A, B, C, chunk, pieces=None):
    """The tensor-core kernel's arithmetic in plain torch, y in float32
    before its rounding to bf16.  x [b,s,h,p], B, C [b,s,g,n] (bf16 values);
    dt [b,s,h], A [h] float32.  ``pieces`` maps operands of
    ``SPLIT_OPERANDS`` to a number of bf16 pieces other than the kernel's."""
    k = dict.fromkeys(SPLIT_OPERANDS, KERNEL_PIECES) | dict(pieces or {})
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
    xw = bf16_pieces(xf * w[..., None], k["xw"])
    S = xw.transpose(-1, -2) @ Bf                          # [b,h,nc,p,n]
    seg = torch.exp(cum_last[..., 0].float())              # [b,h,nc]

    # state_pass: H_0 = 0, H_{c+1} = seg_c H_c + S_c
    state = torch.zeros((b, h, p, n))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = seg[:, :, c, None, None] * state + S[:, :, c]
    H = bf16_pieces(torch.stack(entering, dim=2), k["H"])

    # chunk_out: exp(cum_i) C_i H^T, then M x
    y = (Cf @ H.transpose(-1, -2)) * torch.exp(cum.float())[..., None]
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    diff = torch.where(causal, cum[..., :, None] - cum[..., None, :],
                       torch.zeros((), dtype=torch.float64))
    Mm = (Cf @ Bf.transpose(-1, -2)) * torch.exp(diff.float()) \
        * dtc[..., None, :]
    Mm = torch.where(causal, Mm, torch.zeros(()))
    y = y + bf16_pieces(Mm, k["M"]) @ xf
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)


def emulate_ssd_sm90(x, dt, A, B, C, chunk):
    """As the kernel returns it: y [b,s,h,p] in bf16."""
    return emulate_ssd_sm90_f32(x, dt, A, B, C, chunk).bfloat16()


@pytest.fixture
def one_thread():
    """CPU ``torch.exp`` split across threads has returned results many
    ulps off in some processes; one thread keeps it correctly rounded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, s, h, p, n, g, regime):
    """The card run's inputs at a small size: silu-activated x, B, C as
    bf16 values (in float32 arrays), and one of its two step-size regimes:
    dt of order 1 with |A| up to 16 (the state decays within a chunk), or
    dt in [1e-3, 1e-1] with |A| <= 1 (the state carries across chunks)."""
    rs = np.random.default_rng(seed)
    xBC = rs.standard_normal((1, s, h * p + 2 * g * n)).astype(np.float32)
    xBC = torch.from_numpy(xBC)
    xBC = (xBC * torch.sigmoid(xBC)).bfloat16().float().numpy()
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


@pytest.mark.parametrize("regime", ["typical", "carried"])
@pytest.mark.parametrize("n", [32, 128])
@pytest.mark.parametrize("p", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("s", [256, 512])
def test_sm90_emulation_within_bf16_tier(s, chunk, g, p, n, regime,
                                         one_thread):
    h = 4
    x, dt, A, B, C = _inputs(s + chunk + 7 * g + p + n, s, h, p, n, g,
                             regime)
    tx, tdt, tA, tB, tC = _torch(x, dt, A, B, C)
    got = emulate_ssd_sm90(tx.bfloat16(), tdt, tA, tB.bfloat16(),
                           tC.bfloat16(), chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (1, s, h, p)
    rep = h // g
    want, _ = jref.ssd_reference(*map(jnp.asarray, (
        x, dt, A, np.repeat(B, rep, 2), np.repeat(C, rep, 2))))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **TIER)


@pytest.mark.parametrize("operand", SPLIT_OPERANDS)
def test_each_split_piece_brings_y_closer_to_exact(operand, one_thread):
    """The reason each float32 operand goes through the tensor cores as
    three bf16 pieces: rounded once, it moves y (before y's own rounding)
    far from the exact result; two pieces (~2^-18 of each term) still miss
    the tier where y cancels; three keep the operand's float32 value."""
    h, g, p, n, chunk = 4, 1, 64, 128, 64
    x, dt, A, B, C = _torch(*_inputs(3, 256, h, p, n, g, "carried"))
    exact = ref.ssd_reference(*(t.double() for t in (
        x, dt, A, B.repeat_interleave(h, 2), C.repeat_interleave(h, 2))))[0]
    err = {k: float((emulate_ssd_sm90_f32(
        x, dt, A, B, C, chunk, {operand: k}).double() - exact).abs().max())
        for k in (1, 2, 3)}
    assert err[3] < err[2] < err[1] / 16


def test_two_pieces_of_m_miss_the_tier_where_three_hold(one_thread):
    """At chunk 128 with order-1 steps, y cancels to ~2e-4 from terms that
    sum to ~18: M in two bf16 pieces misses ``ssd_scan_bf16`` there, the
    kernel's three pieces do not."""
    h, g, p, n, s, chunk = 4, 2, 64, 128, 256, 128
    x, dt, A, B, C = _torch(*_inputs(s + chunk + 7 * g + p + n, s, h, p, n,
                                     g, "typical"))
    exact = ref.ssd_reference(*(t.double() for t in (
        x, dt, A, B.repeat_interleave(2, 2), C.repeat_interleave(2, 2))))[0]
    tol = TIER["atol"] + TIER["rtol"] * exact.abs()
    miss = {k: int(((emulate_ssd_sm90_f32(
        x, dt, A, B, C, chunk, {"M": k}).bfloat16().double() - exact).abs()
        > tol).sum()) for k in (2, 3)}
    assert miss[2] > 0 and miss[3] == 0


def test_pieces_round_to_nearest_even():
    rs = np.random.default_rng(0)
    v = torch.from_numpy(rs.standard_normal(10_000).astype(np.float32))
    assert torch.equal(bf16_pieces(v, 1), v.bfloat16().float())
    assert bool(((v - bf16_pieces(v, 2)).abs() <= 2.0 ** -17 * v.abs()).all())
    assert torch.equal(bf16_pieces(v, 3), v)
    tie = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])
    assert bf16_pieces(tie, 1).tolist() == [1.0, 1.0 + 2.0 ** -6]


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


@pytest.mark.parametrize("dtype,p,n,chunk,entry", [
    (torch.bfloat16, 64, 128, 256, "repro_ssd_scan_sm90"),
    (torch.bfloat16, 16, 32, 64, "repro_ssd_scan_sm90"),
    (torch.float32, 64, 128, 256, "repro_ssd_scan_sm90_f32"),
    (torch.float32, 64, 64, 64, "repro_ssd_scan_sm90_f32"),
    (torch.float32, 16, 32, 128, "repro_ssd_scan_sm90_f32"),
    (torch.float32, 16, 16, 8, "repro_ssd_scan"),
    (torch.float32, 64, 128, 32, "repro_ssd_scan"),
    (torch.float32, 128, 128, 256, "repro_ssd_scan"),
    (torch.float32, 64, 24, 256, "repro_ssd_scan"),
    (torch.bfloat16, 64, 64, 64, "repro_ssd_scan_sm90"),
    (torch.bfloat16, 16, 16, 8, "repro_ssd_scan"),
    (torch.bfloat16, 128, 128, 256, "repro_ssd_scan"),
    (torch.bfloat16, 24, 128, 256, "repro_ssd_scan"),
    (torch.bfloat16, 64, 24, 256, "repro_ssd_scan"),
    (torch.bfloat16, 64, 128, 32, "repro_ssd_scan"),
    (torch.float32, 8, 6, 8, "repro_ssd_scan"),
    (torch.float32, 24, 20, 24, "repro_ssd_scan"),
    (torch.float32, 40, 24, 96, "repro_ssd_scan"),
    (torch.float32, 128, 32, 32, "repro_ssd_scan"),
    (torch.float32, 17, 5, 7, "repro_ssd_scan"),
    (torch.bfloat16, 24, 20, 24, "repro_ssd_scan"),
    (torch.bfloat16, 40, 24, 96, "repro_ssd_scan"),
    (torch.bfloat16, 128, 32, 32, "repro_ssd_scan"),
])
def test_ssd_dispatch_by_dtype_and_widths(recorded_launches, dtype, p, n,
                                          chunk, entry):
    h, g = 4, 1
    ins = _views(256, h, p, g, n, dtype)
    ssd.ssd_scan_cuda(*ins, chunk)
    ((kernel, got, args),) = recorded_launches
    assert got == entry
    assert kernel == entry.removeprefix("repro_")
    assert len(args) == len(_build.SIGNATURES[entry])      # stream last
    assert ssd.uses_sm90(dtype, p, n, chunk) == entry.endswith("sm90")
    assert ssd.uses_sm90_f32(dtype, p, n, chunk) == entry.endswith("f32")


def test_ssd_sm90_takes_xbc_views_in_place(recorded_launches):
    """x, B and C as views of one activation reach the kernel with their
    own pointers and strides: no copy, no group broadcast."""
    s, h, p, g, n = 512, 4, 64, 2, 128
    x, dt, A, B, C = _views(s, h, p, g, n, torch.bfloat16)
    y = ssd.ssd_scan_cuda(x, dt, A, B, C, 256)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    ((_, _, args),) = recorded_launches
    assert args[:5] == (x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr())
    assert args[10:17] == (1, s, h, g, p, n, 256)
    width = h * p + 2 * g * n
    assert args[17:20] == (s * width, width, p)              # x
    assert args[20:23] == dt.stride()
    assert args[23:26] == (s * width, width, n)              # B
    assert args[26:29] == (s * width, width, n)              # C


@pytest.mark.parametrize("what", ["row stride", "offset", "last stride"])
@pytest.mark.parametrize("operand", [0, 3, 4])
def test_ssd_sm90_unaligned_view_raises(recorded_launches, what, operand):
    good = _views(256, 4, 64, 1, 128, torch.bfloat16)
    bad = {"row stride": _views(256, 4, 64, 1, 128, torch.bfloat16, pad=4),
           "offset": _views(256, 4, 64, 1, 128, torch.bfloat16, offset=1)}
    if what == "last stride":
        wide = torch.zeros(1, 256, 4, 128, dtype=torch.bfloat16)
        narrow = torch.zeros(1, 256, 1, 256, dtype=torch.bfloat16)
        view = {0: wide[..., ::2], 3: narrow[..., ::2],
                4: narrow[..., ::2]}[operand]
    else:
        view = bad[what][operand]
    ins = list(good)
    ins[operand] = view
    assert ssd.uses_sm90(view.dtype, 64, 128, 256)
    with pytest.raises(ValueError, match="ssd_scan_cuda"):
        ssd.ssd_scan_cuda(*ins, 256)
    assert recorded_launches == []


def test_ssd_counts_each_route_under_its_own_kernel(monkeypatch):
    monkeypatch.setattr(ssd, "_require_card", lambda *ts: None)
    monkeypatch.setattr(ssd, "_stream", lambda t: 0)

    class Library:
        def __getattr__(self, entry):
            return lambda *args: 0                      # cudaSuccess

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    for dtype, times in ((torch.bfloat16, 3), (torch.float32, 2)):
        for _ in range(times):
            ssd.ssd_scan_cuda(*_views(256, 4, 64, 1, 128, dtype), 256)
    ssd.ssd_scan_cuda_cores(*_views(256, 4, 64, 1, 128, torch.bfloat16),
                            256)
    assert _build.LAUNCHES["ssd_scan_sm90"] == 3
    assert _build.LAUNCHES["ssd_scan_sm90_f32"] == 2
    assert _build.LAUNCHES["ssd_scan"] == 1
    assert sum(_build.LAUNCHES.values()) == 6


def test_ssd_requires_card():
    ins = _views(256, 4, 64, 1, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd.ssd_scan_cuda(*ins, 256)
