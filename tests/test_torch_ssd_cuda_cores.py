"""The CUDA-core SSD-scan route (``csrc/ssd_scan.cu``) on the CPU.

The kernel runs only on the card, so its decomposition is emulated here in
float32 torch, at widths only this route takes: rows in groups of
``group_chunks(chunk)`` chunks (at most 64 rows, or one chunk above 64),
the decay's running sums over a group in double, each difference rounded
to float32 before exp; chunk_state's per-group state part and decay;
the state pass over groups, each multiply and add rounded as the kernel's
``__fmul_rn``/``__fadd_rn``; and chunk_out, which walks a group's chunks
in order from the group's entering state (the intra-chunk term over each
chunk's own pairs, then the state update).  The emulation is held to the
``ssd_scan`` tier against the JAX package's ``ops.ssd_scan`` (its Pallas
kernel in interpret mode) on the same numpy inputs.  The wrapper's
workspace sizes, its group count and its failure path are tested with the
launch monkeypatched, and the bound ``chip_smoke.py`` holds it to by hand.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TIER = ops.TOLERANCE_TIERS["ssd_scan"]          # rtol 1e-4, atol 1e-5


def emulate_cuda_cores(x, dt, A, B, C, chunk):
    """y [b,s,h,p] in float32 as ``ssd_scan.cu`` computes it.  x [b,s,h,p],
    B, C [b,s,g,n]; dt [b,s,h], A [h] float32."""
    b, s, h, p = x.shape
    n = B.shape[3]
    k = ssd.group_chunks(chunk)
    R = k * chunk
    ng = -(-(s // chunk) // k)
    pad = ng * R - s              # the last group's missing chunks: zeros

    def grouped(t, width):        # [b,s,heads,width] -> [b,h,ng,R,width]
        t = F.pad(t.float().repeat_interleave(h // t.shape[2], 2),
                  (0, 0, 0, 0, 0, pad))
        return t.reshape(b, ng, R, h, width).permute(0, 3, 1, 2, 4)

    xf, Bf, Cf = grouped(x, p), grouped(B, n), grouped(C, n)
    dtg = F.pad(dt.float(), (0, 0, 0, pad)).reshape(b, ng, R, h) \
        .permute(0, 3, 1, 2)
    dA = dtg * A.float()[None, :, None, None]            # float32
    G = torch.cumsum(dA.double(), dim=-1)                # double, a group

    # chunk_state: S_g = sum_j x_j w_j B_j^T, w_j = dt_j exp(G_last - G_j)
    w = dtg * torch.exp((G[..., -1:] - G).float())
    S = (xf * w[..., None]).transpose(-1, -2) @ Bf       # [b,h,ng,p,n]
    seg = torch.exp(G[..., -1].float())                  # [b,h,ng]

    # state pass: H_0 = 0, H_{g+1} = seg_g H_g + S_g, multiply, then add
    H = torch.zeros_like(S)
    state = torch.zeros_like(S[:, :, 0])
    for gi in range(ng):
        H[:, :, gi] = state
        state = seg[:, :, gi, None, None] * state + S[:, :, gi]

    # chunk_out: a group's chunks in order from its entering state
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    zero64 = torch.zeros((), dtype=torch.float64)
    ys, state = [], H
    for kk in range(k):
        rows = slice(kk * chunk, (kk + 1) * chunk)
        Gk = G[..., rows]
        base = G[..., kk * chunk - 1:kk * chunk] if kk else \
            torch.zeros_like(Gk[..., :1])
        Ck, Bk, xk, dk = Cf[..., rows, :], Bf[..., rows, :], \
            xf[..., rows, :], dtg[..., rows]
        y = torch.exp((Gk - base).float())[..., None] \
            * (Ck @ state.transpose(-1, -2))
        diff = torch.where(causal, Gk[..., :, None] - Gk[..., None, :],
                           zero64)
        M = torch.where(causal, (Ck @ Bk.transpose(-1, -2))
                        * torch.exp(diff.float()) * dk[..., None, :],
                        torch.zeros(()))
        ys.append(y + M @ xk)
        if kk + 1 < k:
            wv = dk * torch.exp((Gk[..., -1:] - Gk).float())
            U = (xk * wv[..., None]).transpose(-1, -2) @ Bk
            sg = torch.exp((Gk[..., -1:] - base).float())[..., None]
            state = sg * state + U
    y = torch.cat(ys, dim=-2).reshape(b, h, ng * R, p)[:, :, :s]
    return y.permute(0, 2, 1, 3)


@pytest.fixture
def one_thread():
    """CPU ``torch.exp`` split across threads has returned results many
    ulps off in some processes; one thread keeps it correctly rounded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, s, h, p, n, g, regime):
    """Silu-activated x, B, C (the model's inputs to the scan) and one of
    two step-size regimes: dt of order 1 with |A| up to 16 (the state
    decays within a chunk), or dt in [1e-3, 1e-1] with |A| <= 1 (the state
    carries across groups)."""
    rs = np.random.default_rng(seed)
    xBC = rs.standard_normal((1, s, h * p + 2 * g * n))
    xBC = (xBC / (1.0 + np.exp(-xBC))).astype(np.float32)
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


# (p, n, chunk, g, s): chunk 8 in groups of 8 (the tiny configs' widths);
# n 6 with two B/C groups; chunk 24 (does not divide 64: groups of 2, the
# last one short); chunk 96 (above 64, not a multiple of it: one a group,
# 64- and 32-row tiles); p 128 in groups of 2 chunks of 32, the last short.
# p*n is not a multiple of 4 in the second and third.
WIDTHS = [(16, 16, 8, 1, 192), (8, 6, 8, 2, 192), (24, 20, 24, 1, 120),
          (40, 24, 96, 1, 192), (128, 32, 32, 1, 160)]


@pytest.mark.parametrize("regime", ["typical", "carried"])
@pytest.mark.parametrize("p,n,chunk,g,s", WIDTHS)
def test_emulation_within_tier_of_the_reference(p, n, chunk, g, s, regime,
                                                one_thread):
    h = 4
    assert not ssd.uses_sm90_f32(torch.float32, p, n, chunk)
    x, dt, A, B, C = _inputs(p + n + chunk + g, s, h, p, n, g, regime)
    got = emulate_cuda_cores(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (x, dt, A, B, C)), chunk)
    want, _ = jops.ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk)
    assert got.shape == (1, s, h, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIER)


def test_groups_hold_a_state_each_not_a_chunk(one_thread):
    """At chunk 8 a group holds 8 chunks: the emulation through groups
    equals, within the tier, the same scan walked one chunk at a time
    (``ref.ssd_chunked``, the reference's chunked form)."""
    h, p, n, g, s, chunk = 4, 16, 16, 1, 256, 8
    x, dt, A, B, C = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                      _inputs(7, s, h, p, n, g, "carried"))
    got = emulate_cuda_cores(x, dt, A, B, C, chunk)
    want, _ = ref.ssd_chunked(x, dt, A, B, C, chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TIER)


@pytest.mark.parametrize("chunk,chunks", [
    (1, 64), (7, 9), (8, 8), (24, 2), (32, 2), (33, 1), (63, 1), (64, 1),
    (65, 1), (96, 1), (256, 1)])
def test_group_chunks(chunk, chunks):
    assert ssd.group_chunks(chunk) == chunks
    assert chunks * chunk <= max(64, chunk)


# (b, s, h, g, p, n, chunk) -> (states' elements, decays, C.B^T elements)
WORKSPACES = [
    ((1, 4096, 320, 1, 16, 16, 8), (320 * 64 * 256, 320 * 64, 0)),
    ((2, 120, 4, 2, 24, 20, 24), (2 * 4 * 3 * 480, 2 * 4 * 3, 0)),
    ((1, 140, 3, 1, 17, 5, 7), (3 * 3 * 88, 3 * 3, 0)),
    ((1, 4096, 80, 1, 64, 128, 256), (80 * 16 * 8192, 80 * 16,
                                      16 * 10 * 4096)),
    ((1, 384, 2, 1, 3, 5, 96), (2 * 4 * 16, 2 * 4, 4 * 3 * 4096)),
    ((2, 400, 4, 2, 130, 128, 200), (2 * 4 * 2 * 16640, 2 * 4 * 2,
                                     2 * 2 * 2 * 10 * 4096)),
]


@pytest.mark.parametrize("dims,sizes", WORKSPACES)
def test_workspace_sizes(recorded_launches, monkeypatch, dims, sizes):
    """``cuda_core_workspace`` by hand, and the wrapper allocates exactly
    those three float32 buffers beside y."""
    b, s, h, g, p, n, chunk = dims
    assert ssd.cuda_core_workspace(b, s, h, g, p, n, chunk) == sizes
    made = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        made.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(ssd.torch, "empty", spy)
    x = torch.zeros(b, s, h, p)
    BC = torch.zeros(b, s, g, n)
    ssd.ssd_scan_cuda_cores(x, torch.zeros(b, s, h), -torch.ones(h), BC, BC,
                            chunk)
    assert made == [((b, s, h, p), torch.float32)] + [
        ((k,), torch.float32) for k in sizes]
    ((_, entry, args),) = recorded_launches
    assert entry == "repro_ssd_scan"
    assert len(args) == len(_build.SIGNATURES[entry])
    assert args[9:16] == (b, s, h, g, p, n, chunk)


@pytest.fixture
def recorded_launches(monkeypatch):
    """Launch nothing: record (counter, entry, args) of each launch; the
    plain versions raise, so that a CUDA-bound call cannot reach them."""
    calls = []
    monkeypatch.setattr(ssd, "_require_card", lambda *ts: None)
    monkeypatch.setattr(ssd, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda kernel, entry, *args:
                        calls.append((kernel, entry, args)))

    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ref, "ssd_reference", plain)
    monkeypatch.setattr(ref, "ssd_chunked", plain)
    return calls


def _views(s, h, p, g, n, dtype=torch.float32):
    """x, dt, A, B, C with x, B, C as views of one activation."""
    xBC = torch.zeros(1, s, h * p + 2 * g * n, dtype=dtype)
    x = xBC[..., :h * p].reshape(1, s, h, p)
    B = xBC[..., h * p:h * p + g * n].reshape(1, s, g, n)
    C = xBC[..., h * p + g * n:].reshape(1, s, g, n)
    return x, torch.zeros(1, s, h), -torch.ones(h), B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_failed_launch_raises(monkeypatch, dtype):
    """A launch that fails raises out of the wrapper and counts nothing;
    no other route or plain version takes over."""
    monkeypatch.setattr(ssd, "_require_card", lambda *ts: None)
    monkeypatch.setattr(ssd, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))

    def refused(kernel, entry, *args):
        raise RuntimeError(f"{entry} failed: CUDA error 1")

    monkeypatch.setattr(_build, "launch", refused)
    with pytest.raises(RuntimeError, match="repro_ssd_scan failed"):
        ssd.ssd_scan_cuda(*_views(192, 4, 16, 1, 16, dtype), 8)
    assert sum(_build.LAUNCHES.values()) == 0


def test_nonzero_cuda_error_raises(monkeypatch):
    """The C entry's nonzero return (here cudaErrorLaunchFailure) is raised
    by ``_build.launch`` before the launch is counted."""
    monkeypatch.setattr(ssd, "_require_card", lambda *ts: None)
    monkeypatch.setattr(ssd, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))

    class Library:
        def __getattr__(self, entry):
            return lambda *args: 719

    monkeypatch.setattr(_build, "library", Library)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        ssd.ssd_scan_cuda_cores(*_views(96, 2, 40, 1, 24), 96)
    assert _build.LAUNCHES["ssd_scan"] == 0


def test_views_reach_the_kernel_in_place(recorded_launches):
    """x, B and C as views of one activation reach the kernel with their
    own pointers and strides, one launch of ``ssd_scan`` for its kernels."""
    s, h, p, g, n = 192, 4, 16, 1, 16
    x, dt, A, B, C = _views(s, h, p, g, n)
    y = ssd.ssd_scan_cuda(x, dt, A, B, C, 8)
    assert y.shape == x.shape and y.dtype == x.dtype
    ((kernel, _, args),) = recorded_launches
    assert kernel == "ssd_scan"
    assert args[:5] == (x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr())
    width = h * p + 2 * g * n
    assert args[16:19] == (s * width, width, p)              # x
    assert args[22:25] == (s * width, width, n)              # B
    assert args[25:28] == (s * width, width, n)              # C


# (b, s, h, g, p, n, chunk, bytes an element) -> (bytes, flops) by hand,
# at the yardsticks main, narrow and wide and main with 8 B/C groups
BOUNDS = [
    ((1, 4096, 80, 1, 64, 128, 256, 4), (173_277_504, 16_261_840_896)),
    ((1, 4096, 320, 1, 16, 16, 8, 4), (173_540_608, 1_531_510_784)),
    ((1, 4096, 40, 1, 128, 128, 256, 4), (172_621_984, 16_261_840_896)),
    ((1, 4096, 80, 8, 64, 128, 256, 2), (101_974_336, 17_205_035_008)),
]


@pytest.mark.parametrize("dims,want", BOUNDS)
def test_bound_counts_cbt_once_a_group(dims, want):
    """``chip_smoke.ssd_bound``: C.B^T over a chunk's causal pairs once per
    B/C group, c(c+1) n flops, not once per head; so main and wide, with
    the same h p, need the same flops."""
    assert chip_smoke.ssd_bound(*dims) == want
