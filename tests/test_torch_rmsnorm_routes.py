"""The rmsnorm kernel's routes (``csrc/rmsnorm.cu``) on the CPU.

The kernel runs only on the card.  Here: :func:`rmsnorm.plan`, which picks
the route from ``(rows, d, dtype, row stride, alignment)``, at every norm
width of the ten published configurations and on ragged and unaligned rows,
under the cap on what a thread holds; the element each thread of a plan
covers; :func:`rmsnorm.row_stride` on views; the arguments the wrapper
hands the C entry (a strided view and a bf16 scale go in as they are, one
launch a call), with the launch monkeypatched; and the kernel's arithmetic,
emulated in numpy in its order (float32 partial sums a thread, the shuffle
tree, the block's warp sums, ``(x * r) * scale`` rounded once), held with
``ops.rmsnorm`` on the CPU against the JAX package's ``ops.rmsnorm`` (Pallas
in interpret mode) under the unchanged tiers, on strided slices of wider
tensors and with a bf16 scale.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: E402,F401
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

PUBLISHED = ("codeqwen1p5_7b", "deepseek_67b", "deepseek_v3_671b",
             "internvl2_76b", "jamba_1p5_large_398b", "llama3_405b",
             "llama4_scout_17b_a16e", "mamba2_2p7b", "nemotron_4_15b",
             "whisper_base")
DTYPES = (torch.float32, torch.bfloat16)
TIERS = {torch.float32: ops.TOLERANCE_TIERS["rmsnorm"],
         torch.bfloat16: ops.TOLERANCE_TIERS["rmsnorm_bf16"]}
ENTRY = "repro_rmsnorm"


def norm_widths(name):
    """(d, row stride) of every norm of a published configuration: the
    block and final norms at d_model, a Mamba2 block's gated out_norm at
    d_inner, MLA's q_norm and its kv_norm (the first kv_lora_rank of
    wkv_a's kv_lora_rank + qk_rope_dim outputs, read in place)."""
    cfg = importlib.import_module(f"repro_torch.configs.{name}").config()
    out = [(cfg.d_model, cfg.d_model)]
    if cfg.ssm_state:
        out.append((cfg.d_inner, cfg.d_inner))
    if cfg.use_mla:
        out.append((cfg.kv_lora_rank, cfg.kv_lora_rank + cfg.qk_rope_dim))
        if cfg.q_lora_rank:
            out.append((cfg.q_lora_rank, cfg.q_lora_rank))
    return out


def team(p):
    """Threads that share one row under plan ``p``."""
    return 32 if p.route == "warp" else p.threads


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", PUBLISHED)
def test_published_norm_widths_take_vector_routes(name, dtype):
    wide = 16 // rn.ELEMENT_BYTES[dtype]
    for d, stride in norm_widths(name):
        for rows in (1, 4, 1024):
            p = rn.plan(rows, d, dtype, stride, True)
            assert p.vec == wide and p.route in ("warp", "block"), (d, p)
            assert p.vectors * team(p) * wide >= d


def test_every_published_width_is_listed():
    widths = {d for n in PUBLISHED for d, _ in norm_widths(n)}
    assert widths == {512, 1536, 2560, 4096, 5120, 6144, 7168, 8192, 16384}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d, stride, aligned", [
    (4095, 4095, True),        # d not a multiple of any vector width
    (1001, 1001, True),
    (7, 7, True),
    (4096, 4096, False),       # a base 2 or 4 bytes off a 16-byte boundary
    (4095, 4096, False),       # x[:, 1:] of a [rows, 4096] tensor
    (512, 577, True),          # a row stride off 16 bytes
])
def test_ragged_and_unaligned_take_one_element_vectors(d, stride, aligned,
                                                       dtype):
    p = rn.plan(64, d, dtype, stride, aligned)
    assert p.vec == 1
    assert p.route in ("warp", "block", "two_pass")
    if p.route != "two_pass":
        assert p.vectors * team(p) >= d


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("aligned", [True, False])
def test_no_route_exceeds_the_cap(dtype, aligned):
    esize = rn.ELEMENT_BYTES[dtype]
    widths = sorted({*range(1, 600, 7), *range(600, 70000, 997),
                     *(2 ** k for k in range(17)), 4095, 4097, 16383,
                     32768, 65536, 65537})
    for d in widths:
        p = rn.plan(8, d, dtype, d, aligned)
        held = p.vectors * p.vec * esize
        assert 1 <= p.vectors <= rn.MAX_VECTORS, (d, p)
        assert held <= rn.MAX_VECTORS * rn.VECTOR_BYTES, (d, p)
        assert p.threads % 32 == 0
        nvec = d // p.vec
        if p.route == "warp":
            assert p.threads == 32 * rn.WARP_ROUTE_WARPS
            assert -(-nvec // 32) <= rn.WARP_ROUTE_MAX_VECTORS
            assert 32 * p.vectors >= nvec
        elif p.route == "block":
            assert 32 < p.threads <= rn.BLOCK_MAX_THREADS
            assert p.vectors * p.threads >= nvec
            # the fewest threads at the fewest vectors: halving either
            # would no longer cover the row or would pass BLOCK_THREADS
            assert p.threads - 32 < -(-nvec // p.vectors)
        else:
            assert p.vec * rn.MAX_VECTORS * rn.BLOCK_MAX_THREADS < d
            assert p.threads == rn.BLOCK_MAX_THREADS


def covered(p, d):
    """How many times the kernel's threads under plan ``p`` write each
    element of a row of ``d``: thread t of the row's team holds vectors
    t + i * team for i < vectors (the two-pass route loops over the row)."""
    n, nvec = team(p), d // p.vec
    hits = np.zeros(d, np.int64)
    for t in range(n):
        js = (range(t, nvec, n) if p.route == "two_pass"
              else [t + i * n for i in range(p.vectors) if t + i * n < nvec])
        for j in js:
            hits[j * p.vec:(j + 1) * p.vec] += 1
    return hits


@pytest.mark.parametrize("d, dtype, aligned", [
    (512, torch.bfloat16, True), (1536, torch.bfloat16, True),
    (2560, torch.bfloat16, True), (5120, torch.float32, True),
    (16384, torch.bfloat16, True), (16384, torch.float32, True),
    (1000, torch.bfloat16, True), (4095, torch.bfloat16, True),
    (4095, torch.float32, False), (40000, torch.bfloat16, True),
    (16, torch.float32, True)])
def test_each_element_written_once(d, dtype, aligned):
    p = rn.plan(4, d, dtype, d, aligned)
    assert (covered(p, d) == 1).all(), p


def test_row_stride_collapses_evenly_spaced_rows():
    kv = torch.zeros(2, 7, 576)
    assert rn.row_stride(kv[..., :512]) == 576
    assert rn.row_stride(kv) == 576
    assert rn.row_stride(kv[:1, 3:4, :512]) == 512      # one row
    assert rn.row_stride(torch.zeros(3, 1, 5, 64)[:, :, :, :32]) == 64
    x = torch.zeros(2, 8, 64)
    assert rn.row_stride(x[:, ::2]) == 128                # rows 128 apart
    assert rn.row_stride(torch.zeros(4, 3, 64)[::2]) is None
    assert rn.row_stride(kv[..., :512].transpose(0, 1)) is None
    assert rn.row_stride(torch.zeros(64, 32).t()) is None  # d not contiguous
    assert rn.row_stride(torch.zeros(64, 1).t()) == 64    # one row


@pytest.fixture
def recorded(monkeypatch):
    """The C entries' arguments, with the launch monkeypatched: the wrapper
    runs on CPU tensors as it would on the card."""
    calls = []

    class Library:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(rn, "_require_card", lambda x: None)
    monkeypatch.setattr(rn, "_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    return calls


def launched(recorded):
    """The last launch record handed to ``repro_rmsnorm``, unpacked: x,
    scale, out, stream, rows, row stride, d, eps, dtype, scale dtype, route,
    vec, vectors, threads."""
    entry, args = recorded[-1]
    assert entry == ENTRY and len(args) == len(_build.SIGNATURES[ENTRY])
    assert len(args[0]) == rn.LAUNCH.size == 80      # RmsnormLaunch
    return rn.LAUNCH.unpack(args[0])


def test_strided_view_and_bf16_scale_go_in_as_they_are(recorded):
    kv = torch.zeros(2, 7, 576, dtype=torch.bfloat16)
    x = kv[..., :512]
    scale = torch.ones(512, dtype=torch.bfloat16)
    out = rn.rmsnorm_cuda(x, scale, 1e-5)
    assert out.shape == x.shape and out.is_contiguous()
    xp, sp, op, stream, rows, stride, d, eps, code, scode, route, vec, nv, \
        thr = launched(recorded)
    assert (xp, sp, op, stream) == (x.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), 0)
    assert (rows, stride, d, code, scode) == (14, 576, 512, 1, 1)
    assert eps == np.float32(1e-5)
    p = rn.plan(14, 512, torch.bfloat16, 576, True)
    assert (route, vec, nv, thr) == (rn.ROUTES[p.route], 8, p.vectors,
                                     p.threads)
    # a float32 scale, a transposed x (copied first), a forced plan and the
    # explicit first-port kernel: one launch each, under their own counters
    s32 = scale.float()
    rn.rmsnorm_cuda(x, s32, 1e-5)
    assert launched(recorded)[:2] == (x.data_ptr(), s32.data_ptr())
    assert launched(recorded)[9] == 0
    xt = torch.zeros(64, 32, dtype=torch.bfloat16).t()
    rn.rmsnorm_cuda(xt, torch.ones(64), 1e-5)
    assert launched(recorded)[0] != xt.data_ptr()
    assert launched(recorded)[5] == 64
    forced = rn.Plan("block", 8, 1, 64)
    rn.rmsnorm_cuda(x, scale, 1e-5, route=forced)
    assert launched(recorded)[10:] == (rn.ROUTES["block"], 8, 1, 64)
    rn.rmsnorm_rowblock_cuda(x, scale, 1e-5)
    assert recorded[-1][0] == "repro_rmsnorm_rowblock"
    assert _build.LAUNCHES["rmsnorm"] == 4
    assert _build.LAUNCHES["rmsnorm_rowblock"] == 1
    assert sum(_build.LAUNCHES.values()) == 5


def test_unsupported_inputs_raise():
    with pytest.raises(ValueError, match="CUDA tensor"):
        rn.rmsnorm_cuda(torch.zeros(2, 8), torch.ones(8), 1e-5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rn.rmsnorm_rowblock_cuda(torch.zeros(2, 8), torch.ones(8), 1e-5)


def emulate(x, scale, eps, p):
    """The kernel's arithmetic under plan ``p`` in numpy float32: a
    thread's partial sum of squares over its vectors in order (one rounding
    a fused multiply-add), the shuffle tree (xor 16, 8, 4, 2, 1) over a
    warp, on the block route each warp's sum read back by lane and reduced
    by the same tree; r = 1 / sqrt(sum / d + eps); (x * r) * scale.
    Returns float32, before the rounding to x's dtype."""
    rows, d = x.shape
    f64 = x.astype(np.float64)
    n, nvec = team(p), d // p.vec
    part = np.zeros((rows, n), np.float32)
    for t in range(n):
        js = (range(t, nvec, n) if p.route == "two_pass"
              else [t + i * n for i in range(p.vectors) if t + i * n < nvec])
        for j in js:
            for e in range(j * p.vec, (j + 1) * p.vec):
                part[:, t] = (f64[:, e] * f64[:, e]
                              + part[:, t].astype(np.float64)) \
                    .astype(np.float32)

    def tree(v):                     # [rows, 32] -> [rows, 32], all equal
        for off in (16, 8, 4, 2, 1):
            v = v + v[:, np.arange(32) ^ off]
        return v

    sums = np.concatenate([tree(part[:, w:w + 32])[:, :1]
                           for w in range(0, n, 32)], axis=1)
    if n > 32:
        sums = tree(np.pad(sums, ((0, 0), (0, 32 - sums.shape[1]))))[:, :1]
    r = (np.float32(1) / np.sqrt(sums / np.float32(d) + np.float32(eps))) \
        .astype(np.float32)
    return (x * r) * scale.astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows, d, wide, offset, bf16_scale", [
    (6, 512, 576, 0, False),     # MLA's kv_norm input, a slice of wkv_a
    (6, 512, 576, 0, True),
    (5, 96, 96, 0, True),        # a tiny twin's width, the warp route
    (3, 2560, 2560, 0, False),   # mamba2's d_model, the block route
    (3, 4095, 4096, 1, True),    # x[:, 1:]: unaligned, ragged
    (2, 1000, 1000, 0, False),
])
def test_kernel_arithmetic_and_cpu_path_vs_reference(rows, d, wide, offset,
                                                     bf16_scale, dtype):
    rs = np.random.default_rng(rows * d + offset)
    xw = rs.standard_normal((rows, wide)).astype(np.float32)
    s = (1 + 0.1 * rs.standard_normal(d)).astype(np.float32)
    tw = torch.from_numpy(xw).to(dtype)
    tx = tw[:, offset:offset + d]
    ts = torch.from_numpy(s)
    if bf16_scale:
        ts = ts.bfloat16()
    tier = TIERS[dtype]
    jx = jnp.asarray(tx.float().numpy()).astype(
        "bfloat16" if dtype == torch.bfloat16 else "float32")
    want = np.asarray(jops.rmsnorm(jx, jnp.asarray(ts.float().numpy()),
                                   eps=1e-5), np.float32)
    got = ops.rmsnorm(tx, ts, eps=1e-5)
    assert got.dtype == dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), want, **tier)
    stride = rn.row_stride(tx)
    esize = rn.ELEMENT_BYTES[dtype]
    p = rn.plan(rows, d, dtype, stride, offset * esize % 16 == 0)
    y = emulate(tx.float().numpy(), ts.float().numpy(), 1e-5, p)
    y = torch.from_numpy(y).to(dtype).float().numpy()
    np.testing.assert_allclose(y, want, **tier)
