"""RMSNorm — launcher of the CUDA kernel ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm_kernel``.  Float32 math, output
in the input's dtype (float32 or bfloat16), matching
``ref.rmsnorm_reference``.

:func:`plan` picks the kernel's route from ``(rows, d, dtype, row stride,
alignment)``: a warp a row for narrow rows, a block a row with the row in
registers for wide ones, a two-pass block a row above the cap on what a
thread holds; 16-byte vectors where the width, base and stride allow, else
one-element vectors.  :func:`row_stride` lets a view whose rows are evenly
spaced (MLA's ``kv[..., :r_kv]``) reach the kernel without a copy, and the
scale goes in as it is, float32 or bf16.  :func:`rmsnorm_rowblock_cuda`
launches the first port's kernel (``csrc/rmsnorm_rowblock.cu``), which no
route reaches.
"""
from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
#: route codes of the C entry ``repro_rmsnorm``
ROUTES = {"warp": 0, "block": 1, "two_pass": 2}
VECTOR_BYTES = 16
#: the C entry's one argument, ``RmsnormLaunch`` in the source: x, scale,
#: out and stream pointers, rows, row stride, d, eps, dtype and scale dtype
#: codes, route code, elements a vector, vectors a thread, threads a block
LAUNCH = struct.Struct("<4Q2qif6i")
#: the cap: vectors a thread holds in registers (8 x 16 bytes = 32
#: registers), ``kMaxVectors`` in the source
MAX_VECTORS = 8
#: the warp route takes a row of up to this many vectors a lane (1024 bf16,
#: 512 float32, 128 one-element); wider rows take the block route.  Set
#: from ``chip_smoke.rmsnorm_route_sweep`` on an H100 SXM at 700 W: the
#: warp route was faster at 4 vectors a lane (bf16 [1500, 1024] 3.33
#: against 3.92 us a call, [8192, 1024] 9.15 against 9.78; even at 4 rows)
#: and slower at 6 and 8 (bf16 [4, 1536] 3.75 against 2.40, [8192, 2048]
#: 27.9 against 26.3)
WARP_ROUTE_MAX_VECTORS = 4
#: rows (warps) a block on the warp route (2 and 8 were no faster)
WARP_ROUTE_WARPS = 4
#: the block route holds 2 vectors a thread up to BLOCK_THREADS threads,
#: then 4 or 8 up to BLOCK_MAX_THREADS; on fewer rows than FEW_ROWS (fewer
#: blocks than the card has SMs) 2 vectors up to BLOCK_MAX_THREADS.  From
#: the same sweep: 2 vectors were fastest up to 384 threads (bf16 5120 and
#: 6144 wide, within 0.1% of 4 at [8192, 6144]), 4 beyond (7168, 8192 and
#: 16384 wide, on 1024 and 8192 rows), and 2 on 4 rows wherever 512
#: threads do (bf16 [4, 8192] 2.99 against 3.45 us)
BLOCK_THREADS = 384
BLOCK_MAX_THREADS = 512
FEW_ROWS = 132


class Plan(NamedTuple):
    """A launch of ``csrc/rmsnorm.cu``: its route, the elements a vector
    (16 bytes' worth, or 1), the vectors a thread holds (1 on the two-pass
    route, which holds one at a time) and the threads a block."""
    route: str
    vec: int
    vectors: int
    threads: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(rows: int, d: int, dtype: torch.dtype, row_stride: int,
         aligned: bool) -> Plan:
    """The route for ``rows`` rows of ``d`` elements of ``dtype``,
    ``row_stride`` elements apart; ``aligned``: x's and the scale's base
    addresses are multiples of 16 bytes.  Of ``rows`` only whether there
    are fewer than FEW_ROWS matters."""
    esize = ELEMENT_BYTES[dtype]
    wide = VECTOR_BYTES // esize
    vec = wide if (aligned and d % wide == 0
                   and row_stride * esize % VECTOR_BYTES == 0) else 1
    nvec = d // vec
    if -(-nvec // 32) <= WARP_ROUTE_MAX_VECTORS:
        return warp_plan(vec, nvec)
    return block_plan(vec, nvec, few_rows=rows < FEW_ROWS)


def warp_plan(vec: int, nvec: int, warps: int = WARP_ROUTE_WARPS) -> Plan:
    """The warp route for a row of ``nvec`` vectors of ``vec`` elements
    (at most 32 x MAX_VECTORS), ``warps`` rows a block."""
    lane = -(-nvec // 32)
    return Plan("warp", vec, 1 << max(lane - 1, 0).bit_length(), 32 * warps)


def block_plan(vec: int, nvec: int, vectors: Optional[int] = None,
               few_rows: bool = False) -> Plan:
    """The block route for a row of ``nvec`` vectors of ``vec`` elements at
    ``vectors`` a thread (default: 2 up to BLOCK_THREADS threads, or up to
    BLOCK_MAX_THREADS on ``few_rows``, else the fewer of 4 and 8 that fits
    BLOCK_MAX_THREADS), the threads a multiple of 32; the two-pass route
    where that takes more than BLOCK_MAX_THREADS."""
    if vectors is None:
        vectors = 2
        limit = BLOCK_MAX_THREADS if few_rows else BLOCK_THREADS
        while vectors < MAX_VECTORS and -(-nvec // vectors) > limit:
            vectors, limit = 2 * vectors, BLOCK_MAX_THREADS
    need = _round_up(-(-nvec // vectors), 32)
    if need <= BLOCK_MAX_THREADS:
        return Plan("block", vec, vectors, need)
    return Plan("two_pass", vec, 1, BLOCK_MAX_THREADS)


def row_stride(x: torch.Tensor) -> Optional[int]:
    """The one stride, in elements, between consecutive rows of ``x`` read
    as ``[rows, x.shape[-1]]``, or None where the last dimension is not
    contiguous or the leading dimensions do not collapse to one stride (a
    transposed tensor)."""
    shape, strides = x.shape, x.stride()
    if shape[-1] > 1 and strides[-1] != 1:
        return None
    stride = span = None
    for n, s in zip(shape[-2::-1], strides[-2::-1]):
        if n == 1:
            continue
        if span is not None and s != span:
            return None
        if stride is None:
            stride = s
        span = s * n
    return shape[-1] if stride is None else stride


def _stream(card: int) -> int:
    """The current CUDA stream on card ``card``, as a raw pointer."""
    return torch._C._cuda_getCurrentRawStream(card)


def _require_card(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError("rmsnorm_cuda: x must be a CUDA tensor")


#: the C entry's route arguments by (d, dtype code, row stride, aligned,
#: rows < FEW_ROWS): the wrapper's cache of :func:`plan`
_ROUTE_ARGS: dict = {}


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float,
                 route: Optional[Plan] = None) -> torch.Tensor:
    """x: [..., d] on the card; scale: [d], float32 or bf16.  One kernel
    launch.  x is read in place where its rows are evenly spaced with a
    contiguous last dimension (else copied contiguous first); the output is
    contiguous.  ``route``: a plan to launch instead of :func:`plan`'s (to
    time the routes against each other; the C entry rejects one that does
    not cover the row)."""
    _require_card(x)
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"rmsnorm_cuda: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm_cuda: scale shape {tuple(scale.shape)} "
                         f"does not match d={d}")
    if x.is_contiguous():
        stride, out = d, torch.empty_like(x)
    else:
        stride = row_stride(x)
        if stride is None:
            x, stride = x.contiguous(), d
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    card = x.get_device()
    scale_code = DTYPE_CODES.get(scale.dtype)
    if scale_code is None or scale.get_device() != card \
            or not scale.is_contiguous():
        scale, scale_code = scale.to(device=x.device,
                                     dtype=torch.float32).contiguous(), 0
    rows = out.numel() // d if d else 0
    xp, sp = x.data_ptr(), scale.data_ptr()
    if route is None:
        key = (d, code, stride, (xp | sp) % VECTOR_BYTES == 0,
               rows < FEW_ROWS)
        args = _ROUTE_ARGS.get(key)
        if args is None:
            p = plan(rows, d, x.dtype, stride, key[3])
            args = _ROUTE_ARGS[key] = (ROUTES[p.route], p.vec, p.vectors,
                                       p.threads)
    else:
        args = (ROUTES[route.route], route.vec, route.vectors, route.threads)
    _build.launch("rmsnorm", "repro_rmsnorm", LAUNCH.pack(
        xp, sp, out.data_ptr(), _stream(card), rows, stride, d, eps, code,
        scale_code, *args))
    return out


def rmsnorm_rowblock_cuda(x: torch.Tensor, scale: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """The first port's kernel (``csrc/rmsnorm_rowblock.cu``: a 256-thread
    block a row of a contiguous x, one-element loads, a float32 scale),
    launched only here, so that a run can time it beside :func:`rmsnorm_cuda`
    on the same inputs.  One launch of ``rmsnorm_rowblock``, after the
    first port's copy of a strided x and cast of a bf16 scale."""
    _require_card(x)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"rmsnorm_rowblock_cuda: unsupported dtype "
                         f"{x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm_rowblock_cuda: scale shape "
                         f"{tuple(scale.shape)} does not match d={d}")
    x2 = x.contiguous()
    s = scale.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x2)
    rows = x2.numel() // d if d else 0
    _build.launch("rmsnorm_rowblock", "repro_rmsnorm_rowblock",
                  x2.data_ptr(), s.data_ptr(), out.data_ptr(), rows, d,
                  float(eps), DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out
