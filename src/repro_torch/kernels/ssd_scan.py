"""Mamba2 SSD chunk scan — launchers of the CUDA kernels
``csrc/ssd_scan_sm90.cu``, ``csrc/ssd_scan_sm90_f32.cu`` and
``csrc/ssd_scan.cu``.

Replace ``repro/kernels/ssd_scan.py:ssd_scan_kernel`` and the group-to-head
broadcast of ``repro/kernels/ops.py:ssd_scan``: the kernels read B and C at
group level, and x, B and C through their strides (in the model x, B and C
are views of one activation), so no broadcast or contiguous copies are made.
Scans from a zero state; float32 math, y in x's dtype.

The route is chosen by dtype and widths alone.  At the tensor-core widths
(``p % 16 == 0``, ``p <= 64``, ``n % 16 == 0``, ``n <= 128`` and
``chunk % 64 == 0``: mamba2-2.7b's p 64, n 128, chunk 256):

- bf16 (:func:`uses_sm90`): ``ssd_scan_sm90.cu``, chunk-parallel on the
  tensor cores, counted as ``ssd_scan_sm90``;
- float32 (:func:`uses_sm90_f32`): ``ssd_scan_sm90_f32.cu``, the same
  chunk-parallel form with every product split into bf16 pieces to float32
  accuracy, counted as ``ssd_scan_sm90_f32``.

Both read x, B and C with 16-byte ``cp.async``, so each needs a unit last
stride, a base and every other stride a multiple of 16 bytes; anything else
raises.  Every other width (the tiny configurations' chunk 8, p 16, n 16)
takes the CUDA-core kernel ``ssd_scan.cu``, counted as ``ssd_scan``, which
reads any strides (a tensor whose last stride is not 1 is made contiguous).
It is chunk-parallel too: rows go in groups of :func:`group_chunks` chunks
(at most 64 rows, or one chunk above 64), with one float32 [p, n] state a
group in its workspace (:func:`cuda_core_workspace`).

Asked for it, each route also returns the final state [b, h, p, n] float32,
the state after the last row (the reference's ``scan_fn`` carry), from its
state pass: the training launch passes a null pointer and does no extra work.

A failed launch raises; no route takes over from another.
"""
from __future__ import annotations

import torch

from . import _build
from .rmsnorm import DTYPE_CODES

MAX_CHUNK = 256
MAX_STATE = 128
SM90_MAX_P = 64
SM90_TILE = 64     # rows of the tensor-core kernel's chunk tiles
CUDA_CORE_GROUP_ROWS = 64   # the most rows of a group of small chunks


def _tensor_core_widths(p: int, n: int, chunk: int) -> bool:
    return (p % 16 == 0 and 0 < p <= SM90_MAX_P and n % 16 == 0
            and 0 < n <= MAX_STATE and chunk % SM90_TILE == 0)


def uses_sm90(dtype: torch.dtype, p: int, n: int, chunk: int) -> bool:
    """True where the bf16 tensor-core kernel is the route."""
    return dtype == torch.bfloat16 and _tensor_core_widths(p, n, chunk)


def uses_sm90_f32(dtype: torch.dtype, p: int, n: int, chunk: int) -> bool:
    """True where the float32 tensor-core kernel is the route."""
    return dtype == torch.float32 and _tensor_core_widths(p, n, chunk)


def _require_card(*ts: torch.Tensor) -> None:
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError("ssd_scan_cuda: operands must be CUDA tensors on one "
                         "device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(x, dt, A, B, C, chunk) -> None:
    b, s, h, p = x.shape
    n = B.shape[3]
    _require_card(x, dt, A, B, C)
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan_cuda: unsupported dtypes "
                         f"{x.dtype}/{B.dtype}/{C.dtype}")
    if dt.shape != (b, s, h) or A.shape != (h,) or C.shape != B.shape \
            or B.shape[:2] != (b, s):
        raise ValueError(f"ssd_scan_cuda: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)} do not match")
    if not 0 < chunk <= MAX_CHUNK or not 0 < n <= MAX_STATE:
        raise ValueError(f"ssd_scan_cuda: needs 0 < chunk <= {MAX_CHUNK} and "
                         f"0 < n <= {MAX_STATE}; got chunk={chunk} n={n}")


def _aligned_strides(name: str, t: torch.Tensor) -> list:
    """Element strides of ``t``'s first three dimensions as the tensor-core
    kernel takes them; raises where 16-byte ``cp.async`` cannot read ``t``
    in place.  A dimension of size 1 is never stepped over, so its stride is
    not checked."""
    if t.stride(-1) != 1:
        raise ValueError(f"ssd_scan_cuda: {name} has last stride "
                         f"{t.stride(-1)}; the tensor-core route needs 1")
    if t.data_ptr() % 16:
        raise ValueError(f"ssd_scan_cuda: {name} starts {t.data_ptr() % 16} "
                         f"bytes off a 16-byte boundary (cp.async)")
    for size, stride in zip(t.shape[:3], t.stride()[:3]):
        if size > 1 and stride * t.element_size() % 16:
            raise ValueError(f"ssd_scan_cuda: {name} strides "
                             f"{tuple(t.stride())} are not multiples of 16 "
                             f"bytes (cp.async)")
    return list(t.stride()[:3])


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int,
                  final_state: bool = False):
    """x: [b,s,h,p]; dt: [b,s,h]; A: [h]; B, C: [b,s,g,n], all on one card.
    Returns y: [b,s,h,p] in x's dtype, from the route :func:`uses_sm90`
    and :func:`uses_sm90_f32` pick; with ``final_state``, ``(y, state)``,
    state [b,h,p,n] float32 after the last row.

    Checks the kernels' own limits (chunk, n, alignment on the tensor-core
    route); ``h % g == 0`` and ``s % chunk == 0`` are the caller's to hold,
    as ``ops.ssd_scan`` does."""
    p, n = x.shape[-1], B.shape[-1]
    if uses_sm90(x.dtype, p, n, chunk):
        return _ssd_scan_tensor_cores("ssd_scan_sm90", x, dt, A, B, C, chunk,
                                      final_state)
    if uses_sm90_f32(x.dtype, p, n, chunk):
        return _ssd_scan_tensor_cores("ssd_scan_sm90_f32", x, dt, A, B, C,
                                      chunk, final_state)
    return ssd_scan_cuda_cores(x, dt, A, B, C, chunk, final_state)


def _ssd_scan_tensor_cores(kernel: str, x, dt, A, B, C, chunk: int,
                           final_state: bool = False):
    """A tensor-core kernel, ``csrc/<kernel>.cu`` (C entry
    ``repro_<kernel>``), for inputs its predicate accepts: three kernels on
    the caller's stream, counted as one launch of ``kernel``.  The bf16 and
    float32 kernels take the same arguments.  Allocates their workspace:
    the chunks' state parts, then in place their entering states (float32,
    b*h*(s/chunk)*p*n elements), exp of each chunk's decay, and the decay's
    running sums (float64) and dt (float32) for each row; with
    ``final_state``, the state [b, h, p, n] float32 the state pass writes
    (returned beside y)."""
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    strides = [st for name, t in (("x", x), ("B", B), ("C", C))
               for st in _aligned_strides(name, t)]
    dt = dt.float()
    A = A.float().contiguous()
    nc = s // chunk
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ws = torch.empty(b * h * nc * p * n, dtype=torch.float32, device=x.device)
    seg = torch.empty(b * h * nc, dtype=torch.float32, device=x.device)
    cum = torch.empty(b * h * s, dtype=torch.float64, device=x.device)
    dts = torch.empty(b * h * s, dtype=torch.float32, device=x.device)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device) \
        if final_state else None
    _build.launch(kernel, f"repro_{kernel}",
                  x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), y.data_ptr(), ws.data_ptr(), seg.data_ptr(),
                  cum.data_ptr(), dts.data_ptr(),
                  None if fin is None else fin.data_ptr(),
                  b, s, h, g, p, n, chunk, *strides[:3], *dt.stride(),
                  *strides[3:], _stream(x))
    return y if fin is None else (y, fin)


def group_chunks(chunk: int) -> int:
    """Chunks in a group of the CUDA-core kernel: as many as 64 rows hold,
    one for a chunk above 64 rows."""
    return max(1, CUDA_CORE_GROUP_ROWS // chunk)


def cuda_core_workspace(b: int, s: int, h: int, g: int, p: int, n: int,
                        chunk: int) -> tuple:
    """Float32 elements of the CUDA-core kernel's three workspaces: the
    groups' states (b*h*groups states of p*n rounded up to 4 elements, for
    the state pass's 16-byte vectors), exp of each group's decay
    (b*h*groups), groups = ceil((s / chunk) / group_chunks(chunk)), and,
    for a chunk above 64 rows, C.B^T of every pair of 64-row tiles j <= i
    of each chunk, once per B/C group (b*g*chunks*pairs*64*64; none at
    chunk <= 64)."""
    k = group_chunks(chunk)
    chunks = s // chunk
    groups = -(-chunks // k)
    pn4 = -(-(p * n) // 4) * 4
    tiles = -(-chunk // CUDA_CORE_GROUP_ROWS)
    pairs = tiles * (tiles + 1) // 2 if chunk > CUDA_CORE_GROUP_ROWS else 0
    return (b * h * groups * pn4, b * h * groups,
            b * g * chunks * pairs * CUDA_CORE_GROUP_ROWS ** 2)


def ssd_scan_cuda_cores(x, dt, A, B, C, chunk: int,
                        final_state: bool = False):
    """The CUDA-core kernel (``csrc/ssd_scan.cu``), for any dtype and width
    it takes, bf16 at mamba2's widths too (``chip_smoke.py`` runs both
    routes on the same inputs): three kernels on the caller's stream (four
    above chunk 64), counted as one launch of ``ssd_scan``.  Allocates
    their workspace (:func:`cuda_core_workspace`).  With ``final_state``
    returns ``(y, state)``: the state pass writes each [p, n] state as its
    workspace holds it, [n][p] in p*n rounded up to 4 floats, and state is
    the [b, h, p, n] view of that buffer."""
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    dt = dt.float()
    A = A.float().contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ws, seg, cb = (torch.empty(k, dtype=torch.float32, device=x.device)
                   for k in cuda_core_workspace(b, s, h, g, p, n, chunk))
    pn4 = -(-(p * n) // 4) * 4
    fin = torch.empty((b * h, pn4), dtype=torch.float32, device=x.device) \
        if final_state else None
    _build.launch("ssd_scan", "repro_ssd_scan",
                  x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), y.data_ptr(), ws.data_ptr(), seg.data_ptr(),
                  cb.data_ptr(), None if fin is None else fin.data_ptr(),
                  b, s, h, g, p, n, chunk,
                  *x.stride()[:3], *dt.stride(), *B.stride()[:3],
                  *C.stride()[:3], DTYPE_CODES[x.dtype], _stream(x))
    if fin is None:
        return y
    return y, fin[:, :p * n].reshape(b, h, n, p).transpose(2, 3)
