"""Mamba2 SSD chunk scan — launcher of the CUDA kernel ``csrc/ssd_scan.cu``.

Replaces ``repro/kernels/ssd_scan.py:ssd_scan_kernel`` and the group-to-head
broadcast of ``repro/kernels/ops.py:ssd_scan``: the kernel reads B and C at
group level, and x, B and C through their strides (in the model x, B and C
are views of one activation), so no broadcast or contiguous copies are made.
Scans from a zero state; float32 math, y in x's dtype.
"""
from __future__ import annotations

import torch

from . import _build
from .rmsnorm import DTYPE_CODES

MAX_CHUNK = 256
MAX_STATE = 128


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """x: [b,s,h,p]; dt: [b,s,h]; A: [h]; B, C: [b,s,g,n], all on one card.
    Returns y: [b,s,h,p] in x's dtype.  One kernel launch.

    Checks the kernel's own limits (chunk, n); ``h % g == 0`` and
    ``s % chunk == 0`` are the caller's to hold, as ``ops.ssd_scan`` does."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    ts = (x, dt, A, B, C)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("ssd_scan_cuda: operands must be CUDA tensors on one "
                         "device")
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
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    dt = dt.float()
    A = A.float().contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    _build.launch("ssd_scan", "repro_ssd_scan",
                  x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), y.data_ptr(), b, s, h, g, p, n, chunk,
                  *x.stride()[:3], *dt.stride(), *B.stride()[:3],
                  *C.stride()[:3], DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    return y
