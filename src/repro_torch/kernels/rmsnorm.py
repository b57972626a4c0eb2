"""RMSNorm — launcher of the CUDA kernel ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm_kernel``.  Float32 math, output
in the input's dtype (float32 or bfloat16), matching
``ref.rmsnorm_reference``.
"""
from __future__ import annotations

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """x: [..., d] on the card; scale: [d].  One kernel launch."""
    if not x.is_cuda:
        raise ValueError("rmsnorm_cuda: x must be a CUDA tensor")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"rmsnorm_cuda: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm_cuda: scale shape {tuple(scale.shape)} "
                         f"does not match d={d}")
    x2 = x.contiguous()
    s = scale.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x2)
    rows = x2.numel() // d if d else 0
    _build.launch("rmsnorm", "repro_rmsnorm", x2.data_ptr(), s.data_ptr(),
                  out.data_ptr(), rows, d, float(eps), DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out
