"""Flash attention — launcher of the CUDA kernel ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py:flash_attention_kernel`` and the
GQA repeat / head folding of ``repro/kernels/ops.py:flash_attention``: the
kernel reads q ``[B,S,H,hd]`` and k/v ``[B,S,Hkv,hd]`` through their strides
(kv head ``h // (H/Hkv)``), so no repeated or transposed copies are made,
and any ``S`` works.
"""
from __future__ import annotations

import torch

from . import _build
from .rmsnorm import DTYPE_CODES

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,S,Hkv,hd] on the card -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda: q, k, v must be CUDA tensors")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if k.shape != (B, S, Hkv, hd) or v.shape != (B, S, Hkv, hd):
        raise ValueError(f"flash_attention_cuda: k/v shapes {tuple(k.shape)}"
                         f"/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    _build.launch("flash_attention", "repro_flash_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, S, H, Hkv, hd,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  int(causal), float(hd ** -0.5), DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o
