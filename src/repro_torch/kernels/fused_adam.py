"""Fused AdamW — launcher of the CUDA kernel ``csrc/fused_adam.cu``.

Replaces ``repro/kernels/fused_adam.py:fused_adam_kernel`` and the host
numpy update of the reference's train step.  Updates master/mu/nu in place;
the scalars come from ``ops.adam_scalars`` at run time (the TPU kernel baked
them in as compile-time constants).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build

SCALAR_ORDER = ("b1", "omb1", "b2", "omb2", "b1t", "b2t", "eps", "lr", "wd")


def _require_card(*ts: torch.Tensor) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError("fused_adam_cuda_: operands must be CUDA tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_adam_cuda_(grad: torch.Tensor, master: torch.Tensor,
                     mu: torch.Tensor, nu: torch.Tensor,
                     scalars: Dict[str, float]) -> None:
    """grad/master/mu/nu: flat contiguous f32 [n] on one card (any views,
    e.g. ``t[1:]``: the kernel takes unaligned starts).  One launch."""
    ts = (grad, master, mu, nu)
    n = grad.numel()
    _require_card(*ts)
    for t in ts:
        if t.dtype != torch.float32 or t.dim() != 1 or t.numel() != n \
                or not t.is_contiguous() or t.device != grad.device:
            raise ValueError(
                "fused_adam_cuda_: operands must be contiguous 1-D float32 "
                "CUDA tensors of one size on one device; got "
                f"{[(tuple(x.shape), x.dtype, str(x.device)) for x in ts]}")
    _build.launch("fused_adam", "repro_fused_adam",
                  grad.data_ptr(), master.data_ptr(), mu.data_ptr(),
                  nu.data_ptr(), n, *(scalars[k] for k in SCALAR_ORDER),
                  _stream(grad))
