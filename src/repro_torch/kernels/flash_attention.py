"""Flash attention — launchers of the CUDA kernels
``csrc/flash_attention_sm90.cu``, ``csrc/flash_attention_tf32.cu``,
``csrc/flash_attention_bf16_mma.cu`` and ``csrc/flash_attention.cu``.

Replace ``repro/kernels/flash_attention.py:flash_attention_kernel`` and the
GQA repeat / head folding of ``repro/kernels/ops.py:flash_attention``: the
kernels read q ``[B,S,H,hd]`` and k/v ``[B,S,Hkv,hd]`` through their strides
(kv head ``h // (H/Hkv)``), so no repeated or transposed copies are made,
and any ``S`` works.

:func:`flash_attention_cuda` chooses the route by ``(dtype, head_dim)``
alone, and every route runs on the tensor cores:

- bf16 at head_dim 64 or 128 (every model the port trains): ``wgmma`` +
  TMA.  TMA needs a unit head_dim stride, and the base pointers and every
  other stride a multiple of 16 bytes; anything else raises.
- float32 at any head_dim: 3xTF32 ``mma.sync``.
- bf16 at head_dim 16 or 32 (the tiny configs): bf16 ``mma.sync``.

The two ``mma.sync`` routes load by 16-byte ``cp.async``, which needs the
same layout as TMA; a tensor that does not have it is copied contiguous
first.  No dtype or head_dim reaches the CUDA-core kernel through
:func:`flash_attention_cuda`: :func:`flash_attention_cuda_cores` launches
it explicitly (float32 at any head_dim, bf16 at 16/32), so that it can be
run beside the tensor-core routes on the same inputs.  A failed launch
raises; no route takes over from another.
"""
from __future__ import annotations

import torch

from . import _build
from .rmsnorm import DTYPE_CODES

HEAD_DIMS = (16, 32, 64, 128)
SM90_HEAD_DIMS = (64, 128)
BF16_MMA_HEAD_DIMS = (16, 32)


def uses_sm90(dtype: torch.dtype, hd: int) -> bool:
    """True where the bf16 tensor-core kernel is the route."""
    return dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS


def uses_tf32(dtype: torch.dtype, hd: int) -> bool:
    """True where the 3xTF32 tensor-core kernel is the route."""
    return dtype == torch.float32 and hd in HEAD_DIMS


def uses_bf16_mma(dtype: torch.dtype, hd: int) -> bool:
    """True where the bf16 ``mma.sync`` kernel is the route."""
    return dtype == torch.bfloat16 and hd in BF16_MMA_HEAD_DIMS


def _require_card(*ts: torch.Tensor) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention_cuda: q, k, v must be CUDA tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tma_strides(name: str, t: torch.Tensor) -> list:
    """Element strides (batch, seq, head) of ``t`` [B, S, heads, hd] as the
    tensor-core kernel's tensor maps take them; raises where TMA cannot
    read ``t`` in place.  A dimension of size 1 is never stepped over, so
    its stride is replaced by the contiguous one."""
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention_cuda: {name} has head_dim stride "
                         f"{t.stride(-1)}; the tensor-core route needs 1")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention_cuda: {name} starts "
                         f"{t.data_ptr() % 16} bytes off a 16-byte boundary "
                         f"(TMA needs 16-byte alignment)")
    _, S, heads, hd = t.shape
    out = []
    for size, stride, dense in zip(t.shape[:3], t.stride()[:3],
                                   (S * heads * hd, heads * hd, hd)):
        stride = dense if size == 1 else stride
        if stride * t.element_size() % 16:
            raise ValueError(f"flash_attention_cuda: {name} strides "
                             f"{tuple(t.stride())} are not multiples of 16 "
                             f"bytes (TMA)")
        out.append(stride)
    return out


def _cp_async_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the ``mma.sync`` kernels read it: unit head_dim stride,
    base and the strides it steps over multiples of 16 bytes; else a
    contiguous copy (a new allocation, so its base is aligned too)."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        size == 1 or stride * t.element_size() % 16 == 0
        for size, stride in zip(t.shape[:3], t.stride()[:3]))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    _require_card(q, k, v)
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if k.shape != (B, S, Hkv, hd) or v.shape != (B, S, Hkv, hd):
        raise ValueError(f"flash_attention_cuda: k/v shapes {tuple(k.shape)}"
                         f"/{tuple(v.shape)} do not match q {tuple(q.shape)}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,S,Hkv,hd] on the card -> [B,S,H,hd], by the
    route of ``(dtype, head_dim)``."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if uses_sm90(q.dtype, hd):
        o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
        strides = [s for name, t in (("q", q), ("k", k), ("v", v))
                   for s in _tma_strides(name, t)]
        _build.launch("flash_attention_sm90", "repro_flash_attention_sm90",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, S, H, Hkv, hd, *strides, int(causal),
                      float(hd ** -0.5), _stream(q))
        return o
    # the mma.sync routes (_check leaves no other case): float32 at any
    # head_dim, bf16 at head_dim 16/32
    kernel = "flash_attention_tf32" if uses_tf32(q.dtype, hd) \
        else "flash_attention_bf16_mma"
    q, k, v = (_cp_async_ready(t) for t in (q, k, v))
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    _build.launch(kernel, f"repro_{kernel}",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, S, H, Hkv, hd,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  int(causal), float(hd ** -0.5), _stream(q))
    return o


def flash_attention_cuda_cores(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool) -> torch.Tensor:
    """The CUDA-core kernel (``csrc/flash_attention.cu``), launched only
    here: float32 at any head_dim and bf16 at head_dim 16/32
    (``chip_smoke.py`` runs it beside the tensor-core routes on the same
    inputs).  One launch of ``flash_attention``."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if uses_sm90(q.dtype, hd):
        raise ValueError(f"flash_attention_cuda_cores: no CUDA-core kernel "
                         f"for {q.dtype} at head_dim {hd}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    _build.launch("flash_attention", "repro_flash_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, S, H, Hkv, hd,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  int(causal), float(hd ** -0.5), DTYPE_CODES[q.dtype],
                  _stream(q))
    return o
