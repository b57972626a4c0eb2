"""Public wrappers for the kernels, dispatching by device.

For a CUDA tensor a wrapper launches its hand-written CUDA kernel (and
raises if it cannot); for a CPU tensor it runs the kernel's plain version in
``ref.py``; any other device raises.  There is no fallback from the card to
the plain version.  Launches are counted in ``_build.LAUNCHES``.

Each differentiable kernel sits in a ``torch.autograd.Function`` that mirrors
the reference's ``jax.custom_vjp`` (``repro/kernels/ops.py``): the forward
is the kernel, the backward is autograd of the plain version at the saved
inputs.  The TPU kernels have no backward kernel, so none is written here.

Tolerance tiers
---------------
A kernel is numerically equivalent but not bit-identical to its plain
version (other reduction order, online-softmax rescaling).  Each kernel
declares its tier here; the float32 tiers are the reference's.  The bf16
tiers cover one rounding of the float32 result to bfloat16, whose relative
spacing is at most 2**-7 (7.8e-3): the kernel and the plain version may land
on neighbouring values.  Fused AdamW is held bitwise, not by its tier.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import ref
from .flash_attention import flash_attention_cuda
from .fused_adam import fused_adam_cuda_
from .rmsnorm import rmsnorm_cuda

#: Declared per-kernel tolerance vs the ``ref.py`` plain versions.
TOLERANCE_TIERS = {
    "flash_attention": {"rtol": 1e-4, "atol": 1e-5},
    "rmsnorm": {"rtol": 1e-5, "atol": 1e-6},
    "ssd_scan": {"rtol": 1e-4, "atol": 1e-5},
    "fused_adam": {"rtol": 1e-6, "atol": 1e-7},
    "flash_attention_bf16": {"rtol": 1e-2, "atol": 1e-4},
    "rmsnorm_bf16": {"rtol": 1e-2, "atol": 1e-5},
}


def on_card(t: torch.Tensor) -> bool:
    """True: launch the kernel.  False: run the plain version (CPU only)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if on_card(x):
            return rmsnorm_cuda(x, scale, eps)
        return ref.rmsnorm_reference(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(ctx.needs_input_grad[0])
            ss = scale.detach().requires_grad_(ctx.needs_input_grad[1])
            y = ref.rmsnorm_reference(xx, ss, ctx.eps)
            wrt = [t for t in (xx, ss) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g))
        return (next(grads) if ctx.needs_input_grad[0] else None,
                next(grads) if ctx.needs_input_grad[1] else None, None)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        if on_card(q):
            return flash_attention_cuda(q, k, v, causal)
        return ref.gqa_attention_reference(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(saved, ctx.needs_input_grad[:3])]
            o = ref.gqa_attention_reference(*ins, causal=ctx.causal)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(o, wrt, g))
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad[:3]) + (None,)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B,S,H,hd]; k,v: [B,S,Hkv,hd] (GQA broadcast inside). -> [B,S,H,hd]."""
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv <= 0 or H % Hkv != 0:
        raise ValueError(
            f"flash_attention: num_heads H={H} is not a multiple of "
            f"num_kv_heads Hkv={Hkv} — the GQA broadcast repeats each kv "
            f"head H//Hkv times and requires H % Hkv == 0")
    return _FlashAttention.apply(q, k, v, causal)


def rmsnorm(x, scale, *, eps: float = 1e-5):
    return _RMSNorm.apply(x, scale, eps)


def adam_scalars(step: int, *, b1: float, b2: float, eps: float, lr: float,
                 weight_decay: float) -> Dict[str, float]:
    """AdamW's constants, computed in float64 and rounded to float32 exactly
    as ``optim.adam.adam_update_flat_np`` does."""
    f32 = lambda x: float(np.float32(x))     # noqa: E731
    return {"b1": f32(b1), "omb1": f32(1 - b1), "b2": f32(b2),
            "omb2": f32(1 - b2), "b1t": f32(1.0 - b1 ** step),
            "b2t": f32(1.0 - b2 ** step), "eps": f32(eps), "lr": f32(lr),
            "wd": f32(weight_decay)}


def fused_adam_(grad, master, mu, nu, *, step: int, b1: float = 0.9,
                b2: float = 0.95, eps: float = 1e-8, lr: float = 3e-4,
                weight_decay: float = 0.1) -> None:
    """Fused AdamW over flat f32 vectors, updating master/mu/nu in place.

    Same op sequence as ``optim.adam.adam_update_flat_np``, and bitwise equal
    to it: on the card through the kernel (no FMA contraction), on the CPU
    through ``ref.adam_flat_reference``."""
    shapes = {"grad": grad.shape, "master": master.shape,
              "mu": mu.shape, "nu": nu.shape}
    if len({tuple(s) for s in shapes.values()}) != 1:
        raise ValueError(f"fused_adam: mismatched operand shapes {shapes}")
    scalars = adam_scalars(step, b1=b1, b2=b2, eps=eps, lr=lr,
                           weight_decay=weight_decay)
    if on_card(grad):
        fused_adam_cuda_(grad, master, mu, nu, scalars)
        return
    new = ref.adam_flat_reference(grad, master, mu, nu, scalars)
    master.copy_(new["master"])
    mu.copy_(new["mu"])
    nu.copy_(new["nu"])
