"""Public wrappers for the kernels, dispatching by device.

For a CUDA tensor a wrapper launches its hand-written CUDA kernel (and
raises if it cannot); for a CPU tensor it runs the kernel's plain version in
``ref.py``; any other device raises.  There is no fallback from the card to
the plain version.  Launches are counted in ``_build.LAUNCHES``.

Each differentiable kernel sits in a ``torch.autograd.Function`` that mirrors
the reference's ``jax.custom_vjp`` (``repro/kernels/ops.py``): the forward
is the kernel, the backward is autograd of the plain version at the saved
inputs.  The TPU kernels have no backward kernel, so none is written here.
Dropout is the exception: its backward is the same mask-and-scale function
of the cotangent (the jitted reference's gradient), so forward and backward
both launch ``csrc/threefry_dropout.cu``, which regenerates the mask from
the keys instead of saving it.

The SSD scan's backward differentiates the chunked plain version
``ref.ssd_chunked`` in float32 rather than the sequential oracle the
reference differentiates: the two are the same function, but at seq 4096
autograd through the oracle's loop would keep every step's [b, h, p, n]
state (10.7 GB per call at mamba2-2.7b's widths) and launch tens of
thousands of small kernels.

Tolerance tiers
---------------
A kernel is numerically equivalent but not bit-identical to its plain
version (other reduction order, online-softmax rescaling).  Each kernel
declares its tier here; the float32 tiers are the reference's.  The bf16
tiers cover one rounding of the float32 result to bfloat16, whose relative
spacing is at most 2**-7 (7.8e-3): the kernel and the plain version may land
on neighbouring values.  ``ssd_scan_bf16`` is the same: the kernel and the
oracle both compute in float32 from the same bf16 inputs and round once.
Fused AdamW and dropout are held bitwise, not by a tier.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import ref
from .flash_attention import flash_attention_cuda
from .fused_adam import fused_adam_cuda_
from .rmsnorm import rmsnorm_cuda
from .ssd_scan import ssd_scan_cuda
from .threefry import dropout_scalars, threefry_dropout_cuda

#: Declared per-kernel tolerance vs the ``ref.py`` plain versions.
TOLERANCE_TIERS = {
    "flash_attention": {"rtol": 1e-4, "atol": 1e-5},
    "rmsnorm": {"rtol": 1e-5, "atol": 1e-6},
    "ssd_scan": {"rtol": 1e-4, "atol": 1e-5},
    "fused_adam": {"rtol": 1e-6, "atol": 1e-7},
    "flash_attention_bf16": {"rtol": 1e-2, "atol": 1e-4},
    "rmsnorm_bf16": {"rtol": 1e-2, "atol": 1e-5},
    "ssd_scan_bf16": {"rtol": 1e-2, "atol": 1e-5},
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


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)      # B, C at group level
        ctx.chunk = chunk
        if on_card(x):
            return ssd_scan_cuda(x, dt, A, B, C, chunk)
        rep = x.shape[2] // B.shape[2]
        return ref.ssd_reference(x, dt, A, B.repeat_interleave(rep, dim=2),
                                 C.repeat_interleave(rep, dim=2))[0]

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().float().requires_grad_(need)
                   for t, need in zip(saved, needs)]
            y, _ = ref.ssd_chunked(*ins, ctx.chunk)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g.float()))
        return tuple(next(grads).to(t.dtype) if need else None
                     for t, need in zip(saved, needs)) + (None,)


def _mask_scale(x, key, sample_ids, p, r):
    if on_card(x):
        return threefry_dropout_cuda(x, key, sample_ids, p, r)
    return ref.dropout_reference(x, key, sample_ids, p, r)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, sample_ids, p, r):
        ctx.save_for_backward(sample_ids)
        ctx.key, ctx.p, ctx.r = key, p, r
        return _mask_scale(x, key, sample_ids, p, r)

    @staticmethod
    def backward(ctx, g):
        (sample_ids,) = ctx.saved_tensors
        return (_mask_scale(g, ctx.key, sample_ids, ctx.p, ctx.r),
                None, None, None, None)


def dropout(x, key, sample_ids, rate: float):
    """Content-addressed dropout of x [B, ...]: sample b's mask is
    ``bernoulli(fold_in(key, sample_ids[b]), 1 - rate, x.shape[1:])`` and a
    kept element is scaled as the jitted reference scales it
    (``threefry.dropout_scalars``).  ``key`` is the op's folded key
    ``(k0, k1)`` (host integers); ``sample_ids`` [B] int32 on x's device.
    The gradient is the same function of the cotangent."""
    p, r = dropout_scalars(rate, x.dtype)
    return _Dropout.apply(x, key, sample_ids, p, r)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, initial_state=None):
    """Mamba2 SSD, model-layer layout: x [b,s,h,p], dt [b,s,h], A [h],
    B, C [b,s,g,n] (groups).  Returns ``(y, None)``, in the place of
    ``ref.ssd_chunked``'s ``(y, final_state)``: no final state.

    Scans from a zero state (the training path): a non-``None`` state
    raises, as does ``s % min(chunk, s) != 0``, which the TPU kernel
    asserts."""
    if initial_state is not None:
        raise ValueError(
            "ssd_scan: initial_state is not supported by the kernel (it "
            "always scans from a zero state); pass initial_state=None or use "
            "ref.ssd_chunked for the resume-from-state (prefill/decode) path")
    b, s, h, p = x.shape
    g = B.shape[2]
    if g <= 0 or h % g != 0:
        raise ValueError(
            f"ssd_scan: num_heads h={h} is not a multiple of ngroups g={g} "
            f"— the group broadcast repeats each B/C group h//g times and "
            f"requires h % g == 0")
    chunk = min(chunk, s)
    if s % chunk != 0:
        raise ValueError(f"ssd_scan: seq len s={s} is not a multiple of "
                         f"chunk={chunk}")
    return _SSDScan.apply(x, dt, A, B, C, chunk), None


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
