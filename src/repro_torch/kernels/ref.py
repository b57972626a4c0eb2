"""Plain PyTorch versions of every kernel (the correctness ground truth).

The wrappers in ``ops.py`` run these for CPU tensors; ``chip_smoke.py``
holds each CUDA kernel against them on the card; the kernels' backward
passes differentiate them.
"""
from __future__ import annotations

from typing import Dict

import torch


def mha_reference(q, k, v, *, causal: bool = True, sm_scale=None):
    """q,k,v: [BH, S, d] -> [BH, S, d]; fp32 softmax like the kernel."""
    BH, S, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def gqa_attention_reference(q, k, v, *, causal: bool = True):
    """q: [B,S,H,hd]; k,v: [B,S,Hkv,hd] -> [B,S,H,hd]: kv heads repeated
    H//Hkv times and heads folded into the batch, as the reference wrapper
    does before its MHA kernel."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, S, hd)
    kf = k.transpose(1, 2).reshape(B * H, S, hd)
    vf = v.transpose(1, 2).reshape(B * H, S, hd)
    o = mha_reference(qf, kf, vf, causal=causal)
    return o.reshape(B, H, S, hd).transpose(1, 2)


def rmsnorm_reference(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def adam_flat_reference(grad: torch.Tensor, master: torch.Tensor,
                        mu: torch.Tensor, nu: torch.Tensor,
                        scalars: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """AdamW over flat f32 vectors in ``adam_update_flat_np``'s op order.

    ``scalars`` are the f32-rounded constants of ``ops.adam_scalars``; each
    is applied as a 0-d tensor on the data's device (a Python scalar divisor
    may be turned into a multiply by its reciprocal).  ``torch.sqrt`` on CPU
    float32 is not correctly rounded, so the square root is taken in float64
    and rounded once, which is.  Returns new {master, mu, nu} tensors."""
    c = {k: torch.tensor(v, dtype=torch.float32, device=grad.device)
         for k, v in scalars.items()}
    mu = c["b1"] * mu + c["omb1"] * grad
    nu = c["b2"] * nu + c["omb2"] * grad * grad
    root = torch.sqrt((nu / c["b2t"]).double()).float()
    upd = (mu / c["b1t"]) / (root + c["eps"]) + c["wd"] * master
    master = master - c["lr"] * upd
    return {"master": master, "mu": mu, "nu": nu}
