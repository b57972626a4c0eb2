"""Plain PyTorch versions of every kernel (the correctness ground truth).

The wrappers in ``ops.py`` run these for CPU tensors; ``chip_smoke.py``
holds each CUDA kernel against them on the card; the kernels' backward
passes differentiate them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def mha_reference(q, k, v, *, causal: bool = True, sm_scale=None):
    """q,k,v: [BH, S, d] -> [BH, S, d]; fp32 softmax like the kernel
    (float64 when every operand is float64, a witness for the float32
    versions)."""
    BH, S, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    acc = torch.float64 if all(t.dtype == torch.float64
                               for t in (q, k, v)) else torch.float32
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) * sm_scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(acc)).to(q.dtype)


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


def ssd_reference(x, dt, A, Bh, Ch, initial_state=None):
    """Sequential (recurrent) SSD oracle, O(S), exact in float32.

    x: [b,s,h,p]; dt: [b,s,h]; A: [h]; Bh, Ch: [b,s,h,n] (groups already
    broadcast to heads).  The state is float32 (float64 when every operand
    is float64, a second witness for the float32 versions); y is cast to
    x's dtype.  Returns (y [b,s,h,p], final_state [b,h,p,n])."""
    b, s, h, p = x.shape
    n = Bh.shape[-1]
    acc = torch.float64 if all(t.dtype == torch.float64
                               for t in (x, dt, A, Bh, Ch)) else torch.float32
    state = torch.zeros((b, h, p, n), dtype=acc, device=x.device) \
        if initial_state is None else initial_state.to(acc)
    dt, A = dt.to(acc), A.to(acc)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A[None, :])                     # [b,h]
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, t], x[:, t].to(acc),
                           Bh[:, t].to(acc))
        state = dA[:, :, None, None] * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t].to(acc)))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan (Mamba2 algorithm 3), the plain tensor form of the
    SSD kernel; ``ops.ssd_scan``'s backward differentiates it.

    x: [b,s,h,p]; dt: [b,s,h] (softplus-activated, >= 0); A: [h] (< 0);
    B, C: [b,s,g,n] (g groups broadcast over heads).  A ragged tail is
    zero-padded (dt = 0: no state update; padded y dropped).  As in the
    reference, CB, y_intra and y_inter are taken in the inputs' dtype and
    the carried chunk states in float32.

    One departure from the reference's arithmetic: the decay exponents
    sum_{j<k<=i} dt_k A are summed over their own segment (Mamba2's
    ``segsum``), not taken as cum_i - cum_j.  With dt ~ 1 and |A| up to 16
    the float32 cumsum reaches ~-3e3 late in a 256-row chunk, and the
    difference of two such sums keeps only ~1e-4 relative precision.
    Returns (y [b,s,h,p], final_state [b,h,p,n])."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-s) % chunk
    s_orig = s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = (dtc * A).permute(0, 1, 3, 2)                       # [b,nc,h,c] <= 0
    cum = torch.cumsum(dA, dim=-1)
    seg_total = cum[..., -1]                                 # [b,nc,h]

    # intra-chunk: L[i,j] = exp(sum_{j<k<=i} dA_k) for i >= j.  Mask before
    # exp: the upper triangle would be positive and overflow (NaN grads).
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device)
    seg = torch.where(ones.tril(-1), dA[..., :, None],
                      torch.zeros((), dtype=dA.dtype, device=x.device))
    seg = torch.cumsum(seg, dim=-2)                          # [b,nc,h,c,c]
    L = torch.exp(torch.where(ones.tril(), seg,
                              torch.full_like(seg, -1e30)))
    CB = torch.einsum("bzchn,bzkhn->bzhck", Ch, Bh)          # [b,nc,h,c,c]
    xdt = xc * dtc[..., None]                                # [b,nc,c,h,p]
    y_intra = torch.einsum("bzhck,bzkhp->bzchp", CB * L.to(CB.dtype),
                           xdt.to(CB.dtype))

    # chunk states, float32 for the carried recurrence
    decay_to_end = torch.exp(seg[..., -1, :]).transpose(2, 3)  # [b,nc,c,h]
    states = torch.einsum("bzchn,bzchp->bzhpn",
                          Bh.float() * (dtc * decay_to_end).float()[..., None],
                          xc.float())                         # [b,nc,h,p,n]
    seg_decay = torch.exp(seg_total)                          # [b,nc,h]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
    entry = []                                  # state entering each chunk
    for z in range(nc):
        entry.append(state)
        state = states[:, z] + seg_decay[:, z, :, None, None] * state
    entry_states = torch.stack(entry, dim=1)                  # [b,nc,h,p,n]

    # contribution of the entering state
    y_inter = torch.einsum("bzchn,bzhpn->bzchp", Ch,
                           entry_states.to(Ch.dtype)) \
        * torch.exp(cum).transpose(2, 3).to(Ch.dtype)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    if pad:
        y = y[:, :s_orig]
    return y, state


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


# --------------------------------------------------------------------------
# content-addressed threefry dropout (csrc/threefry_dropout.cu)
# --------------------------------------------------------------------------
# Threefry-2x32's constants, written out here so that the plain version
# shares nothing with the program it checks (kernels/threefry.py)
MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32_reference(k0, k1, x0, x1):
    """``threefry.threefry2x32`` on int64 tensors holding uint32 values
    (keys and counters broadcast): every sum masked to 32 bits, rotations
    as two shifts.  Returns ``(y0, y1)``."""
    k2 = k0 ^ k1 ^ KS_PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def threefry_bits(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The 32 random bits of flat indices ``idx`` (int64 [n]) of one draw
    per key (``keys`` int64 [B, 2]): ``y0 ^ y1`` of the counter
    ``(idx >> 32, idx & 0xFFFFFFFF)``, the partitionable layout.
    Returns int64 [B, n]."""
    y0, y1 = threefry2x32_reference(keys[:, 0:1], keys[:, 1:2],
                                    (idx >> 32)[None], (idx & MASK)[None])
    return y0 ^ y1


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, as int64) of each key of
    ``keys`` int64 [B, 2] -> [B, *shape]."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry_bits(keys, idx).reshape(keys.shape[0], *shape)


def bernoulli_keep(keys: torch.Tensor, shape: Sequence[int],
                   p: float) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` of each key -> bool
    [B, *shape]."""
    return keep_from_bits(random_bits(keys, shape), p)


def keep_from_bits(bits: torch.Tensor, p: float) -> torch.Tensor:
    """The bernoulli(p) decision of 32 random bits (int64 holding uint32):
    the uniform in [0, 1) from the top 23 bits, compared with ``p`` (a
    float32 value) in float32."""
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u < torch.tensor(p, dtype=torch.float32, device=bits.device)


def sample_keys(key, sample_ids: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, sid)`` of each sample id -> int64 [B, 2]."""
    sid = sample_ids.to(torch.int64) & MASK
    k0, k1 = (torch.tensor(int(k) & MASK, dtype=torch.int64,
                           device=sid.device) for k in key)
    y0, y1 = threefry2x32_reference(k0, k1, torch.zeros_like(sid), sid)
    return torch.stack([y0, y1], dim=1)


def dropout_reference(x: torch.Tensor, key, sample_ids: torch.Tensor,
                      p: float, r: float) -> torch.Tensor:
    """``keep ? round(fl32(x) * r) : 0`` for x [B, ...], with ``keep`` the
    bernoulli(p) mask of ``fold_in(key, sample_ids[b])`` over x.shape[1:]
    (``threefry.dropout_scalars`` gives p and r).  Forward and backward of
    dropout alike: the reference's jitted gradient is the same function of
    the cotangent."""
    keep = bernoulli_keep(sample_keys(key, sample_ids), x.shape[1:], p)
    scale = torch.tensor(r, dtype=torch.float32, device=x.device)
    return torch.where(keep, (x.float() * scale).to(x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))
