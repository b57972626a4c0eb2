"""Primitive layers of the dense decoder (training subset), in PyTorch.

Mirrors ``repro.models.layers``: plain functions on tensors, parameters as
dicts of tensors in the reference's ``[in, out]`` layout (``x @ W``), so
flattened parameter vectors line up element for element with the JAX
package's.  ``init_*`` take an explicit ``torch.Generator``; its numbers
differ from ``jax.random``'s, so twin runs carry weights across
(``repro_torch.weights``).

**Content-addressed RNG**, as the reference's: every random op derives its
key as ``fold_in(fold_in(fold_in(step_key, layer_id), op_id), sample_id)``
(``jax.random``'s threefry2x32, computed bit for bit by
``kernels/threefry.py``), so a dropout mask depends only on (step, layer,
op, sample), never on which rank or micro-batch slot computes it.  The
folds down to the op run on the host; the sample-id fold and the draws run
in the dropout kernel (``kernels/ops.dropout``).

**KV caches** (the serving plane): a layer's cache is a dict of
``[B, T, Hkv, hd]`` tensors in the model's dtype (MLA: the latent
``c_kv`` [B, T, r_kv] and ``k_rope`` [B, T, dr]), updated in place (the
reference returns a new pytree with the same values).  A prefill (a scalar
``cache_index`` 0) is causal self-attention over the prompt's own keys,
through the flash-attention kernel, then they are written into the cache;
a decode step (per-row positions) attends over the cache in plain tensor
code, as the reference does (it has no kernel there).  The cache holds the
model's dtype, so the prompt's own keys are what a read-back would give.

**MLA** (deepseek-v3's latent attention) and the **chunked path**
(``cfg.attn_chunked``, online softmax in plain tensor code) reach no kernel
in the reference either: MLA's qk head (nope + rope) is wider than its v
head, which the flash kernel does not take, so :func:`apply_mla` hands
:func:`_attend` the plain :func:`_sdpa_plain` by name, never the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.threefry import fold_in
from repro_torch.parallel import dtensor as DT
from .config import ModelConfig


# --------------------------------------------------------------------------
# RNG context (content-addressed randomness)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RngCtx:
    """Identity-addressed randomness for computation consistency:
    ``step_key`` (``fold_in(base_key, step)``, then folded by layer) and the
    global ``sample_ids`` of the batch address every random op, never the
    rank computing it."""
    step_key: Optional[np.ndarray] = None        # uint32[2] key data
    sample_ids: Optional[torch.Tensor] = None    # [batch] int32, x's device
    deterministic: bool = True

    def layer(self, layer_id: int) -> "RngCtx":
        if self.deterministic or self.step_key is None:
            return self
        return dataclasses.replace(
            self, step_key=fold_in(self.step_key, layer_id))


def dropout(x: torch.Tensor, rate: float, ctx: RngCtx,
            op_id: int = 0) -> torch.Tensor:
    """Per-sample content-addressed dropout. x: [batch, seq, ...]."""
    if ctx.deterministic or rate <= 0.0 or ctx.step_key is None:
        return x
    return ops.dropout(x, fold_in(ctx.step_key, op_id), ctx.sample_ids, rate)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def init_rmsnorm(d: int, device=None) -> Dict[str, Any]:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    return ops.rmsnorm(x, params["scale"], eps=eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                       # [hd/2]
    angles = positions[..., :, None].float() * freqs              # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Dense init helper
# --------------------------------------------------------------------------
def _dense(gen: torch.Generator, shape, dtype, scale=None):
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


# --------------------------------------------------------------------------
# Attention (GQA)
# --------------------------------------------------------------------------
def init_attention(gen, cfg: ModelConfig) -> Dict[str, Any]:
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    return {
        "wq": _dense(gen, (d, H * hd), dt),
        "wk": _dense(gen, (d, Hkv * hd), dt),
        "wv": _dense(gen, (d, Hkv * hd), dt),
        "wo": _dense(gen, (H * hd, d), dt),
    }


def _sdpa(q, k, v, causal: bool, q_offset=None):
    """q: [B,S,H,hd]; k,v: [B,T,Hkv,hd]. GQA broadcast. Returns [B,S,H,hd].

    Aligned attention (no offset, S == T) goes to the flash-attention
    kernel, as the reference's ``use_pallas`` gate sends it; attention over
    a KV cache (``q_offset``) and the enc-dec model's cross-attention
    (S != T) are :func:`_sdpa_plain`."""
    if q_offset is None and q.shape[1] == k.shape[1]:
        return DT.per_head_shard(
            lambda q, k, v: ops.flash_attention(q, k, v, causal=causal), q,
            (k, v))
    return _sdpa_plain(q, k, v, causal, q_offset)


def _causal_mask(q_pos, k_pos, q_offset=None) -> torch.Tensor:
    """[B or 1, S, T] bool: key ``k_pos[t]`` visible to query ``q_pos[s]``
    (each row's queries moved by ``q_offset`` [B] when given: attention
    over a cache).  Aligned q/k of one length give the lower triangle."""
    q_pos = q_pos[None] if q_offset is None else \
        q_offset[:, None] + q_pos[None]
    return q_pos[..., None] >= k_pos


def _sdpa_plain(q, k, v, causal: bool, q_offset=None):
    """The reference's plain attention: q [B,S,H,hd], k [B,T,Hkv,hd], v
    [B,T,Hkv,hd_v] (hd_v may differ: MLA) -> [B,S,H,hd_v].  ``q_offset``
    ([B] position of q[:, 0] within the keys: attention over a KV cache)
    masks keys past each query's position; without it a causal mask is
    the reference's bottom-right ``tril(k=T-S)``: query s sees keys up to
    s + T - S (the lower triangle when S == T).  Not causal (the enc-dec
    model's cross-attention, S != T) there is no mask.  q·k in q's dtype
    (float32 accumulation, one rounding), then the softmax in float32 and
    the probabilities in q's dtype, as the reference rounds.  On
    ``DTensor``s (the dry run) each device attends with its rows and heads
    (``parallel.dtensor.per_head_shard``; a cache split over its sequence
    is gathered)."""
    if DT.is_dtensor(q):
        return DT.per_head_shard(
            lambda q, k, v, off: _sdpa_plain(q, k, v, causal, off), q,
            (k, v), ((q_offset, 0, None),))
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qr = q.reshape(B, S, Hkv, H // Hkv, hd)
    logits = torch.einsum("bskrh,btkh->bkrst", qr, k).float()
    logits = logits * hd ** -0.5
    if causal:
        q_pos = torch.arange(S, device=q.device)
        if q_offset is None:
            q_pos = q_pos + (T - S)         # bottom-right: tril(k=T-S)
        mask = _causal_mask(q_pos, torch.arange(T, device=q.device),
                            q_offset)
        logits = torch.where(mask[:, None, None], logits,
                             torch.full((), -1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkrst,btkh->bskrh", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


def _sdpa_chunked(q, k, v, causal: bool, chunk_q: int = 512,
                  chunk_kv: int = 1024, q_offset=None):
    """Online-softmax attention in plain tensor code (flash semantics), the
    reference's ``_sdpa_chunked``: peak live logits are
    [B, Hkv, rep, cq, ckv] instead of [B, H, S, T].  q [B,S,H,hd], k
    [B,T,Hkv,hd], v [B,T,Hkv,hd_v]; float32 math, output in q's dtype.

    q_offset: optional [B] per-sample position of q[:, 0] within the key
    sequence (prefill-into-cache); None: q and k aligned."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    rep = H // Hkv
    cq, ckv = min(chunk_q, S), min(chunk_kv, T)
    pad_q, pad_kv = (-S) % cq, (-T) % ckv
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_kv)) if pad_kv else k
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_kv)) if pad_kv else v
    nq, nk = qp.shape[1] // cq, kp.shape[1] // ckv
    qb = qp.reshape(B, nq, cq, Hkv, rep, hd).float()
    kb = kp.reshape(B, nk, ckv, Hkv, hd).float()
    vb = vp.reshape(B, nk, ckv, Hkv, hd_v).float()
    scale = hd ** -0.5
    dev = q.device
    neg = torch.full((), -1e30, device=dev)
    r_iota = torch.arange(cq, device=dev)
    c_iota = torch.arange(ckv, device=dev)
    outs = []
    for qi in range(nq):
        qblk = qb[:, qi]                                  # [B,cq,Hkv,rep,hd]
        m = torch.full((B, Hkv, rep, cq), -1e30, device=dev)
        l = torch.zeros((B, Hkv, rep, cq), device=dev)
        acc = torch.zeros((B, cq, Hkv, rep, hd_v), device=dev)
        for ki in range(nk):
            s = torch.einsum("bqkrh,btkh->bkrqt", qblk, kb[:, ki]) * scale
            rows = qi * cq + r_iota
            cols = ki * ckv + c_iota
            valid = (cols < T)[None, None]                # [1,1,ckv]
            if causal:
                valid = valid & _causal_mask(rows, cols, q_offset)
            s = torch.where(valid[:, None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bkrqt,btkh->bqkrh", p, vb[:, ki])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(B, nq * cq, H, hd_v)
    return out[:, :S]


def _attend(cfg: ModelConfig, q, k, v, causal: bool, q_offset=None,
            plain=_sdpa):
    """Attention by the config's path, as the reference picks it: the
    chunked online softmax under ``cfg.attn_chunked`` for aligned q/k or a
    cached step of more than one token, else ``plain``: :func:`_sdpa` (the
    flash kernel for aligned q/k, the plain form over a cache) or, for
    MLA, :func:`_sdpa_plain`."""
    if cfg.attn_chunked and (q_offset is None or q.shape[1] > 1):
        return _sdpa_chunked(q, k, v, causal=causal, chunk_q=cfg.attn_chunk_q,
                             chunk_kv=cfg.attn_chunk_kv, q_offset=q_offset)
    return plain(q, k, v, causal, q_offset)


def is_prefill(cache_index) -> bool:
    """True for the prefill's cache index, a Python 0, the start of every
    sequence; False for a decode step's positions, a tensor ([B] per row,
    or a 0-d one for every row: the decode cells' index).  Decided from
    what the caller passes, never from a tensor's value, which a meta
    tensor (the dry run) does not have."""
    return isinstance(cache_index, (int, np.integer)) and cache_index == 0


def cache_positions(cache_index, batch: int, device) -> torch.Tensor:
    """The per-row write offsets [B] (int64) of a scalar or [B] index."""
    idx = torch.as_tensor(cache_index, dtype=torch.int64, device=device)
    return idx.expand(batch) if idx.dim() == 0 else idx


def apply_attention(params, cfg: ModelConfig, x, positions,
                    kv_cache: Optional[Dict] = None, cache_index=None,
                    causal: bool = True, rows=None):
    """x: [B,S,d] -> ([B,S,d], cache).  With ``kv_cache``, k/v are written
    at ``cache_index`` (0 for a prefill, [B] positions for a decode step)
    and the cache, updated in place, is returned; ``rows`` ([n] batch rows,
    None = all) limits the writes to those rows, so that a batch may carry
    rows whose caches must not change (the engine's fixed-width decode)."""
    B = x.shape[0]
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = DT.split_last(x @ params["wq"], H, hd)
    k = DT.split_last(x @ params["wk"], Hkv, hd)
    v = DT.split_last(x @ params["wv"], Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        idx = cache_positions(cache_index, B, x.device)
        _scatter_seq(kv_cache["k"], k, idx, rows)
        _scatter_seq(kv_cache["v"], v, idx, rows)
    if kv_cache is None or is_prefill(cache_index):
        out = _attend(cfg, q, k, v, causal)
    else:
        out = _attend(cfg, q, kv_cache["k"].to(q.dtype),
                      kv_cache["v"].to(q.dtype), causal, q_offset=idx)
    return DT.merge_heads(out) @ params["wo"], kv_cache


def _scatter_seq(cache, new, index, rows=None) -> None:
    """cache[b, index[b]:index[b]+S] = new[b] in place, for the batch rows
    ``rows`` (None: all).  cache: [B,T,...]; new: [B,S,...]; index: [B].
    A ``DTensor`` cache (the dry run; every row) takes
    ``parallel.dtensor.scatter_seq_``."""
    if DT.is_dtensor(cache):
        if rows is not None:
            raise ValueError("rows= on a DTensor cache: no cell passes it")
        DT.scatter_seq_(cache, new, index)
        return
    B, S = new.shape[:2]
    r = torch.arange(B, device=new.device) if rows is None \
        else torch.as_tensor(rows, dtype=torch.int64, device=new.device)
    cols = index[r][:, None] + torch.arange(S, device=new.device)[None]
    cache[r[:, None], cols] = new[r].to(cache.dtype)


# --------------------------------------------------------------------------
# MLA attention (deepseek-v3)
# --------------------------------------------------------------------------
def init_mla(gen, cfg: ModelConfig) -> Dict[str, Any]:
    d, H = cfg.d_model, cfg.num_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt, dev = cfg.torch_dtype, gen.device
    p = {
        "wkv_a": _dense(gen, (d, r_kv + dr), dt),
        "kv_norm": init_rmsnorm(r_kv, dev),
        "wkv_b": _dense(gen, (r_kv, H * (dn + dv)), dt),
        "wo": _dense(gen, (H * dv, d), dt),
    }
    if r_q:
        p["wq_a"] = _dense(gen, (d, r_q), dt)
        p["q_norm"] = init_rmsnorm(r_q, dev)
        p["wq_b"] = _dense(gen, (r_q, H * (dn + dr)), dt)
    else:
        p["wq"] = _dense(gen, (d, H * (dn + dr)), dt)
    return p


def _mla_absorbed(q_nope, q_rope, c_kv, k_rope, kvb, dn: int, scale: float,
                  q_offset=None):
    """The absorbed form, all in float32: scores are
    ``q_nope (W_kv_b^K)^T c_kv + q_rope k_rope`` and the output
    ``softmax · c_kv · W_kv_b^V``, so the latent keys are never expanded to
    per-head keys and values.  -> [B,S,H,dv] float32."""
    S, T = q_nope.shape[1], c_kv.shape[1]
    c = c_kv.float()
    qn_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                          kvb[..., :dn].float())                # [B,S,H,r]
    s_nope = torch.einsum("bshr,btr->bhst", qn_lat, c)
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    logits = (s_nope + s_rope) * scale
    mask = _causal_mask(torch.arange(S, device=c.device),
                        torch.arange(T, device=c.device), q_offset)
    logits = torch.where(mask[:, None], logits,
                         torch.full((), -1e30, device=c.device))
    probs = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs, c)             # [B,S,H,r]
    return torch.einsum("bshr,rhn->bshn", o_lat, kvb[..., dn:].float())


def apply_mla(params, cfg: ModelConfig, x, positions,
              kv_cache: Optional[Dict] = None, cache_index=None, rows=None):
    """Multi-head Latent Attention: x [B,S,d] -> ([B,S,d], cache).  The
    cache is the latent ``{"c_kv", "k_rope"}``, written as
    :func:`apply_attention` writes k/v (in place, the rows ``rows``); a
    prefill attends over the prompt's own latents, a decode step over the
    cache.  Under ``cfg.mla_absorb`` a cached call runs the absorbed form
    (:func:`_mla_absorbed`); otherwise the latents are expanded to per-head
    keys and values and attended by :func:`_attend` with the plain
    :func:`_sdpa_plain` passed by name (or, under ``cfg.attn_chunked``,
    :func:`_sdpa_chunked`): never the flash kernel, whose v head must be
    q's width."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    if cfg.q_lora_rank:
        # on DTensors (the dry run) the norm's row is split over ``model``
        # with wq_a's columns: gathered first
        q = rmsnorm(params["q_norm"], DT.gather_dim(x @ params["wq_a"], -1),
                    cfg.norm_eps) @ params["wq_b"]
    else:
        q = x @ params["wq"]
    q = q.reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)

    kv = x @ params["wkv_a"]                                # [B,S,r_kv+dr]
    c_kv = rmsnorm(params["kv_norm"], kv[..., :r_kv], cfg.norm_eps)
    k_rope = apply_rope(kv[:, :, None, r_kv:], positions,
                        cfg.rope_theta)[:, :, 0, :]
    q_offset = None
    if kv_cache is not None:
        idx = cache_positions(cache_index, B, x.device)
        _scatter_seq(kv_cache["c_kv"], c_kv, idx, rows)
        _scatter_seq(kv_cache["k_rope"], k_rope, idx, rows)
        if not is_prefill(cache_index):
            q_offset = idx
            c_kv = kv_cache["c_kv"].to(x.dtype)
            k_rope = kv_cache["k_rope"].to(x.dtype)

    kvb = DT.split_last(params["wkv_b"], H, dn + dv)
    cached = kv_cache is not None

    def core(q_nope, q_rope, c_kv, k_rope, kvb, q_offset):
        return _mla_core(cfg, q_nope, q_rope, c_kv, k_rope, kvb, q_offset,
                         cached, x.dtype)

    out = DT.per_head_shard(core, q_nope, (),
                            ((q_rope, 0, 2), (c_kv, 0, None),
                             (k_rope, 0, None), (kvb, None, 1),
                             (q_offset, 0, None)))
    return out.reshape(B, S, H * dv) @ params["wo"], kv_cache


def _mla_core(cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope, kvb,
              q_offset, cached: bool, dtype):
    """MLA's attention from its queries, latents and ``kvb`` [r, H,
    dn + dv] -> [B, S, H, dv] in ``dtype``: the absorbed form under
    ``cfg.mla_absorb`` with a cache, else the latents expanded to per-head
    keys and values.  On ``DTensor``s (the dry run) :func:`apply_mla` runs
    it on each device's rows and heads (a latent cache split over its
    sequence gathered)."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    B, _, H, _ = q_nope.shape
    if cfg.mla_absorb and cached:
        return _mla_absorbed(q_nope, q_rope, c_kv, k_rope, kvb, dn,
                             (dn + dr) ** -0.5, q_offset).to(dtype)
    # expand the latents to per-head keys and values
    k_nope = torch.einsum("btr,rhn->bthn", c_kv, kvb[..., :dn])
    v = torch.einsum("btr,rhn->bthn", c_kv, kvb[..., dn:])
    T = k_nope.shape[1]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, dr)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    return _attend(cfg, qf, k, v, True, q_offset, plain=_sdpa_plain)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    if cfg.activation == "relu2":          # nemotron: squared-ReLU, ungated
        return {"wi": _dense(gen, (d, ff), dt), "wo": _dense(gen, (ff, d), dt)}
    return {
        "wg": _dense(gen, (d, ff), dt),
        "wu": _dense(gen, (d, ff), dt),
        "wo": _dense(gen, (ff, d), dt),
    }


def apply_mlp(params, cfg: ModelConfig, x) -> torch.Tensor:
    if cfg.activation == "relu2":
        h = torch.relu(x @ params["wi"])
        return (h * h) @ params["wo"]
    g = x @ params["wg"]
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if cfg.activation == "gelu" \
        else F.silu(g)
    return (act * (x @ params["wu"])) @ params["wo"]


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------
def init_embedding(gen, cfg: ModelConfig) -> Dict[str, Any]:
    return {"embedding": _dense(gen, (cfg.vocab_size, cfg.d_model),
                                cfg.torch_dtype, scale=1.0)}


def embed(params, tokens):
    return DT.embed_rows(params["embedding"], tokens.long())


def init_lm_head(gen, cfg: ModelConfig) -> Dict[str, Any]:
    return {"w": _dense(gen, (cfg.d_model, cfg.vocab_size), cfg.torch_dtype)}


def lm_logits(head_params, x):
    return x @ head_params["w"]
