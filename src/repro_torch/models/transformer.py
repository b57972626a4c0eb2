"""Decoder blocks (attention or Mamba2 mixer, dense or MoE MLP), the
whole-model forward with caches, the serving prefill/decode steps and the
loss, mirroring ``repro.models.transformer``.

The whole model is the port's per-layer layout ``(stem, layers, head)``
(``registry.init_model``; ``weights.params_from_stacked`` turns the
reference's stacked tree into it), and its caches a per-layer list
(:func:`init_caches`), the batch (slot) axis first in every tensor, where
the reference stacks layers of a segment on a leading axis.  Caches are
updated in place.

Attention blocks are GQA or, under ``cfg.use_mla``, deepseek-v3's latent
attention (``layers.apply_mla``), whose cache is the latent pair
``{"c_kv", "k_rope"}``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .config import ATTN, ATTN_MOE, MAMBA, MAMBA_MOE, ModelConfig
from . import layers as L
from . import mamba as M
from . import moe as X


def _is_attn(blk: str) -> bool:
    return blk in (ATTN, ATTN_MOE)


def _is_moe(blk: str) -> bool:
    return blk in (ATTN_MOE, MAMBA_MOE)


def _has_mlp(cfg: ModelConfig, blk: str) -> bool:
    """Pure-SSM blocks (mamba2, d_ff=0) are mixer-only: no MLP sublayer."""
    return _is_moe(blk) or cfg.d_ff > 0


def _check_ported(cfg: ModelConfig, blk: str) -> None:
    if blk not in (ATTN, ATTN_MOE, MAMBA, MAMBA_MOE):
        raise NotImplementedError(
            f"block {blk!r} is not ported yet: the port runs attention (GQA "
            f"or MLA) and Mamba2 blocks with dense or MoE MLPs")


def init_block(gen: torch.Generator, cfg: ModelConfig,
               blk: str) -> Dict[str, Any]:
    _check_ported(cfg, blk)
    dev = gen.device
    p: Dict[str, Any] = {"ln1": L.init_rmsnorm(cfg.d_model, dev)}
    if _is_attn(blk):
        p["attn"] = L.init_mla(gen, cfg) if cfg.use_mla \
            else L.init_attention(gen, cfg)
    else:
        p["mamba"] = M.init_mamba(gen, cfg)
    if _has_mlp(cfg, blk):
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dev)
        if _is_moe(blk):
            p["moe"] = X.init_moe(gen, cfg)
        else:
            p["mlp"] = L.init_mlp(gen, cfg)
    return p


def apply_block(params, cfg: ModelConfig, blk: str, x, positions,
                rng_ctx: L.RngCtx, layer_id: int, cache=None,
                cache_index=None, rows=None):
    """Returns (x, aux_loss).  ``cache`` (the block's KV cache or SSM
    state) is updated in place at ``cache_index``, in the batch rows
    ``rows`` (None: all); an MoE MLP routes only those rows."""
    _check_ported(cfg, blk)
    ctx = rng_ctx.layer(layer_id)
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if _is_attn(blk):
        attend = L.apply_mla if cfg.use_mla else L.apply_attention
        a, _ = attend(params["attn"], cfg, h, positions, kv_cache=cache,
                      cache_index=cache_index, rows=rows)
    else:
        a, _ = M.apply_mamba(params["mamba"], cfg, h, state=cache,
                             cache_index=cache_index, rows=rows)
    x = x + L.dropout(a, cfg.dropout_rate, ctx, op_id=0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _has_mlp(cfg, blk):
        h = L.rmsnorm(params["ln2"], x, cfg.norm_eps)
        if _is_moe(blk):
            m, aux = X.apply_moe(params["moe"], cfg, h, rows=rows)
        else:
            m = L.apply_mlp(params["mlp"], cfg, h)
        x = x + L.dropout(m, cfg.dropout_rate, ctx, op_id=1)
    return x, aux


def init_block_cache(cfg: ModelConfig, blk: str, batch: int, max_len: int,
                     device=None):
    """A block's zero cache: k/v [batch, max_len, Hkv, hd] (MLA: c_kv and
    k_rope) in the model's dtype for attention, the Mamba2 state
    otherwise."""
    dt = cfg.torch_dtype
    if _is_attn(blk):
        if cfg.use_mla:
            return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                        dtype=dt, device=device),
                    "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                          dtype=dt, device=device)}
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    return M.init_mamba_state(cfg, batch, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> List[Dict[str, torch.Tensor]]:
    """One zero cache per physical layer, in layer order (the reference's
    stacked caches, unstacked); ``device="meta"`` gives shapes only."""
    types: List[str] = []
    for pat, rep in cfg.block_pattern():
        types.extend(list(pat) * rep)
    return [init_block_cache(cfg, blk, batch, max_len, device)
            for blk in types]


def forward(params, cfg: ModelConfig, tokens, *, caches=None,
            cache_index=None, rows=None, last_only: bool = False):
    """tokens: [B,S] -> (logits [B,S,V], caches, aux_loss), over the
    port's ``(stem, layers, head)``.  With ``caches`` the prefix is
    written at ``cache_index`` (0: a prefill; [B] positions: a decode
    step), in the rows ``rows`` (None: all), in place.  ``last_only``
    keeps the last position alone before the final norm and head (a
    prefill samples from it; rows are independent there)."""
    stem, layers, head = params
    x = L.embed(stem["embed"], tokens)
    B, S, _ = x.shape
    offs = torch.arange(S, device=x.device)[None, :]
    if cache_index is None:
        positions = offs.expand(B, S)
    else:
        positions = L.cache_positions(cache_index, B, x.device)[:, None] \
            + offs
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    types = [blk for pat, rep in cfg.block_pattern()
             for blk in list(pat) * rep]
    ctx = L.RngCtx()
    for i, (blk, p) in enumerate(zip(types, layers)):
        c = caches[i] if caches is not None else None
        x, aux = apply_block(p, cfg, blk, x, positions, ctx, i, cache=c,
                             cache_index=cache_index, rows=rows)
        aux_total = aux_total + aux
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(head["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(head["head"], x), caches, aux_total


def prefill(params, cfg: ModelConfig, tokens, caches):
    """Prefill: write the whole prompt into the caches (index 0).
    Returns (logits [B,1,V], caches)."""
    logits, caches, _ = forward(params, cfg, tokens, caches=caches,
                                cache_index=0, last_only=True)
    return logits, caches


def decode_step(params, cfg: ModelConfig, tokens, caches, cache_index,
                rows=None):
    """One-token decode: tokens [B,1] at positions ``cache_index`` [B] ->
    (logits [B,1,V], caches); only the rows ``rows`` (None: all) write
    their caches."""
    logits, caches, _ = forward(params, cfg, tokens, caches=caches,
                                cache_index=cache_index, rows=rows)
    return logits[:, -1:, :], caches


def softmax_xent(logits, labels, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0] - logz
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
