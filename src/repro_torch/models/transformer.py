"""Decoder blocks (ATTN and MAMBA branches) and loss, mirroring
``repro.models.transformer``.

MoE blocks, MLA, the stacked whole-model forward and the serving
prefill/decode paths wait for later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .config import ATTN, ATTN_MOE, MAMBA, MAMBA_MOE, ModelConfig
from . import layers as L
from . import mamba as M


def _is_attn(blk: str) -> bool:
    return blk in (ATTN, ATTN_MOE)


def _is_moe(blk: str) -> bool:
    return blk in (ATTN_MOE, MAMBA_MOE)


def _has_mlp(cfg: ModelConfig, blk: str) -> bool:
    """Pure-SSM blocks (mamba2, d_ff=0) are mixer-only: no MLP sublayer."""
    return _is_moe(blk) or cfg.d_ff > 0


def _check_ported(cfg: ModelConfig, blk: str) -> None:
    if blk not in (ATTN, MAMBA) or cfg.num_experts \
            or (blk == ATTN and cfg.use_mla):
        raise NotImplementedError(
            f"block {blk!r} (use_mla={cfg.use_mla}, "
            f"num_experts={cfg.num_experts}) is not ported yet: the port "
            f"runs dense attention and Mamba2 blocks")


def init_block(gen: torch.Generator, cfg: ModelConfig,
               blk: str) -> Dict[str, Any]:
    _check_ported(cfg, blk)
    dev = gen.device
    p: Dict[str, Any] = {"ln1": L.init_rmsnorm(cfg.d_model, dev)}
    if _is_attn(blk):
        p["attn"] = L.init_attention(gen, cfg)
    else:
        p["mamba"] = M.init_mamba(gen, cfg)
    if _has_mlp(cfg, blk):
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dev)
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def apply_block(params, cfg: ModelConfig, blk: str, x, positions,
                rng_ctx: L.RngCtx, layer_id: int):
    """Returns (x, aux_loss)."""
    _check_ported(cfg, blk)
    ctx = rng_ctx.layer(layer_id)
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if _is_attn(blk):
        a, _ = L.apply_attention(params["attn"], cfg, h, positions)
    else:
        a, _ = M.apply_mamba(params["mamba"], cfg, h)
    x = x + L.dropout(a, cfg.dropout_rate, ctx, op_id=0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _has_mlp(cfg, blk):
        h = L.rmsnorm(params["ln2"], x, cfg.norm_eps)
        m = L.apply_mlp(params["mlp"], cfg, h)
        x = x + L.dropout(m, cfg.dropout_rate, ctx, op_id=1)
    return x, aux


def softmax_xent(logits, labels, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0] - logz
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
