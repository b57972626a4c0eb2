"""Decoder block (ATTN branch) and loss, mirroring ``repro.models.transformer``.

MoE and Mamba blocks, the stacked whole-model forward and the serving
prefill/decode paths wait for later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .config import ATTN, ModelConfig
from . import layers as L


def _check_dense(cfg: ModelConfig, blk: str) -> None:
    if blk != ATTN or cfg.use_mla or cfg.num_experts:
        raise NotImplementedError(
            f"block {blk!r} (use_mla={cfg.use_mla}, "
            f"num_experts={cfg.num_experts}) is not ported yet: the port "
            f"runs dense attention blocks")


def init_block(gen: torch.Generator, cfg: ModelConfig,
               blk: str) -> Dict[str, Any]:
    _check_dense(cfg, blk)
    dev = gen.device
    p: Dict[str, Any] = {"ln1": L.init_rmsnorm(cfg.d_model, dev),
                         "attn": L.init_attention(gen, cfg)}
    if cfg.d_ff > 0:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dev)
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def apply_block(params, cfg: ModelConfig, blk: str, x, positions,
                rng_ctx: L.RngCtx, layer_id: int):
    """Returns (x, aux_loss)."""
    _check_dense(cfg, blk)
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    a, _ = L.apply_attention(params["attn"], cfg, h, positions)
    x = x + L.dropout(a, cfg.dropout_rate, rng_ctx, op_id=0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff > 0:
        h = L.rmsnorm(params["ln2"], x, cfg.norm_eps)
        m = L.apply_mlp(params["mlp"], cfg, h)
        x = x + L.dropout(m, cfg.dropout_rate, rng_ctx, op_id=1)
    return x, aux


def softmax_xent(logits, labels, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0] - logz
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
