"""Per-layer model API used by the VirtualCluster, mirroring
``repro.models.registry``: each physical layer is an independently owned
dict of tensors that can migrate between pipeline stages.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .config import ModelConfig
from . import layers as L
from . import transformer as T


def flat_layer_types(cfg: ModelConfig) -> List[str]:
    """Block type of each physical layer, in order."""
    out: List[str] = []
    for pat, rep in cfg.block_pattern():
        out.extend(list(pat) * rep)
    return out


def init_layer(gen: torch.Generator, cfg: ModelConfig,
               layer_idx: int) -> Dict[str, Any]:
    return T.init_block(gen, cfg, flat_layer_types(cfg)[layer_idx])


def apply_layer(params, cfg: ModelConfig, layer_idx: int, x, positions,
                rng_ctx: L.RngCtx):
    blk = flat_layer_types(cfg)[layer_idx]
    return T.apply_block(params, cfg, blk, x, positions, rng_ctx, layer_idx)


def init_stem(gen: torch.Generator, cfg: ModelConfig):
    """Embedding (stage-0-owned) params."""
    return {"embed": L.init_embedding(gen, cfg)}


def init_head(gen: torch.Generator, cfg: ModelConfig):
    """Final norm + lm head (last-stage-owned) params."""
    return {"final_norm": L.init_rmsnorm(cfg.d_model, gen.device),
            "head": L.init_lm_head(gen, cfg)}


def apply_stem(params, cfg: ModelConfig, tokens):
    return L.embed(params["embed"], tokens)


def apply_head(params, cfg: ModelConfig, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(params["head"], x)


def tiny_config(family: str = "dense", **kw) -> ModelConfig:
    """Reduced config of a family for CPU tests, field for field the
    reference's.  Every family's config is data for the cost model and the
    scenario engine; training builds only the blocks the port runs (dense
    attention and Mamba2): ``transformer.init_block`` raises on the others."""
    base = dict(name=f"tiny-{family}", family=family, num_layers=4, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                rope_theta=10000.0, dtype="float32")
    if family == "moe":
        base.update(num_experts=4, top_k=2, moe_d_ff=64, first_k_dense=1)
    if family == "ssm":
        base.update(num_heads=0, num_kv_heads=0, d_ff=0, ssm_state=16,
                    ssm_headdim=16, ssm_chunk=8)
    if family == "hybrid":
        base.update(num_layers=4, attn_period=4, attn_layer_offset=0,
                    ssm_state=16, ssm_headdim=16, ssm_chunk=8,
                    num_experts=4, top_k=2, moe_d_ff=64, moe_layer_period=2)
    if family == "audio":
        base.update(is_encdec=True, encoder_layers=2, decoder_layers=2,
                    num_layers=2, max_source_positions=32)
    if family == "vlm":
        base.update(frontend_embeds=8)
    base.update(kw)
    return ModelConfig(**base)
