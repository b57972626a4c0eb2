"""Per-layer model API used by the VirtualCluster, mirroring
``repro.models.registry``: each physical layer is an independently owned
dict of tensors that can migrate between pipeline stages.  Also the
whole-model init (:func:`init_model`) and the serving hooks
(:func:`serving_hooks`) the serving engine drives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

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


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """The whole model, ``(stem, layers, head)``, from ``gen`` (on its
    device).  As the reference's whole-model tree, a config with
    ``tie_embeddings`` has no head matrix of its own: the head is a view
    of the embedding, transposed."""
    stem = init_stem(gen, cfg)
    layers = [init_layer(gen, cfg, i) for i in range(cfg.num_layers)]
    if cfg.tie_embeddings:
        head = {"final_norm": L.init_rmsnorm(cfg.d_model, gen.device),
                "head": {"w": stem["embed"]["embedding"].T}}
    else:
        head = init_head(gen, cfg)
    return stem, layers, head


# ---- serving hooks (repro_torch.serving engine) ----------------------------
@dataclasses.dataclass(frozen=True)
class ServingHooks:
    """Uniform prefill/decode interface the serving engine drives, as the
    reference's.  Caches are the per-layer list of
    ``transformer.init_caches`` (slot axis 0 in every tensor), updated in
    place; ``extras`` is ``None`` for the decoder-only families.

    * ``prefill(params, tokens [B,S], caches, extras)`` -> (logits [B,V],
      caches): writes the whole prefix at positions ``0..S-1``.
    * ``decode_step(params, tokens [B,1], caches, positions [B], extras,
      rows=None)`` -> (logits [B,V], caches): per-row write offsets, so one
      batched call serves slots at different lengths; only the batch rows
      ``rows`` (None: all) write their caches.
    """
    init_caches: Callable[[int, int], Any]          # (batch, max_len)
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    prepare_extras: Callable[..., Any]              # (params, request)


def serving_hooks(cfg: ModelConfig, device=None) -> ServingHooks:
    """The hooks of a decoder-only config of attention (GQA or MLA) and
    Mamba2 blocks with dense or MoE MLPs, with caches on ``device``.  An
    enc-dec config (the audio family) and modality prefix embeddings are
    not ported and raise, naming the slice that ports them."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: enc-dec serving waits for the enc-dec slice of "
            f"the port (models/encdec.py)")
    if cfg.frontend_embeds:
        raise NotImplementedError(
            f"{cfg.name}: modality prefix embeddings wait for the VLM "
            f"front-end slice of the port")

    def init_caches(batch, max_len):
        return T.init_caches(cfg, batch, max_len, device)

    def prepare_extras(params, req):
        del params, req
        return None

    def prefill(params, tokens, caches, extras):
        del extras
        logits, caches = T.prefill(params, cfg, tokens, caches)
        return logits[:, -1, :], caches

    def decode_step(params, tokens, caches, positions, extras, rows=None):
        del extras
        logits, caches = T.decode_step(params, cfg, tokens, caches,
                                       cache_index=positions, rows=rows)
        return logits[:, -1, :], caches

    return ServingHooks(init_caches=init_caches, prefill=prefill,
                        decode_step=decode_step,
                        prepare_extras=prepare_extras)


def tiny_config(family: str = "dense", **kw) -> ModelConfig:
    """Reduced config of a family for CPU tests, field for field the
    reference's.  Every family's config is data for the cost model and the
    scenario engine; the dense, moe, ssm and hybrid families build, train
    and serve (attention, GQA or MLA (``use_mla``), and Mamba2 blocks,
    dense or MoE MLPs).  The audio family's encoder and the vlm family's
    prefix embeddings wait for their slices (``serving_hooks`` raises)."""
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
