"""Per-layer model API used by the VirtualCluster, mirroring
``repro.models.registry``: each physical layer is an independently owned
dict of tensors that can migrate between pipeline stages.  Also the
whole-model init (:func:`init_model`) and its shapes on the meta device
(:func:`model_param_shapes`), the whole-model loss (:func:`make_train_loss`,
with or without remat) and the serving hooks (:func:`serving_hooks`) the
serving engine drives.

As in the reference, the cluster trains an enc-dec config's decoder stack
of ``cfg.block_pattern()`` alone (plain decoder blocks) and a vlm config
without its prefix embeddings; the whole-model paths carry the encoder
(``models/encdec.py``) and the prefix (``transformer.forward``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import torch

from .config import ModelConfig
from . import encdec as E
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
    """The whole model from ``gen`` (on its device): an enc-dec config's
    tree (``encdec.init_encdec_params``), else ``(stem, layers, head)``.
    As the reference's whole-model tree, a config with ``tie_embeddings``
    has no head matrix: its head holds the final norm alone, and the
    logits read the embedding, transposed (``transformer.forward``)."""
    if cfg.is_encdec:
        return E.init_encdec_params(gen, cfg)
    stem = init_stem(gen, cfg)
    layers = [init_layer(gen, cfg, i) for i in range(cfg.num_layers)]
    if cfg.tie_embeddings:
        head = {"final_norm": L.init_rmsnorm(cfg.d_model, gen.device)}
    else:
        head = init_head(gen, cfg)
    return stem, layers, head


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so that the init
    functions, which place every leaf on ``gen.device``, build meta
    tensors: ``torch.randn(..., generator=<cpu>, device="meta")`` draws
    nothing, and there is no meta generator to pass instead."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def model_param_shapes(cfg: ModelConfig):
    """The tree :func:`init_model` builds, as meta tensors: every leaf's
    shape and dtype, nothing allocated (the reference's
    ``jax.eval_shape`` of its init)."""
    return init_model(_MetaGenerator(), cfg)


def make_train_loss(cfg: ModelConfig, remat: bool = False):
    """``loss_fn(params, batch, rng_ctx=None)`` of the whole model: the
    enc-dec loss (``batch["frames"]``, ``batch["tokens"]``,
    ``batch["labels"]``) or the decoder's (with ``batch["prefix_embeds"]``
    when given).  ``remat`` recomputes each block's forward in the
    backward (``torch.utils.checkpoint``), as the reference checkpoints
    each block: the loss and gradients are the same bits."""
    if cfg.is_encdec:
        def loss_fn(params, batch, rng_ctx=None):
            return E.encdec_train_loss(params, cfg, batch, rng_ctx,
                                       remat=remat)
    else:
        def loss_fn(params, batch, rng_ctx=None):
            return T.train_loss(params, cfg, batch, rng_ctx, remat=remat)
    return loss_fn


# ---- serving hooks (repro_torch.serving engine) ----------------------------
@dataclasses.dataclass(frozen=True)
class ServingHooks:
    """Uniform prefill/decode interface the serving engine drives, as the
    reference's.  Caches are the per-layer list of
    ``transformer.init_caches`` (``encdec.init_decoder_caches``; slot axis
    0 in every tensor), updated in place; ``extras`` is a per-slot tree,
    slot axis 0 (an enc-dec config's encoder output ``{"enc": [B, T,
    d]}``), or ``None`` for the decoder-only families.

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
    """The hooks of ``cfg`` with caches on ``device``: an enc-dec config
    encodes a request's ``encoder_frames`` once (``prepare_extras``) and
    decodes over its output; every other config is served as a
    decoder-only model (attention, GQA or MLA, and Mamba2 blocks, dense or
    MoE MLPs).  A vlm config is served as the reference serves it, with
    no prefix embeddings."""
    if cfg.is_encdec:
        return _encdec_hooks(cfg, device)

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


def _encdec_hooks(cfg: ModelConfig, device) -> ServingHooks:
    def init_caches(batch, max_len):
        return E.init_decoder_caches(cfg, batch, max_len, device)

    def prepare_extras(params, req):
        frames = torch.as_tensor(req.encoder_frames,
                                 device=params["enc_pos"].device)[None]
        return {"enc": E.encode(params, cfg, frames)}     # [1, T, d]

    def prefill(params, tokens, caches, extras):
        logits, caches = E.decode(params, cfg, tokens, extras["enc"],
                                  caches=caches, cache_index=0,
                                  last_only=True)
        return logits[:, -1, :], caches

    def decode_step(params, tokens, caches, positions, extras, rows=None):
        logits, caches = E.decode(params, cfg, tokens, extras["enc"],
                                  caches=caches, cache_index=positions,
                                  rows=rows)
        return logits[:, -1, :], caches

    return ServingHooks(init_caches=init_caches, prefill=prefill,
                        decode_step=decode_step,
                        prepare_extras=prepare_extras)


def tiny_config(family: str = "dense", **kw) -> ModelConfig:
    """Reduced config of a family for CPU tests, field for field the
    reference's.  Every family builds, trains and serves: attention, GQA
    or MLA (``use_mla``), and Mamba2 blocks, dense or MoE MLPs; the audio
    family's encoder-decoder (``models/encdec.py``) and the vlm family's
    prefix embeddings (``transformer.forward``) on the whole-model
    paths."""
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
