"""Encoder-decoder (Whisper-style) model, mirroring ``repro.models.encdec``.

The conv/mel frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings [B, frames, d].  Encoder: bidirectional
attention blocks with RoPE over the frames plus a learned position table
(``enc_pos``), then ``enc_norm``.  Decoder: causal self-attention (with the
serving plane's KV cache), cross-attention over the encoder output (its
K/V recomputed every call, as the reference does), then the MLP.

The tree is the reference's with its stacked ``encoder`` and ``decoder``
unstacked into per-layer lists (``weights.encdec_params_from_stacked``
carries the reference's across): ``embed``, ``enc_pos``, ``encoder``,
``enc_norm``, ``decoder`` (each block with ``xattn``), ``final_norm``,
``head``.  Caches are the port's per-layer list (slot axis 0), updated in
place.

On the card every norm runs the rmsnorm kernel, ``enc_norm`` included,
which the reference runs plain; aligned attention (the encoder's, and a
prefill's self-attention) runs the flash kernel, bidirectional in the
encoder; cross-attention (S != T) and decode steps over the cache are plain
tensor code, as in the reference.  The reference ignores dropout here.

Under ``remat`` (training) each encoder and decoder block runs under
``torch.utils.checkpoint``, as the reference checkpoints its scan bodies:
the recompute launches the same kernels on the same inputs, so the loss
and gradients are those without remat, bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import dtensor as DT
from .config import ModelConfig
from . import layers as L
from .transformer import softmax_xent


def _n_encoder(cfg: ModelConfig) -> int:
    return cfg.encoder_layers or cfg.num_layers


def _n_decoder(cfg: ModelConfig) -> int:
    return cfg.decoder_layers or cfg.num_layers


def init_encdec_params(gen: torch.Generator,
                       cfg: ModelConfig) -> Dict[str, Any]:
    """The whole enc-dec tree from ``gen``, on its device."""
    dev, dt, d = gen.device, cfg.torch_dtype, cfg.d_model

    def enc_block():
        return {"ln1": L.init_rmsnorm(d, dev),
                "attn": L.init_attention(gen, cfg),
                "ln2": L.init_rmsnorm(d, dev),
                "mlp": L.init_mlp(gen, cfg)}

    def dec_block():
        return {"ln1": L.init_rmsnorm(d, dev),
                "attn": L.init_attention(gen, cfg),
                "lnx": L.init_rmsnorm(d, dev),
                "xattn": L.init_attention(gen, cfg),
                "ln2": L.init_rmsnorm(d, dev),
                "mlp": L.init_mlp(gen, cfg)}

    enc_pos = torch.randn((cfg.max_source_positions, d), generator=gen,
                          dtype=torch.float32, device=dev) * 0.02
    return {
        "embed": L.init_embedding(gen, cfg),
        "enc_pos": enc_pos.to(dt),
        "encoder": [enc_block() for _ in range(_n_encoder(cfg))],
        "enc_norm": L.init_rmsnorm(d, dev),
        "decoder": [dec_block() for _ in range(_n_decoder(cfg))],
        "final_norm": L.init_rmsnorm(d, dev),
        "head": L.init_lm_head(gen, cfg),
    }


def apply_encoder_block(p, cfg: ModelConfig, x, positions) -> torch.Tensor:
    """One encoder block: bidirectional self-attention, the MLP; each a
    pre-norm residual branch."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, _ = L.apply_attention(p["attn"], cfg, h, positions, causal=False)
    x = x + DT.constrain_acts(a, cfg.seq_shard_acts)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + DT.constrain_acts(L.apply_mlp(p["mlp"], cfg, h),
                                 cfg.seq_shard_acts)


def encode(params, cfg: ModelConfig, frames,
           remat: bool = False) -> torch.Tensor:
    """frames: [B, T, d] precomputed frame embeddings (frontend stub) ->
    the encoder output [B, T, d] in the model's dtype.  ``remat``
    recomputes each block's forward in the backward."""
    B, T, _ = frames.shape
    x = frames.to(cfg.torch_dtype) + params["enc_pos"][None, :T, :]
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    x = DT.constrain_acts(x, cfg.seq_shard_acts)
    for p in params["encoder"]:
        if remat:
            x = checkpoint(apply_encoder_block, p, cfg, x, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = apply_encoder_block(p, cfg, x, positions)
        x = DT.constrain_acts(x, cfg.seq_shard_acts)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_attention(p, cfg: ModelConfig, h, enc_out) -> torch.Tensor:
    """Non-causal attention of h [B,S,d] over the encoder output [B,T,d],
    K/V recomputed from it (no cache)."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = DT.split_last(h @ p["wq"], H, hd)
    k = DT.split_last(enc_out @ p["wk"], Hkv, hd)
    v = DT.split_last(enc_out @ p["wv"], Hkv, hd)
    a = L._sdpa(q, k, v, causal=False)
    return DT.merge_heads(a) @ p["wo"]


def apply_decoder_block(p, cfg: ModelConfig, x, positions, enc_out,
                        cache=None, cache_index=None, rows=None):
    """One decoder block: causal self-attention (``cache`` written at
    ``cache_index`` in the rows ``rows``, in place), cross-attention over
    ``enc_out``, the MLP; each a pre-norm residual branch."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, _ = L.apply_attention(p["attn"], cfg, h, positions, kv_cache=cache,
                             cache_index=cache_index, rows=rows)
    x = x + DT.constrain_acts(a, cfg.seq_shard_acts)
    h = L.rmsnorm(p["lnx"], x, cfg.norm_eps)
    x = x + DT.constrain_acts(_cross_attention(p["xattn"], cfg, h, enc_out),
                              cfg.seq_shard_acts)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + DT.constrain_acts(L.apply_mlp(p["mlp"], cfg, h),
                                 cfg.seq_shard_acts)


def decode(params, cfg: ModelConfig, tokens, enc_out, caches=None,
           cache_index=None, rows=None, last_only: bool = False,
           remat: bool = False):
    """tokens [B,S], enc_out [B,T,d] -> (logits [B,S,V], caches).  With
    ``caches`` (:func:`init_decoder_caches`) the self-attention keys are
    written at ``cache_index`` (0: a prefill; [B] positions: a decode
    step), in the batch rows ``rows`` (None: all), in place.
    ``last_only`` keeps the last position alone before the final norm and
    head (a prefill samples from it; rows are independent there).
    ``remat`` (without caches) recomputes each block's forward in the
    backward."""
    if remat and caches is not None:
        raise ValueError("remat is a training option: no caches")
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    offs = torch.arange(S, device=x.device)[None, :]
    if cache_index is None:
        positions = offs.expand(B, S)
    else:
        positions = L.cache_positions(cache_index, B, x.device)[:, None] \
            + offs
    x = DT.constrain_acts(x, cfg.seq_shard_acts)
    for i, p in enumerate(params["decoder"]):
        if remat:
            x = checkpoint(apply_decoder_block, p, cfg, x, positions,
                           enc_out, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = apply_decoder_block(
                p, cfg, x, positions, enc_out,
                caches[i] if caches is not None else None, cache_index,
                rows)
        x = DT.constrain_acts(x, cfg.seq_shard_acts)
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(params["head"], x), caches


def init_decoder_caches(cfg: ModelConfig, batch: int, max_len: int,
                        device=None) -> List[Dict[str, torch.Tensor]]:
    """One zero k/v cache [batch, max_len, Hkv, hd] per decoder layer, in
    the model's dtype (the reference's stacked caches, unstacked);
    ``device="meta"`` gives shapes only."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
            for _ in range(_n_decoder(cfg))]


def encdec_train_loss(params, cfg: ModelConfig, batch, rng_ctx=None,
                      remat: bool = False):
    """Next-token cross-entropy of ``batch["tokens"]`` given
    ``batch["frames"]``; ``rng_ctx`` is ignored, as the reference ignores
    it (no dropout).  ``remat`` as in :func:`encode` and :func:`decode`."""
    del rng_ctx
    enc_out = encode(params, cfg, batch["frames"], remat=remat)
    logits, _ = decode(params, cfg, batch["tokens"], enc_out, remat=remat)
    return softmax_xent(logits[:, :-1], batch["labels"][:, 1:])


def encdec_decode_step(params, cfg: ModelConfig, tokens, enc_out, caches,
                       cache_index, rows=None):
    """One-token decode: tokens [B,1] at ``cache_index`` -> (logits
    [B,1,V], caches)."""
    logits, caches = decode(params, cfg, tokens, enc_out, caches=caches,
                            cache_index=cache_index, rows=rows)
    return logits[:, -1:, :], caches
