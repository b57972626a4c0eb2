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

**Remat** (``forward(..., remat=True)``, training only): each block runs
under ``torch.utils.checkpoint`` (non-reentrant), its activations
recomputed in the backward, as the reference checkpoints ``apply_block``.
The recompute launches the same kernels on the same inputs, and dropout is
content-addressed (``RngCtx``), so it draws the same masks without the RNG
state being stashed: the loss and gradients are those without remat, bit
for bit.

**On meta DTensors** (the dry run, ``launch/dryrun.py``) the residual
stream, and each block's branches where they join it, are constrained
(``parallel.dtensor.constrain_acts``): batch over the data-parallel axes
and, under ``cfg.seq_shard_acts``, the sequence over ``model`` (the
reference's ``_maybe_seq_shard``), else replicated there, the branches'
tensor-parallel partial sums reduced on the way.  On plain tensors, the
CPU's and the card's, it is a no-op, as the reference's hint is without a
mesh in scope (no published config sets it).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import dtensor as DT
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
    x = x + L.dropout(DT.constrain_acts(a, cfg.seq_shard_acts),
                      cfg.dropout_rate, ctx, op_id=0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _has_mlp(cfg, blk):
        h = L.rmsnorm(params["ln2"], x, cfg.norm_eps)
        if _is_moe(blk):
            m, aux = X.apply_moe(params["moe"], cfg, h, rows=rows)
        else:
            m = L.apply_mlp(params["mlp"], cfg, h)
        x = x + L.dropout(DT.constrain_acts(m, cfg.seq_shard_acts),
                          cfg.dropout_rate, ctx, op_id=1)
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


def forward(params, cfg: ModelConfig, tokens, *, rng_ctx=None,
            prefix_embeds=None, caches=None, cache_index=None, rows=None,
            last_only: bool = False, remat: bool = False):
    """tokens: [B,S] -> (logits [B,P+S,V], caches, aux_loss), over the
    port's ``(stem, layers, head)``.  ``prefix_embeds`` [B,P,d]
    (precomputed modality embeddings, the vlm front-end stub) are
    prepended to the token embeddings in the model's dtype, as the
    reference does.  ``rng_ctx`` addresses dropout (None: none).  With
    ``caches`` the sequence is written at ``cache_index`` (0: a prefill;
    [B] positions: a decode step), in the rows ``rows`` (None: all), in
    place.  ``last_only`` keeps the last position alone before the final
    norm and head (a prefill samples from it; rows are independent
    there).  ``remat`` (without caches) recomputes each block's forward in
    the backward."""
    if remat and caches is not None:
        raise ValueError("remat is a training option: no caches")
    stem, layers, head = params
    x = L.embed(stem["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = DT.constrain_acts(x, cfg.seq_shard_acts)
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
    ctx = rng_ctx or L.RngCtx()
    for i, (blk, p) in enumerate(zip(types, layers)):
        if remat:
            x, aux = checkpoint(apply_block, p, cfg, blk, x, positions, ctx,
                                i, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            c = caches[i] if caches is not None else None
            x, aux = apply_block(p, cfg, blk, x, positions, ctx, i, cache=c,
                                 cache_index=cache_index, rows=rows)
        x = DT.constrain_acts(x, cfg.seq_shard_acts)
        aux_total = aux_total + aux
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(head["final_norm"], x, cfg.norm_eps)
    # a tied config has no head matrix: the logits read the embedding,
    # transposed, as the reference's
    w = stem["embed"]["embedding"].T if cfg.tie_embeddings \
        else head["head"]["w"]
    return L.lm_logits({"w": w}, x), caches, aux_total


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """:func:`init_caches` on the meta device: shapes and dtypes only."""
    return init_caches(cfg, batch, max_len, device="meta")


def prefill(params, cfg: ModelConfig, tokens, caches, prefix_embeds=None):
    """Prefill: write the whole prompt, after ``prefix_embeds`` [B,P,d]
    when given, into the caches (index 0).  Returns (logits [B,1,V],
    caches)."""
    logits, caches, _ = forward(params, cfg, tokens, caches=caches,
                                cache_index=0, last_only=True,
                                prefix_embeds=prefix_embeds)
    return logits, caches


def decode_step(params, cfg: ModelConfig, tokens, caches, cache_index,
                rows=None, prefix_embeds=None):
    """One-token decode: tokens [B,1] at positions ``cache_index`` [B] ->
    (logits [B,1,V], caches); only the rows ``rows`` (None: all) write
    their caches.  ``prefix_embeds`` as in :func:`forward` (the
    reference's signature; no caller passes them to a decode step)."""
    logits, caches, _ = forward(params, cfg, tokens, caches=caches,
                                cache_index=cache_index, rows=rows,
                                prefix_embeds=prefix_embeds)
    return logits[:, -1:, :], caches


def train_loss(params, cfg: ModelConfig, batch, rng_ctx=None,
               remat: bool = False):
    """Next-token cross-entropy of ``batch["tokens"]`` plus the MoE aux
    loss; with ``batch["prefix_embeds"]`` [B,P,d] the P prefix positions'
    logits are dropped, as the reference drops them.  ``remat`` as in
    :func:`forward`."""
    prefix = batch.get("prefix_embeds")
    logits, _, aux = forward(params, cfg, batch["tokens"], rng_ctx=rng_ctx,
                             prefix_embeds=prefix, remat=remat)
    P = 0 if prefix is None else prefix.shape[1]
    tok_logits = logits[:, P:, :]
    return softmax_xent(tok_logits[:, :-1], batch["labels"][:, 1:]) + aux


def softmax_xent(logits, labels, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = DT.take_last(logits, labels.long()) - logz
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
