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

Not yet ported (they raise): KV-cache decode and the cached/offset attention
branch (serving slice), MLA and the chunked attention path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.threefry import fold_in
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

    Training self-attention (no offset, S == T) goes to the flash-attention
    kernel; the cached/offset branch waits for the serving slice."""
    S, T = q.shape[1], k.shape[1]
    if q_offset is None and S == T:
        return ops.flash_attention(q, k, v, causal=causal)
    raise NotImplementedError(
        "attention with a cache offset or S != T (decode) is not ported yet")


def apply_attention(params, cfg: ModelConfig, x, positions,
                    kv_cache: Optional[Dict] = None, cache_index=None,
                    causal: bool = True):
    """x: [B,S,d] -> ([B,S,d], None).  Training path only (no KV cache)."""
    if kv_cache is not None or cfg.attn_chunked:
        raise NotImplementedError(
            "KV-cache and chunked attention paths are not ported yet")
    B, S, d = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ params["wv"]).reshape(B, S, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _sdpa(q, k, v, causal=causal)
    return out.reshape(B, S, H * hd) @ params["wo"], None


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
    return params["embedding"][tokens.long()]


def init_lm_head(gen, cfg: ModelConfig) -> Dict[str, Any]:
    return {"w": _dense(gen, (cfg.d_model, cfg.vocab_size), cfg.torch_dtype)}


def lm_logits(head_params, x):
    return x @ head_params["w"]
