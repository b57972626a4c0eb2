"""Mixture-of-Experts MLP with fixed-capacity token dispatch, mirroring
``repro.models.moe``.

The expert dimension leads every expert weight (``[E, d, ff]``), so it
shards over an expert-parallel group.  Routing runs in float32: softmax,
top-k, the renormalised gates, the Switch aux loss.  Each expert has
``cap`` places; a (token, k) pair takes the next free place of its
expert, in (token, k) order over the whole batch (global dispatch) or over
its sample row (``cfg.moe_row_dispatch``), and past ``cap`` it is dropped
and its gate zeroed.

The buckets are built by assignment, not by atomics: kept (expert, place)
pairs are unique, so gathering each place's pair (:func:`_take`) gives the
values of the reference's scatter-add onto zeros, and the backward gathers
through the inverse map (:class:`_Gather`).  A step on the card is then
the same from run to run, which ``index_add_`` on CUDA is not.  A token's
K contributions are summed in k order, as the reference's scatter applies
them.

``rows`` (a serving decode step, which runs every slot of a replica at one
width): only those batch rows are routed, in that order, ``cap`` is sized
from them, and the other rows' output is zero, as if the reference's
engine had gathered the live slots.  The router product, the buckets (at
the capacity of the whole batch, zeros in the unused places) and the
expert products keep their shapes from tick to tick.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import dtensor as DT
from .config import ModelConfig
from .layers import _dense


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """The router ``[d, E]`` in float32 whatever the model's dtype; the
    experts' ``wg``/``wu`` ``[E, d, ff]`` and ``wo`` ``[E, ff, d]`` (``wu``
    also under ``relu2``, where nothing reads it, as in the reference);
    ``shared`` when ``cfg.num_shared_experts``."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = cfg.torch_dtype
    p = {
        "router": _dense(gen, (d, E), torch.float32),
        "wg": _dense(gen, (E, d, ff), dt),
        "wu": _dense(gen, (E, d, ff), dt),
        "wo": _dense(gen, (E, ff, d), dt),
    }
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        p["shared"] = {
            "wg": _dense(gen, (d, sff), dt),
            "wu": _dense(gen, (d, sff), dt),
            "wo": _dense(gen, (sff, d), dt),
        }
    return p


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Places an expert has for ``tokens`` routed tokens (the reference's
    expression, Python's ``round``)."""
    E, K = cfg.num_experts, cfg.top_k
    return int(max(1, round(tokens * K / E * cfg.capacity_factor)))


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``src[idx]``; an index equal to ``len(src)`` reads zeros."""
    n = src.shape[0]
    rows = src[idx.clamp(max=n - 1)]
    return torch.where((idx < n)[:, None], rows, rows.new_zeros(()))


class _Gather(torch.autograd.Function):
    """``_take(src, idx)`` where every row of ``src`` is read by at most
    one index: ``inv[j]`` is that index (``len(idx)``: none), so the
    backward is a gather too."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _take(src, idx)

    @staticmethod
    def backward(ctx, grad):
        inv, = ctx.saved_tensors
        return _take(grad, inv), None, None


def route(cfg: ModelConfig, logits: torch.Tensor, cap: int,
          layout_cap: int, experts: Optional[torch.Tensor] = None
          ) -> Dict[str, torch.Tensor]:
    """Routing of ``G`` independent queues of ``n`` tokens (global
    dispatch: one; row dispatch: one a sample row) from float32 router
    ``logits`` [G, n, E]: ``probs``, the top-k ``gate_idx`` and the
    renormalised, capacity-masked ``gate`` [G, n, K], each pair's rank
    ``pos`` in its expert's queue (exclusive cumsum of the one-hot in
    (token, k) order), ``keep`` (``pos < cap``), and the two maps between
    pairs and bucket places, the buckets laid out ``[E, G, layout_cap]``:
    ``dst`` [G*n*K] (a pair's place; dropped: the place count) and ``src``
    [E*G*layout_cap] (a place's pair; empty: the pair count).  ``experts``
    [G, n, K] routes to those experts instead of the top-k (a twin that
    replays another device's choices where a near-tie fell the other
    way)."""
    G, n, E = logits.shape
    K = cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    if experts is None:
        gate, gate_idx = torch.topk(probs, K, dim=-1)
    else:
        gate_idx = experts.to(logits.device)
        gate = torch.gather(probs, -1, gate_idx)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    flat = F.one_hot(gate_idx, E).reshape(G, n * K, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = torch.sum(pos * flat, dim=-1).reshape(G, n, K)
    keep = pos < cap
    gate = gate * keep.to(gate.dtype)
    places = E * G * layout_cap
    g_idx = torch.arange(G, device=logits.device)[:, None, None]
    dst = torch.where(keep, (gate_idx * G + g_idx) * layout_cap + pos,
                      places).reshape(-1)
    pairs = dst.numel()
    # dropped pairs all land on the spare place ``places``, cut off after
    src = torch.full((places + 1,), pairs, dtype=dst.dtype,
                     device=dst.device)
    src.scatter_(0, dst, torch.arange(pairs, device=dst.device))
    return dict(probs=probs, gate=gate, gate_idx=gate_idx, pos=pos,
                keep=keep, dst=dst, src=src[:places])


def _aux_loss(cfg: ModelConfig, probs, gate_idx) -> torch.Tensor:
    """Switch load-balancing loss over the routed tokens."""
    E = cfg.num_experts
    me = torch.mean(probs.reshape(-1, E), dim=0)
    ce = torch.mean(F.one_hot(gate_idx[..., 0].reshape(-1), E)
                    .to(torch.float32), dim=0)
    return torch.sum(me * ce) * E * cfg.router_aux_loss


def _experts(params, cfg: ModelConfig, buckets):
    """[E, c, d] -> [E, c, d] through each expert's MLP."""
    if cfg.activation == "relu2":
        h = torch.relu(torch.bmm(buckets, params["wg"]))
        return torch.bmm(h * h, params["wo"])
    g = torch.bmm(buckets, params["wg"])
    u = torch.bmm(buckets, params["wu"])
    return torch.bmm(F.silu(g) * u, params["wo"])


def _shared(sp, cfg: ModelConfig, xt):
    if cfg.activation == "relu2":
        h = torch.relu(xt @ sp["wg"])
        return (h * h) @ sp["wo"]
    return (F.silu(xt @ sp["wg"]) * (xt @ sp["wu"])) @ sp["wo"]


def apply_moe(params, cfg: ModelConfig, x: torch.Tensor,
              rows: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> (out [B,S,d], aux_loss scalar float32).  Global
    dispatch ranks all B*S tokens in one queue, ``cap`` from B*S; row
    dispatch (``cfg.moe_row_dispatch``) each sample row in its own, ``cap``
    from S.  With ``rows`` only those batch rows are routed (global: ``cap``
    from ``len(rows) * S``; row dispatch routes every row, each on its own,
    and keeps the live ones), the aux loss is theirs and the other rows'
    output is zero."""
    if DT.is_dtensor(x):
        if rows is not None:
            raise ValueError("rows= on DTensors: no dry-run cell passes it")
        return _apply_moe_sharded(params, cfg, x)
    B, S, d = x.shape
    E = cfg.num_experts
    xt = x.reshape(B * S, d)
    logits = (xt.to(torch.float32) @ params["router"]).reshape(B, S, E)
    if cfg.moe_row_dispatch:
        G, n, xg = B, S, x
        cap = layout_cap = capacity(S, cfg)
        r = route(cfg, logits, cap, cap)
        sel = slice(None) if rows is None else rows
        aux = _aux_loss(cfg, r["probs"][sel], r["gate_idx"][sel])
    else:
        xg = x if rows is None else x[rows]
        G, n = 1, xg.shape[0] * S
        cap, layout_cap = capacity(n, cfg), capacity(B * S, cfg)
        sel = logits if rows is None else logits[rows]
        r = route(cfg, sel.reshape(1, n, E), cap, layout_cap)
        aux = _aux_loss(cfg, r["probs"], r["gate_idx"])
    out = _dispatch(params, cfg, xg, r, G * n, G * layout_cap) \
        .reshape(G * n // S, S, d)
    shared = _shared(params["shared"], cfg, xt).reshape(B, S, d) \
        if cfg.num_shared_experts else None
    if rows is None:
        return (out if shared is None else out + shared), aux
    if cfg.moe_row_dispatch:
        out = out[rows]
    full = torch.zeros_like(x)
    full[rows] = out if shared is None else out + shared[rows]
    return full, aux


def _dispatch(experts, cfg: ModelConfig, xg, r, tokens: int, places: int,
              e0: int = 0):
    """The ``tokens`` rows of ``xg`` through their routed experts (``r``
    from :func:`route`, ``places`` bucket places an expert): buckets by
    gathers, the experts of ``experts`` (all of them, or one device's block
    starting at expert ``e0``, the others' outputs zero) on theirs, the
    pairs combined in k order.  -> [tokens, d]."""
    d = xg.shape[-1]
    E, K = cfg.num_experts, cfg.top_k
    x_rep = xg.reshape(tokens, 1, d).expand(tokens, K, d).reshape(-1, d)
    buckets = _Gather.apply(x_rep, r["src"], r["dst"]).reshape(E, places, d)
    El = experts["wg"].shape[0]
    out_b = _experts(experts, cfg, buckets[e0:e0 + El])
    if El < E:
        out_b = torch.cat([out_b.new_zeros((e0, places, d)), out_b,
                           out_b.new_zeros((E - e0 - El, places, d))])
    got = _Gather.apply(out_b.reshape(-1, d), r["dst"], r["src"]) \
        .reshape(tokens, K, d)
    w = r["gate"].reshape(tokens, K).to(xg.dtype)
    out = got[:, 0] * w[:, :1]
    for k in range(1, K):
        out = out + got[:, k] * w[:, k:k + 1]
    return out


def _apply_moe_sharded(params, cfg: ModelConfig, x):
    """:func:`apply_moe` on ``DTensor``s (the dry run), one device's share:
    it routes its own tokens (x's rows, split over the data-parallel axes;
    ``cap`` from its tokens), fills the buckets of the experts it holds
    (the expert dim split over ``model``) and runs them, and the ``model``
    axis sums the experts' outputs (a partial sum, reduced where the
    block's output joins the stream).  Expert parallelism without an
    all-to-all: the tokens are replicated over ``model``, as the
    tensor-parallel layout holds them.  The shared experts run
    tensor-parallel.  The aux loss is each device's, averaged over the
    data-parallel axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    x = DT.constrain(x, "dp", None, None)
    xl = x.to_local()
    B, S, d = xl.shape
    E = cfg.num_experts
    router = DT.constrain(params["router"], None, None).to_local()
    logits = (xl.reshape(B * S, d).to(torch.float32) @ router) \
        .reshape(B, S, E)
    G, n = (B, S) if cfg.moe_row_dispatch else (1, B * S)
    cap = capacity(n, cfg)
    r = route(cfg, logits.reshape(G, n, E), cap, cap)
    aux = _aux_loss(cfg, r["probs"], r["gate_idx"])
    local = {k: params[k].to_local() for k in ("wg", "wu", "wo")}
    e0 = DT.block_start_of(params["wg"], 0, local["wg"].shape[0])
    out = _dispatch(local, cfg, xl, r, G * n, G * cap, e0).reshape(B, S, d)
    if cfg.num_shared_experts:
        sp = {k: v.to_local() for k, v in params["shared"].items()}
        out = out + _shared(sp, cfg, xl.reshape(B * S, d)).reshape(B, S, d)
    names = mesh.mesh_dim_names
    pl = [p if p.is_shard(0) else Partial() for p in x.placements]
    aux_pl = [Partial("avg") if names[i] in ("pod", "data") else Replicate()
              for i in range(mesh.ndim)]
    return (DTensor.from_local(out, mesh, pl, run_check=False),
            DTensor.from_local(aux, mesh, aux_pl, run_check=False))
