"""Mamba2 (SSD, state-space duality) block, arXiv:2405.21060, mirroring
``repro.models.mamba``.

The full-sequence branch of :func:`apply_mamba` runs the SSD scan through
``ops.ssd_scan`` (the CUDA kernel for a CUDA tensor, the sequential oracle on
the CPU) and both of the block's norms through ``ops.rmsnorm``.  Unlike the
reference, whose ``out_norm`` stays on its plain path even with
``use_pallas``, ``out_norm`` here runs the rmsnorm kernel on the card: the
port runs no plain version on the main path.  On the CPU both packages run
plain versions.

:func:`ssd_chunked` is the plain chunked scan (``kernels/ref.py``), which
``ops.ssd_scan``'s backward differentiates.

The state branches serve the serving plane.  A single-token decode is the
O(1) recurrent update :func:`ssd_decode_step` in plain tensor code, as in
the reference (no kernel there).  A prefill starts from the zero state of
:func:`init_mamba_state` and runs the SSD kernel with its final state
(``ops.ssd_scan(..., return_final_state=True)``), at the reference's chunk
``min(ssm_chunk, S)`` with the tail padded by rows of ``dt = 0``, which
leave the state as it is.  A prefill resumed from a carried state
(``cache_index`` not 0) runs the plain chunked scan :func:`ssd_chunked`
from ``initial_state=state["ssm"]``, as the reference routes it: the
reference's SSD kernel, and so the port's, takes no initial state.  States
are updated in place (the reference returns new ones with the same
values).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked
from repro_torch.parallel import dtensor as DT
from .config import ModelConfig
from . import layers as L


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    d, di = cfg.d_model, cfg.d_inner
    ds, ng, H = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_heads
    dt, dev = cfg.torch_dtype, gen.device
    d_in_proj = 2 * di + 2 * ng * ds + H      # z, x, B, C, dt
    conv_dim = di + 2 * ng * ds
    return {
        "in_proj": L._dense(gen, (d, d_in_proj), dt),
        "conv_w": L._dense(gen, (cfg.conv_kernel, conv_dim), dt,
                           scale=cfg.conv_kernel ** -0.5),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "out_norm": L.init_rmsnorm(di, dev),
        "out_proj": L._dense(gen, (di, d), dt),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, ds, ng = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    B = zxbcdt[..., 2 * di:2 * di + ng * ds]
    C = zxbcdt[..., 2 * di + ng * ds:2 * di + 2 * ng * ds]
    dt = zxbcdt[..., 2 * di + 2 * ng * ds:]
    return z, x, B, C, dt


def ssd_decode_step(x, dt, A, B, C, state):
    """Single-token recurrent update, in float32.
    x: [b,1,h,p]; dt: [b,1,h]; B,C: [b,1,g,n]; state: [b,h,p,n].
    Returns (y [b,1,h,p] in x's dtype, new_state [b,h,p,n] float32).  On
    ``DTensor``s (the dry run) each device updates its rows and heads
    (``parallel.dtensor.per_head_shard``)."""
    if DT.is_dtensor(x):
        return DT.per_head_shard(
            lambda x, B, C, dt, A, st: ssd_decode_step(x, dt, A, B, C, st),
            x, (B, C), ((dt, 0, 2), (A, None, 0), (state, 0, 1)),
            out_head_dims=(2, 1))
    h, g = x.shape[2], B.shape[2]
    Bh = B[:, 0].float().repeat_interleave(h // g, dim=1)      # [b,h,n]
    Ch = C[:, 0].float().repeat_interleave(h // g, dim=1)
    dA = torch.exp(dt[:, 0] * A[None, :])                      # [b,h]
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, 0], x[:, 0].float(), Bh)
    new_state = dA[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y[:, None].to(x.dtype), new_state


def init_mamba_state(cfg: ModelConfig, batch: int, device=None):
    """The zero state a sequence starts from: ``ssm`` [b,h,p,n] float32 and
    ``conv`` [b,k-1,conv_dim] in the model's dtype."""
    H, p_, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, H, p_, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=cfg.torch_dtype, device=device),
    }


def _put_rows(dst: torch.Tensor, src: torch.Tensor, rows) -> None:
    """dst[rows] = src[rows] in place (every row when ``rows`` is None)."""
    if rows is None:
        dst.copy_(src)
    else:
        r = torch.as_tensor(rows, dtype=torch.int64, device=dst.device)
        dst[r] = src[r].to(dst.dtype)


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv as the reference's shifted sum (not
    ``F.conv1d``, which cuDNN would run in TF32 for float32).
    x: [b,s,c]; w: [k,c]; conv_state: [b,k-1,c].  Returns (out, new_state)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # [b, s+k-1, c]
    new_state = xp[:, -(k - 1):, :]
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out, new_state


def apply_mamba(params, cfg: ModelConfig, x, state: Optional[Dict] = None,
                cache_index=None, rows=None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 block.  x: [b,s,d] -> ([b,s,d], state).  ``state`` =
    {"ssm": [b,h,p,n], "conv": [b,k-1,conv_dim]} enables the serving
    branches, updated in place: a single-token decode (s == 1), or a
    prefill (s > 1), from the zero state at ``cache_index`` 0 (the SSD
    kernel) or resumed from the carried state otherwise (the plain chunked
    scan); ``rows`` ([n] batch rows, None = all) limits the state writes
    to those rows.  None = full-sequence training."""
    B_, S, _ = x.shape
    H, p_ = cfg.ssm_heads, cfg.ssm_headdim
    di, ds, ng = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    if cfg.mamba_split_proj:
        # slice the weight per component, as the reference does for TP
        w = params["in_proj"]
        o1, o2, o3, o4 = di, 2 * di, 2 * di + ng * ds, 2 * di + 2 * ng * ds
        z = x @ w[:, :o1]
        xs = x @ w[:, o1:o2]
        Bv = x @ w[:, o2:o3]
        Cv = x @ w[:, o3:o4]
        dt = x @ w[:, o4:]
    else:
        # on DTensors the packed columns are gathered first: their split
        # points do not fall on the ``model`` axis's blocks
        z, xs, Bv, Cv, dt = _split_proj(
            cfg, DT.constrain(x @ params["in_proj"], "dp", None, None))
    xBC = torch.cat([xs, Bv, Cv], dim=-1)
    xBC, conv_state = _causal_conv(
        xBC, params["conv_w"], None if state is None else state["conv"])
    xBC = F.silu(xBC)
    # views of xBC: the kernel reads them through their strides
    xs = xBC[..., :di].reshape(B_, S, H, p_)
    Bv = xBC[..., di:di + ng * ds].reshape(B_, S, ng, ds)
    Cv = xBC[..., di + ng * ds:].reshape(B_, S, ng, ds)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus has a threshold
    dt_in = dt.float() + params["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))
    A = -torch.exp(params["A_log"])
    if state is None:
        y, _ = _ssd_scan(xs, dt, A, Bv, Cv, cfg.ssm_chunk)
    else:
        if S == 1:
            y, ssm_state = ssd_decode_step(xs, dt, A, Bv, Cv, state["ssm"])
        elif not L.is_prefill(cache_index):
            # resumed from the carried state: the SSD kernels take no
            # initial state (nor does the reference's), so the plain
            # chunked scan, as the reference routes it
            y, ssm_state = ssd_chunked(xs, dt, A, Bv, Cv,
                                       chunk=min(cfg.ssm_chunk, S),
                                       initial_state=state["ssm"])
        else:
            y, ssm_state = _prefill_scan(xs, dt, A, Bv, Cv,
                                         min(cfg.ssm_chunk, S))
        _put_rows(state["ssm"], ssm_state, rows)
        _put_rows(state["conv"], conv_state, rows)
    y = y + xs * params["D"][None, None, :, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = L.rmsnorm(params["out_norm"], y * F.silu(z), cfg.norm_eps)
    return y @ params["out_proj"], state


def _prefill_scan(xs, dt, A, Bv, Cv, chunk: int):
    """The SSD scan of a prefill from the zero state, with its final state:
    a ragged tail is padded with rows of dt = 0 (no state update), as the
    reference's ``ssd_chunked`` pads, so the final state is the state at
    the last real row; the padded rows' y are dropped."""
    S = xs.shape[1]
    pad = (-S) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bv = F.pad(Bv, (0, 0, 0, 0, 0, pad))
        Cv = F.pad(Cv, (0, 0, 0, 0, 0, pad))
    y, state = _ssd_scan(xs, dt, A, Bv, Cv, chunk, final_state=True)
    return y[:, :S], state


def _ssd_scan(xs, dt, A, Bv, Cv, chunk: int, final_state: bool = False):
    """``ops.ssd_scan``; on ``DTensor``s (the dry run) each device scans
    its rows and heads (``parallel.dtensor.per_head_shard``)."""
    return DT.per_head_shard(
        lambda x, B, C, dt, A: ops.ssd_scan(
            x, dt, A, B, C, chunk=chunk, return_final_state=final_state),
        xs, (Bv, Cv), ((dt, 0, 2), (A, None, 0)), out_head_dims=(2, 1))
