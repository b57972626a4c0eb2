"""Mamba2 (SSD, state-space duality) block, arXiv:2405.21060, mirroring
``repro.models.mamba`` (training path).

The full-sequence branch of :func:`apply_mamba` runs the SSD scan through
``ops.ssd_scan`` (the CUDA kernel for a CUDA tensor, the sequential oracle on
the CPU) and both of the block's norms through ``ops.rmsnorm``.  Unlike the
reference, whose ``out_norm`` stays on its plain path even with
``use_pallas``, ``out_norm`` here runs the rmsnorm kernel on the card: the
port runs no plain version on the main path.  On the CPU both packages run
plain versions.

:func:`ssd_chunked` is the plain chunked scan (``kernels/ref.py``), which
``ops.ssd_scan``'s backward differentiates.  The branches with a state
(single-token decode and prefill-with-state), :func:`ssd_decode_step` and
:func:`init_mamba_state` wait for the serving slice and raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401  (re-export)
from .config import ModelConfig
from . import layers as L

_SERVING_SLICE = "the serving slice of the port (decode and prefill)"


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
    raise NotImplementedError(f"ssd_decode_step waits for {_SERVING_SLICE}")


def init_mamba_state(cfg: ModelConfig, batch: int):
    raise NotImplementedError(f"init_mamba_state waits for {_SERVING_SLICE}")


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
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 block, full-sequence training branch.  x: [b,s,d] ->
    ([b,s,d], None).  ``state`` (decode / prefill-with-state) raises."""
    if state is not None:
        raise NotImplementedError(
            f"apply_mamba with a state (decode, prefill-with-state) waits "
            f"for {_SERVING_SLICE}")
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
        z, xs, Bv, Cv, dt = _split_proj(cfg, x @ params["in_proj"])
    xBC = torch.cat([xs, Bv, Cv], dim=-1)
    xBC, _ = _causal_conv(xBC, params["conv_w"])
    xBC = F.silu(xBC)
    # views of xBC: the kernel reads them through their strides
    xs = xBC[..., :di].reshape(B_, S, H, p_)
    Bv = xBC[..., di:di + ng * ds].reshape(B_, S, ng, ds)
    Cv = xBC[..., di + ng * ds:].reshape(B_, S, ng, ds)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus has a threshold
    dt_in = dt.float() + params["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))
    A = -torch.exp(params["A_log"])
    y, _ = ops.ssd_scan(xs, dt, A, Bv, Cv, chunk=cfg.ssm_chunk)
    y = y + xs * params["D"][None, None, :, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = L.rmsnorm(params["out_norm"], y * F.silu(z), cfg.norm_eps)
    return y @ params["out_proj"], None
