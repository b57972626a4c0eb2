"""Flat-vector AdamW for the VirtualCluster's ZeRO-1 stage buffers.

``adam_update_flat_np`` is a copy of the reference's host-side numpy update
(the oracle the ring snapshot replays on the host).  ``adam_update_flat_``
applies the same update, in place, to a stage's flat buffers wherever they
live: through the fused-AdamW kernel for CUDA tensors, through the plain
torch version for CPU tensors.  Both keep the oracle's op order, so on the
card the device state and the host snapshot stay bitwise equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    master_weights: bool = True


def adam_update_flat_np(grad_vec, st, step: int, cfg: AdamConfig):
    """Host-side (numpy) AdamW over one flat f32 vector.

    IEEE basic ops (+, -, *, /, sqrt) are correctly rounded in numpy, so any
    implementation that runs this exact op sequence in f32, without fused
    multiply-adds, produces identical bits.  Returns the new state dict
    {master, mu, nu} (f32 numpy arrays).
    """
    g = np.asarray(grad_vec, dtype=np.float32)
    b1t = np.float32(1.0 - cfg.b1 ** step)
    b2t = np.float32(1.0 - cfg.b2 ** step)
    mu = np.float32(cfg.b1) * st["mu"] + np.float32(1 - cfg.b1) * g
    nu = np.float32(cfg.b2) * st["nu"] + np.float32(1 - cfg.b2) * g * g
    upd = (mu / b1t) / (np.sqrt(nu / b2t) + np.float32(cfg.eps)) \
        + np.float32(cfg.weight_decay) * st["master"]
    master = st["master"] - np.float32(cfg.lr) * upd
    return {"master": master, "mu": mu, "nu": nu}


def adam_update_flat_(grad: torch.Tensor, state: Dict[str, torch.Tensor],
                      step: int, cfg: AdamConfig) -> None:
    """Update ``state["master"/"mu"/"nu"]`` in place from the f32 ``grad``.

    One fused-AdamW kernel launch for CUDA tensors; the plain version for CPU
    tensors.  Bitwise equal to :func:`adam_update_flat_np`.
    """
    from repro_torch.kernels import ops
    ops.fused_adam_(grad, state["master"], state["mu"], state["nu"],
                    step=step, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, lr=cfg.lr,
                    weight_decay=cfg.weight_decay)
