"""Mixed-precision AdamW: the tree-level update of the whole-model
launcher (``launch/train.py``) and the flat-vector one of the
VirtualCluster's ZeRO-1 stage buffers.

:func:`init_opt_state` / :func:`adam_update` mirror the reference's
``repro.optim.adam``: state ``{"leaves": <one {mu, nu[, master]} a
parameter, float32, the parameter's shape>, "step": int}``, the leaves
in the parameter tree's structure (a tied config's tree has no head
matrix, ``registry.init_model``, so its embedding has one state, as in
the reference).  Parameters are updated in place (``p.copy_(master)``).
Each parameter goes through ``ops.fused_adam_`` once a step:
the fused-AdamW kernel for CUDA tensors, its plain version for CPU
tensors.  The bias corrections are the kernel's (``ops.adam_scalars``:
``1 - b ** step`` in double, rounded once to float32, as
``adam_update_flat_np``), where the reference's tree update takes
``1 - b ** float32(step)`` in float32: the two differ by an ulp of the
correction at most, so the port's tree update is within the
``fused_adam`` tier of the reference's, and the card's update is bitwise
the plain version's on the same inputs.

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

from repro_torch.parallel import dtensor as DT
from repro_torch.tree import at, leaves_with_paths, map_params


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


def init_opt_state(params, cfg: AdamConfig) -> dict:
    """Zero mu and nu and, under ``cfg.master_weights``, a float32 master
    copy of each parameter, on its device."""
    def leaf(p):
        st = {"mu": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
              "nu": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
        if cfg.master_weights:
            st["master"] = p.detach().to(torch.float32, copy=True)
        return st
    return {"leaves": map_params(leaf, params), "step": 0}


def opt_state_shapes(params_shapes, cfg: AdamConfig) -> dict:
    """:func:`init_opt_state` of a meta parameter tree
    (``registry.model_param_shapes``): the state's shapes and dtypes,
    nothing allocated."""
    return init_opt_state(params_shapes, cfg)


def adam_update(params, grads, state, cfg: AdamConfig):
    """One AdamW step of every parameter, in place; returns (params, the
    state at ``step + 1``).  ``grads`` has the parameters' structure; a
    ``None`` gradient (a parameter no loss term reads) is zero, as the
    reference's gradient of such a leaf is.  Without a master copy the
    kernel updates a float32 copy of the parameter.  A ``DTensor``
    parameter (the dry run) is updated shard by shard, on its local
    tensors."""
    from repro_torch.kernels import ops
    step = state["step"] + 1
    with torch.no_grad():
        for path, p in leaves_with_paths(params):
            g, st = at(grads, path), at(state["leaves"], path)
            if DT.is_dtensor(p):
                # the dry run: each device updates its shard; a gradient
                # is first brought to its parameter's placement (the
                # reduce-scatter or all-reduce of data parallelism)
                g = None if g is None else \
                    g.redistribute(p.device_mesh, p.placements).to_local()
                st = {k: v.to_local() for k, v in st.items()}
                p = p.to_local()
            g = torch.zeros(p.numel(), dtype=torch.float32, device=p.device) \
                if g is None else g.detach().reshape(-1).to(torch.float32) \
                .contiguous()
            master = st["master"].view(-1) if "master" in st else \
                p.detach().reshape(-1).to(torch.float32, copy=True)
            ops.fused_adam_(g, master, st["mu"].view(-1), st["nu"].view(-1),
                            step=step, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                            lr=cfg.lr, weight_decay=cfg.weight_decay)
            p.copy_(master.view(p.shape))
    return params, {"leaves": state["leaves"], "step": step}
