"""Step functions and input shapes of every (arch x shape) dry-run cell,
mirroring ``repro.launch.steps``.

Cell kinds:
  train_*   -> train_step(params, opt_state, batch) -> (params, opt_state, loss)
  prefill_* -> prefill_step(params, caches, tokens[, frames]) -> (logits, caches)
  decode_* / long_* -> decode_step(params, caches, tokens[, enc_out], index)

A cell's ``arg_shapes`` are trees of meta tensors (nothing allocated at
full size), its ``arg_pspecs`` and ``out_pspecs`` trees of specs
(``parallel/sharding.py``), ``donate`` the reference's.  ``fn`` runs on
real tensors: the train step updates the parameters and the AdamW state in
place (``optim/adam.py``), the port's counterpart of donating them, and the
serving steps write the caches in place.  The AdamW state's ``step`` is a
Python int, as ``adam.init_opt_state`` keeps it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch import train as TR
from repro_torch.models import encdec as E
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import AdamConfig, opt_state_shapes
from repro_torch.parallel import dtensor as DT
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import Spec
from repro_torch.tree import leaves_with_paths


@dataclasses.dataclass
class Cell:
    kind: str                       # "train" | "prefill" | "decode"
    fn: Callable
    arg_shapes: Tuple[Any, ...]     # trees of meta tensors
    arg_pspecs: Tuple[Any, ...]     # trees of specs
    out_pspecs: Any
    donate: Tuple[int, ...]


def shape_kind(shape_name: str) -> str:
    if shape_name.startswith("train"):
        return "train"
    if shape_name.startswith("prefill"):
        return "prefill"
    return "decode"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    sh: Dict[str, Any] = {
        "tokens": _meta((batch, seq), torch.int32),
        "labels": _meta((batch, seq), torch.int32),
    }
    if cfg.is_encdec:
        sh["frames"] = _meta((batch, cfg.max_source_positions, cfg.d_model),
                             cfg.torch_dtype)
    if cfg.frontend_embeds:
        sh["prefix_embeds"] = _meta((batch, cfg.frontend_embeds, cfg.d_model),
                                    cfg.torch_dtype)
    return sh


def build_cell(cfg: ModelConfig, shape_name: str, seq: int, batch: int,
               mesh, adam: Optional[AdamConfig] = None,
               remat: bool = True) -> Cell:
    """The cell of ``cfg`` at ``shape_name`` (its kind), ``seq`` x
    ``batch``, its specs on ``mesh`` (a ``MeshShape`` or a ``DeviceMesh``);
    a train cell's loss under ``remat`` (the reference's default)."""
    kind = shape_kind(shape_name)
    adam = adam or AdamConfig()
    params_sh = R.model_param_shapes(cfg)
    pspec_params = S.param_pspecs(cfg, mesh, params_sh)

    if kind == "train":
        batch_sh = _batch_shapes(cfg, batch, seq)
        opt_sh = opt_state_shapes(params_sh, adam)
        pspec_opt = _opt_pspecs_like(pspec_params)
        pspec_batch = S.batch_pspecs(cfg, mesh, batch_sh)
        loss_fn = _gathered(R.make_train_loss(cfg, remat=remat), mesh)

        def train_step(params, opt_state, batch_):
            leaves = [t for _, t in leaves_with_paths(params)]
            for t in leaves:
                t.requires_grad_(True)
            try:
                loss, opt_state = TR.train_step(params, opt_state, batch_,
                                                loss_fn, adam)
            finally:
                for t in leaves:
                    t.requires_grad_(False)
            return params, opt_state, loss

        return Cell("train", train_step,
                    (params_sh, opt_sh, batch_sh),
                    (pspec_params, pspec_opt, pspec_batch),
                    (pspec_params, pspec_opt, Spec()),
                    donate=(0, 1))

    # serving cells
    if cfg.is_encdec:
        return _encdec_serving_cell(cfg, kind, seq, batch, mesh,
                                    params_sh, pspec_params)
    dp = S.dp_axes(mesh)
    caches_sh = T.cache_shapes(cfg, batch, seq)
    pspec_caches = S.cache_pspecs(cfg, mesh, caches_sh)
    if kind == "prefill":
        def prefill_step(params, caches, tokens):
            return T.prefill(DT.gather_axes(params, dp), cfg, tokens, caches)

        return Cell("prefill", prefill_step,
                    (params_sh, caches_sh, _meta((batch, seq), torch.int32)),
                    (pspec_params, pspec_caches,
                     S._spec(mesh, (batch, seq), S.dp_axes(mesh), None)),
                    (Spec(), pspec_caches),
                    donate=(1,))

    def decode_step(params, caches, tokens, index):
        return T.decode_step(DT.gather_axes(params, dp), cfg, tokens, caches,
                             index)

    return Cell("decode", decode_step,
                (params_sh, caches_sh, _meta((batch, 1), torch.int32),
                 _meta((), torch.int32)),
                (pspec_params, pspec_caches,
                 S._spec(mesh, (batch, 1), S.dp_axes(mesh), None), Spec()),
                (Spec(), pspec_caches),
                donate=(1,))


def _encdec_serving_cell(cfg, kind, seq, batch, mesh, params_sh,
                         pspec_params) -> Cell:
    dp = S.dp_axes(mesh)
    caches_sh = E.init_decoder_caches(cfg, batch, seq, device="meta")
    pspec_caches = S.cache_pspecs(cfg, mesh, caches_sh)
    enc_sh = _meta((batch, cfg.max_source_positions, cfg.d_model),
                   cfg.torch_dtype)
    enc_spec = S._spec(mesh, tuple(enc_sh.shape), S.dp_axes(mesh), None, None)
    if kind == "prefill":
        def prefill_step(params, caches, tokens, frames):
            params = DT.gather_axes(params, dp)
            enc = E.encode(params, cfg, frames)
            logits, caches = E.decode(params, cfg, tokens, enc,
                                      caches=caches, cache_index=0,
                                      last_only=True)
            return logits[:, -1:, :], caches

        frames_sh = _meta((batch, cfg.max_source_positions, cfg.d_model),
                          cfg.torch_dtype)
        return Cell("prefill", prefill_step,
                    (params_sh, caches_sh, _meta((batch, seq), torch.int32),
                     frames_sh),
                    (pspec_params, pspec_caches,
                     S._spec(mesh, (batch, seq), S.dp_axes(mesh), None),
                     enc_spec),
                    (Spec(), pspec_caches), donate=(1,))

    def decode_step(params, caches, tokens, enc_out, index):
        return E.encdec_decode_step(DT.gather_axes(params, dp), cfg, tokens,
                                    enc_out, caches, index)

    return Cell("decode", decode_step,
                (params_sh, caches_sh, _meta((batch, 1), torch.int32), enc_sh,
                 _meta((), torch.int32)),
                (pspec_params, pspec_caches,
                 S._spec(mesh, (batch, 1), S.dp_axes(mesh), None),
                 enc_spec, Spec()),
                (Spec(), pspec_caches), donate=(1,))


def _gathered(loss_fn, mesh):
    """``loss_fn`` on the parameters with their data-parallel shards
    gathered (``parallel.dtensor.gather_axes``: the FSDP all-gather, and
    the gradients' reduce-scatter in the backward), the same tree for
    plain tensors."""
    dp = S.dp_axes(mesh)

    def fn(params, batch, rng_ctx=None):
        return loss_fn(DT.gather_axes(params, dp), batch, rng_ctx)

    return fn


def _opt_pspecs_like(pspec_params):
    """Adam leaves {mu, nu, master} share their param's spec; the scalar
    step is replicated."""
    leaves_spec = S.map_with_path(
        lambda _, spec: {"mu": spec, "nu": spec, "master": spec},
        pspec_params)
    return {"leaves": leaves_spec, "step": Spec()}
