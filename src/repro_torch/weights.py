"""Carry parameters between the JAX package and the port as numpy arrays.

``jax.random`` and ``torch.Generator`` give different numbers from one seed,
so a twin run starts both packages from the same weights: the reference's
``(stem, layers, head)`` as numpy arrays, turned into the port's dicts of
tensors by :func:`params_from_numpy`, or the reference's stacked
whole-model tree (``repro.models.transformer.init_params`` or, for an
enc-dec config, ``repro.models.encdec.init_encdec_params``: what its
serving engine takes) by :func:`params_from_stacked`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):     # the port's own leaves, any dtype
        return a.detach().to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, as jax gives it
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(stem, layers, head, device) -> Tuple[Any, List[Any], Any]:
    """Numpy parameter trees -> the port's dicts of tensors on ``device``,
    each leaf keeping its dtype.  A leaf may also be a tensor (copied), so
    a bf16 model's own trees carry over without the float32 round trip of
    :func:`params_to_numpy`."""
    conv = lambda a: _to_tensor(a, device)      # noqa: E731
    return _map(stem, conv), list(_map(list(layers), conv)), _map(head, conv)


def params_to_numpy(stem, layers, head) -> Tuple[Any, List[Any], Any]:
    """The port's parameter trees -> numpy copies (float32 for bf16 leaves,
    which numpy has no type for; converting back rounds exactly)."""
    conv = lambda t: t.detach().cpu().float().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy().copy()  # noqa: E731
    return _map(stem, conv), list(_map(list(layers), conv)), _map(head, conv)


def params_from_stacked(cfg, params, device):
    """The reference's stacked whole-model tree -> the port's
    ``(stem, layers, head)`` on ``device`` (an enc-dec config: its tree,
    :func:`encdec_params_from_stacked`).  The tree holds ``embed``,
    ``segments`` (per segment of ``cfg.block_pattern()``, per pattern
    position, each leaf with a leading ``repeats`` axis), ``final_norm``
    and, unless ``cfg.tie_embeddings``, ``head``.  Layer ``r * len(pat) +
    i`` of a segment is repeat ``r`` of pattern position ``i``; a tied
    config's head holds the final norm alone, as ``registry.init_model``
    makes it."""
    if cfg.is_encdec:
        return encdec_params_from_stacked(cfg, params, device)
    conv = lambda a: _to_tensor(np.asarray(a), device)      # noqa: E731
    stem = {"embed": _map(params["embed"], conv)}
    layers: List[Any] = []
    for (pat, rep), seg in zip(cfg.block_pattern(), params["segments"]):
        for r in range(rep):
            for i in range(len(pat)):
                layers.append(_map(seg[i], lambda a: conv(np.asarray(a)[r])))
    head = {"final_norm": _map(params["final_norm"], conv)}
    if not cfg.tie_embeddings:
        head["head"] = {"w": conv(params["head"]["w"])}
    return stem, layers, head


def encdec_params_from_stacked(cfg, params, device) -> Dict[str, Any]:
    """The reference's enc-dec tree (``embed``, ``enc_pos``, ``encoder``
    and ``decoder`` stacked on a leading layer axis, ``enc_norm``,
    ``final_norm``, ``head``) -> the port's (``models/encdec.py``): the
    same keys, ``encoder`` and ``decoder`` per-layer lists, on
    ``device``; every leaf keeps its dtype (bf16 stays bf16)."""
    conv = lambda a: _to_tensor(np.asarray(a), device)      # noqa: E731
    n_enc = cfg.encoder_layers or cfg.num_layers
    n_dec = cfg.decoder_layers or cfg.num_layers
    out = {k: _map(params[k], conv) for k in
           ("embed", "enc_pos", "enc_norm", "final_norm", "head")}
    for k, n in (("encoder", n_enc), ("decoder", n_dec)):
        out[k] = [_map(params[k], lambda a, i=i: conv(np.asarray(a)[i]))
                  for i in range(n)]
    return out
