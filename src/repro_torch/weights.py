"""Carry parameters between the JAX package and the port as numpy arrays.

``jax.random`` and ``torch.Generator`` give different numbers from one seed,
so a twin run starts both packages from the same weights: the reference's
``(stem, layers, head)`` as numpy arrays, turned into the port's dicts of
tensors by :func:`params_from_numpy`.
"""
from __future__ import annotations

from typing import Any, List, Tuple

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
