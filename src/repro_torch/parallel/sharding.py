"""Placement rules of the production layout, mirroring
``repro.parallel.sharding``.

Mesh axes:
  single-pod: ("data", "model") = (16, 16)
  multi-pod : ("pod", "data", "model") = (2, 16, 16)

Policy (FSDP + TP, adapted per family), as the reference's:
  * batch                -> ("pod","data")          [DP]
  * weight in-dim  (d)   -> ("pod","data")          [ZeRO-3 / FSDP shard]
  * weight out-dim (ff/heads/vocab) -> "model"      [TP]
  * MoE expert dim       -> "model"                 [EP]
  * KV cache: batch -> DP axes; heads -> "model" if divisible, else seq -> "model"
  * every rule degrades to None if the dim is not divisible by the axis group
    (e.g. vocab 50280 or 51865 cannot shard over 16).

A spec (:class:`Spec`, the port's ``PartitionSpec``) is a tuple with one
entry a tensor dimension: ``None``, an axis name, or a tuple of names (the
dimension split over those axes, the first one major).  The rules take a
``MeshShape`` (``launch/mesh.py``) or a ``DeviceMesh`` and walk the port's
trees: ``(stem, layers, head)`` with one dict a layer, an enc-dec config's
``encoder`` and ``decoder`` lists, the per-layer cache list.  The reference
stacks a segment's layers on a leading axis and gives it a leading
``None``; a port layer's spec is that spec without it.  The leaf-name rules
are the reference's, applied to each layer's leaves.

:func:`to_placements` turns a spec into ``DTensor`` placements, one a mesh
dimension.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig


class Spec(tuple):
    """One entry a tensor dimension: None, an axis name or a tuple of
    names.  A tuple subclass, so that spec trees (dicts, lists, tuples)
    can tell a spec from a tuple of subtrees."""

    def __new__(cls, entries=()):
        return super().__new__(cls, tuple(entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """The ordered axis name -> size of a ``MeshShape`` (or anything with
    a ``shape`` dict) or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def mesh_axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _fit(mesh, size: int, axes) -> Optional[Any]:
    """Return `axes` if `size` divides evenly over them, trying suffixes of
    the axis tuple before giving up (e.g. ("pod","data") -> ("data",))."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    for start in range(len(axes)):
        cand = axes[start:]
        if size % mesh_axis_size(mesh, cand) == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


def _spec(mesh, shape, *dim_axes) -> Spec:
    """Build a spec fitting each dim; drop axes that don't divide."""
    assert len(shape) == len(dim_axes), (shape, dim_axes)
    used = set()
    entries = []
    for size, axes in zip(shape, dim_axes):
        fitted = _fit(mesh, size, axes)
        # an axis name may appear at most once in a spec
        if fitted is not None:
            names = (fitted,) if isinstance(fitted, str) else tuple(fitted)
            if any(n in used for n in names):
                fitted = None
            else:
                used.update(names)
        entries.append(fitted)
    return Spec(entries)


# --------------------------------------------------------------------------
# Trees of specs
# --------------------------------------------------------------------------
def map_with_path(fn: Callable, tree, prefix: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples whose
    leaves are tensors (or specs), as a tree of the same structure."""
    if isinstance(tree, Spec) or not isinstance(tree, (dict, list, tuple)):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return type(tree)(map_with_path(fn, v, prefix + (i,))
                      for i, v in enumerate(tree))


def spec_leaves(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Spec]]:
    """(path, spec) of every spec, in ``tree.leaves_with_paths``' order
    (dict keys sorted)."""
    if isinstance(tree, Spec):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in spec_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in spec_leaves(t, prefix + (i,))]
    raise TypeError(f"not a spec tree leaf at {prefix}: {tree!r}")


# --------------------------------------------------------------------------
# Parameter placements
# --------------------------------------------------------------------------
def param_pspecs(cfg: ModelConfig, mesh, params_shapes) -> Any:
    """Map a params shape tree (``registry.model_param_shapes``) -> a spec
    tree, by the reference's leaf-name rules on each layer's leaves."""
    DP = dp_axes(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1] if path else ""

        def out(*axes):
            return _spec(mesh, shape, *axes)

        if name == "embedding":
            return out("model", DP)
        if name in ("wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b",
                    "wg", "wu", "wi", "in_proj"):
            if len(shape) == 3:          # MoE expert weights [E, d, ff]
                return out("model", DP, None)
            return out(DP, "model")
        if name in ("wo", "out_proj"):
            if len(shape) == 3:          # MoE [E, ff, d]
                return out("model", None, DP)
            return out("model", DP)
        if name == "w":                  # lm head [d, V]
            return out(DP, "model")
        if name == "router":
            return out(DP, None)
        if name == "conv_w":
            return out(None, "model")
        if name == "enc_pos":
            return out(None, DP)
        # scale / A_log / D / dt_bias / other small vectors: replicate
        return Spec((None,) * len(shape))

    return map_with_path(rule, params_shapes)


def batch_pspecs(cfg: ModelConfig, mesh, batch_shapes) -> Any:
    DP = dp_axes(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        sp = [None] * len(shape)
        sp[0] = _fit(mesh, shape[0], DP)
        return Spec(sp)

    return map_with_path(rule, batch_shapes)


def cache_pspecs(cfg: ModelConfig, mesh, cache_shapes) -> Any:
    """Per-layer caches: KV [B, T, Hkv, hd] / MLA latent [B, T, r] /
    mamba ssm [B, h, p, n], conv [B, k-1, c] (the reference's stacked
    shapes without their leading layer axis)."""
    DP = dp_axes(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 4 and "ssm" not in path:      # [B,T,H,hd]
            if _fit(mesh, shape[2], "model") is not None:
                return _spec(mesh, shape, DP, None, "model", None)
            return _spec(mesh, shape, DP, "model", None, None)
        if len(shape) == 4:                            # mamba ssm [B,h,p,n]
            return _spec(mesh, shape, DP, "model", None, None)
        if len(shape) == 3:                            # MLA latent / conv
            # [B,T,r] -> shard T over model when batch tiny
            return _spec(mesh, shape, DP, "model", None)
        return Spec((None,) * len(shape))

    return map_with_path(rule, cache_shapes)


def opt_pspecs(param_specs) -> Any:
    """Adam mu/nu/master share the param sharding; scalars replicated."""
    return param_specs


# --------------------------------------------------------------------------
# DTensor placements
# --------------------------------------------------------------------------
def to_placements(mesh, spec) -> list:
    """One ``DTensor`` placement a mesh dimension for ``spec``: ``Shard(d)``
    where that mesh axis splits tensor dim ``d``, else ``Replicate()``.  A
    dim split over several axes is ``Shard(d)`` on each: DTensor splits in
    mesh-dimension order, so the first axis is major, as in the spec, if
    the spec names them in mesh order (the only order the rules emit).
    Any other order would need ``_StridedShard``: it raises, as does an
    axis named twice or not in the mesh."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    taken = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the "
                                 f"mesh's {tuple(names)}")
            if a in taken:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            taken.add(a)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} is split over {axes} "
                             f"out of the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out
