"""The reference's stacked trees (params, AdamW state, caches, and their
PartitionSpec and ShapeDtypeStruct trees) in the port's per-layer layout,
for the placement and cell twins.  Not a test module: nothing here is
collected.

The reference stacks a segment's layers (and an enc-dec config's encoder
and decoder) on a leading axis; the port keeps one dict a layer, as
``repro_torch.weights.params_from_stacked`` carries weights across.  Here
a stacked leaf becomes ``strip(leaf)`` once a layer: its spec without the
leading ``None``, or its shape without the leading axis.
"""
import jax
import numpy as np
import torch
from jax.sharding import PartitionSpec as P


MESHES = {"16x16": False, "2x16x16": True}


class FakeMesh:
    """Just enough of a Mesh for the reference's rule functions."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def meshes(multi_pod: bool):
    """The port's production ``MeshShape`` and the reference's duck mesh
    of the same axes."""
    from repro_torch.launch.mesh import production_mesh_shape
    m = production_mesh_shape(multi_pod)
    return m, FakeMesh(m.shape)


def is_leaf(x) -> bool:
    return isinstance(x, (P, jax.ShapeDtypeStruct))


def _map(fn, tree):
    return jax.tree.map(fn, tree, is_leaf=is_leaf)


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, str(np.dtype(dtype)))


def strip_spec(spec: P):
    """A stacked leaf's spec without its leading ``None``, as the port's
    ``Spec``."""
    from repro_torch.parallel.sharding import Spec
    assert spec[0] is None, spec
    return Spec(tuple(spec)[1:])


def keep_spec(spec: P):
    from repro_torch.parallel.sharding import Spec
    return Spec(tuple(spec))


def strip_shape(s: jax.ShapeDtypeStruct) -> torch.Tensor:
    """A stacked leaf's shape without its leading axis, as a meta
    tensor."""
    return torch.empty(s.shape[1:], dtype=_torch_dtype(s.dtype),
                       device="meta")


def keep_shape(s: jax.ShapeDtypeStruct) -> torch.Tensor:
    return torch.empty(s.shape, dtype=_torch_dtype(s.dtype), device="meta")


def params_to_port(cfg, tree, strip, keep):
    """The reference's params-shaped tree (params, their specs, or the
    AdamW state's ``leaves``) -> the port's layout, ``strip`` on stacked
    leaves and ``keep`` on the rest."""
    if cfg.is_encdec:
        out = {k: _map(keep, tree[k]) for k in
               ("embed", "enc_pos", "enc_norm", "final_norm", "head")}
        for k, n in (("encoder", cfg.encoder_layers or cfg.num_layers),
                     ("decoder", cfg.decoder_layers or cfg.num_layers)):
            out[k] = [_map(strip, tree[k]) for _ in range(n)]
        return out
    layers = []
    for (pat, rep), seg in zip(cfg.block_pattern(), tree["segments"]):
        for _ in range(rep):
            layers.extend(_map(strip, seg[i]) for i in range(len(pat)))
    head = {"final_norm": _map(keep, tree["final_norm"])}
    if not cfg.tie_embeddings:
        head["head"] = _map(keep, tree["head"])
    return {"embed": _map(keep, tree["embed"])}, layers, head


def caches_to_port(cfg, tree, strip) -> list:
    """The reference's stacked caches (per segment, per pattern position;
    an enc-dec config's one stacked dict) -> one dict a layer."""
    if cfg.is_encdec:
        return [_map(strip, tree) for _ in range(cfg.decoder_layers
                                                 or cfg.num_layers)]
    out = []
    for (pat, rep), seg in zip(cfg.block_pattern(), tree):
        for _ in range(rep):
            out.extend(_map(strip, seg[i]) for i in range(len(pat)))
    return out


def flat(tree, prefix=()) -> dict:
    """{path: leaf} of a tree of dicts, lists and tuples whose leaves are
    specs (``sharding.Spec``) or tensors."""
    from repro_torch.parallel.sharding import Spec
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (k,)))
    return out


def specs(tree) -> dict:
    """{path: tuple} of a spec tree."""
    return {k: tuple(v) for k, v in flat(tree).items()}


def shapes(tree) -> dict:
    """{path: (shape, dtype)} of a tree of tensors (ints kept as they
    are: the AdamW state's step)."""
    return {k: (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
            else v for k, v in flat(tree).items()}


def assert_same(port: dict, ref: dict, what: str) -> None:
    assert port.keys() == ref.keys(), (what, sorted(
        set(port) ^ set(ref), key=str)[:5])
    bad = [(k, port[k], ref[k]) for k in port if port[k] != ref[k]]
    assert not bad, (what, len(bad), bad[:5])
