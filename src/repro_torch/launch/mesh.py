"""The production mesh of the hybrid-parallel layout, mirroring
``repro.launch.mesh``: ``("data", "model")`` = (16, 16) on one pod, or
``("pod", "data", "model")`` = (2, 16, 16) on two.

:class:`MeshShape` holds the axes' names and sizes alone, which is all the
placement rules (``parallel/sharding.py``) read of a mesh, so a cell's
specs are built with no process group.  :func:`make_production_mesh` and
:func:`make_mesh` return a ``torch.distributed`` ``DeviceMesh`` over the
process group already initialised; they raise if there is none or if its
world size is not the mesh's.

Functions only, as in the reference: importing this module touches no
device and no process group (the dry run initialises a fake process group
of 256 or 512 ranks before it builds the mesh).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes, in order: ``axis_names`` and ``sizes``.  ``shape``
    is the ordered name -> size dict a jax ``Mesh`` gives."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    m = production_mesh_shape(multi_pod)
    return make_mesh(m.sizes, m.axis_names, device_type=device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group, whose world size must be the product of ``shape``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks; mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
