"""Per-device counts of a dry-run cell and its roofline terms, the port's
counterpart of ``repro.launch.hlo_analysis``.

compute term    = FLOPs / (chips * peak)
memory term     = bytes / (chips * hbm_bw)
collective term = collective_bytes / (chips * link_bw)

The reference reads its counts from XLA: ``cost_analysis()`` of the
compiled, SPMD-partitioned program and the collectives parsed out of its
HLO text.  The port has no HLO.  Its dry run runs a cell's step on meta
``DTensor``s over a fake process group (``launch/dryrun.py``), and
:class:`DeviceCounter`, a ``TorchDispatchMode``, counts the ATen ops one
device runs there:

* An op on ``DTensor``s is handed back to DTensor (``NotImplemented``), as
  ``CommDebugMode`` does, so the counter sees the local ops that DTensor's
  sharding propagation chose, on the local shards, and the c10d functional
  collectives it runs.  A mode that counted the ``DTensor`` op itself
  would count the global op: ``[64, 1024, 8192] @ [8192, 28672]`` with x
  split 16 ways on its batch and w 16 ways on its columns is 3.08e13 FLOPs
  globally, 1.20e11 on one device.
* FLOPs are ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) on the local shapes.  Elementwise work is not
  counted: XLA counts it, so the port's count is below the reference's.
* Ops that DTensor runs to propagate shardings (on fake tensors of the
  global shapes, under a ``FakeTensorMode``) or to plan a redistribution
  (its functions on the Python stack) are not counted: no device runs
  them.
* Bytes are each local op's input and output bytes, views and
  allocations excluded.  Nothing is fused, so this is an upper bound of
  what the fused program moves.
* Collective bytes are operand bytes by kind, the reference's convention:
  an all-gather's operand is its local input, a reduce-scatter's its full
  input, an all-reduce's, all-to-all's and permute's their operand.  On a
  ``"cpu"`` mesh DTensor runs a shard-dim all-to-all as an all-gather and
  a chunk; an all-gather started from inside
  ``_collective_utils.shard_dim_alltoall`` (seen on the Python stack) is
  counted as the all-to-all it stands in for, its operand the local input.
* ``peak_live`` is the most bytes of op outputs alive at once (storages
  tracked until the last tensor on them dies), over the arguments, which
  the caller adds.

Importing this module touches no process group and no device.
"""
from __future__ import annotations

import sys
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# NVIDIA H100 SXM5 80GB HBM3 (700 W) data-sheet rates, not measured
# times: the bf16 dense tensor-core peak and the HBM3 bandwidth (as
# chip_smoke.py takes them), and one 400 Gb/s InfiniBand port a GPU.  The
# (16, 16) mesh spans 32 HGX nodes of 8 GPUs and both axes' groups cross
# nodes, so a collective runs at the InfiniBand rate; NVLink 4, 900 GB/s a
# GPU, would be the rate of groups inside one node.
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_LINK_BW = 50e9

_FAKE = torch._C._TorchDispatchModeKey.FAKE
_FUNCOL = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor",
           "c10d_functional")
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# ops that move no data: views share their input's storage, an empty
# allocation writes nothing
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# DTensor's sharding propagation and redistribution planning run ops of
# their own (on fake or meta tensors) that no device runs
_PLANNING = {"_propagate_op_sharding_dispatch_slow_path",
             "propagate_op_sharding_non_cached", "redistribute_cost",
             "_gen_transform_infos_non_cached"}


def _in_frame(names) -> bool:
    """True when a function named in ``names`` is on the Python stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in names:
            return True
        f = f.f_back
    return False


class DeviceCounter(TorchDispatchMode):
    """Counts what one device runs under it: ``flops``, ``bytes``,
    ``coll`` (operand bytes by kind, :data:`COLLECTIVES`) and
    ``peak_live`` (bytes of op outputs alive at once)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.live = 0
        self.peak_live = 0
        self._refs: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs the local ops
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(_FAKE) is not None or \
                _in_frame(_PLANNING):
            return out      # DTensor's sharding propagation and planning
        name = func._schema.name.split("::")[-1]
        if func.namespace in _FUNCOL:
            kind = _KIND.get(name)
            if kind == "all-gather" and _in_frame(("shard_dim_alltoall",)):
                kind = "all-to-all"
            if kind is not None:
                # every kind's operand is its (local) input, under the
                # reference's convention
                self.coll[kind] += sum(_nbytes(t) for t in
                                       _tensors((args, kwargs)))
            return out
        fn = self._flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t)
                              for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self.live += st.nbytes()
            self.peak_live = max(self.peak_live, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key, st.nbytes())

    def _release(self, key: int, nbytes: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live -= nbytes

    def collective_bytes(self) -> Dict[str, float]:
        """The reference's ``collective_bytes`` dict: operand bytes by
        kind and their ``total``."""
        out = dict(self.coll)
        out["total"] = sum(out[k] for k in COLLECTIVES)
        return out


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int, peak_flops: float = H100_PEAK_FLOPS,
                   hbm_bw: float = H100_HBM_BW, link_bw: float = H100_LINK_BW,
                   ) -> Dict[str, float]:
    compute = flops / (chips * peak_flops)
    memory = bytes_accessed / (chips * hbm_bw)
    collective = coll_bytes / (chips * link_bw)
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda kv: kv[1])
    return {
        "compute_s": compute, "memory_s": memory, "collective_s": collective,
        "bottleneck": dom[0],
        "roofline_s": max(compute, memory, collective),
    }
