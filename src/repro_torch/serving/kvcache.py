"""Slot-indexed KV-cache pools with gather/scatter moves, mirroring
``repro.serving.kvcache``.

Each serving replica owns one :class:`KVPool` — the per-layer cache list of
``models.registry.serving_hooks(cfg, device).init_caches(n_slots,
max_len)`` plus per-slot occupancy metadata.  Every cache tensor carries the
slot dimension on axis 0 (the reference stacks a segment's layers on axis 0
and puts slots on axis 1).  The reference's per-slot extras (an enc-dec
encoder output) wait for the enc-dec slice: a pool holds none.

A migration between replicas is ``gather_slots`` on the source pool +
``scatter_slots`` into the destination pool — a plain copy, so migrated
decode streams are bit-identical to undisturbed ones.  Unlike the
reference's functional updates, ``scatter_slots`` writes into ``dst`` in
place.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

SLOT_AXIS = 0        # per-layer caches: [slot, ...]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _index(ids: Sequence[int], device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)


def gather_slots(tree, ids: Sequence[int]):
    """Copies of the slots ``ids`` of every tensor (one index per tensor,
    slot axis 0)."""
    return _map(tree, lambda a: a[_index(ids, a.device)])


def scatter_slots(dst, src, ids: Sequence[int]):
    """Write ``src`` (a gathered slice) into ``dst`` at ``ids``, in place;
    returns ``dst``."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        d[_index(ids, d.device)] = s.to(device=d.device, dtype=d.dtype)
    return dst


def tree_nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in _leaves(tree)))


def slot_kv_bytes(cfg, max_len: int) -> int:
    """Per-slot KV bytes for migration accounting, from cache *shapes* only
    (the caches of one slot on the ``meta`` device: nothing is
    allocated)."""
    from repro_torch.models import transformer as T
    return tree_nbytes(T.init_caches(cfg, 1, max_len, device="meta"))


class KVPool:
    """Per-replica slot bookkeeping over one per-layer cache list.

    ``caches=None`` puts the pool in synthetic mode (scheduler/latency runs
    at trace scale): occupancy and byte accounting behave identically but no
    arrays are moved.
    """

    def __init__(self, n_slots: int, caches=None, *, slot_bytes: int = 0):
        self.n_slots = int(n_slots)
        self.caches = caches
        self.extras = None                 # no per-slot extras (see above)
        self.slot_req = np.full(self.n_slots, -1, dtype=np.int64)
        self.lengths = np.zeros(self.n_slots, dtype=np.int64)
        self._slot_bytes = int(slot_bytes) if slot_bytes else (
            tree_nbytes(caches) // max(self.n_slots, 1) if caches is not None
            else 0)

    # -- occupancy ---------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.slot_req < 0)]

    def active_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.slot_req >= 0)]

    @property
    def n_free(self) -> int:
        return int((self.slot_req < 0).sum())

    @property
    def n_active(self) -> int:
        return self.n_slots - self.n_free

    def assign(self, slot: int, rid: int, length: int = 0):
        assert self.slot_req[slot] < 0, f"slot {slot} occupied"
        self.slot_req[slot] = rid
        self.lengths[slot] = length

    def release(self, slot: int):
        self.slot_req[slot] = -1
        self.lengths[slot] = 0

    def slot_bytes(self, slot: int) -> int:
        del slot  # uniform slots (max_len-sized); kept for API symmetry
        return self._slot_bytes

    # -- array movement ----------------------------------------------------
    def write(self, slot: int, cache_slice, extra_slice=None):
        """Scatter a single gathered slice ([1, ...]) into ``slot``."""
        if extra_slice is not None:
            raise NotImplementedError(
                "per-slot extras (enc-dec encoder outputs) wait for the "
                "enc-dec slice of the port")
        if self.caches is not None and cache_slice is not None:
            scatter_slots(self.caches, cache_slice, [slot])

    def read(self, slot: int):
        """Gather one slot's (cache, extras) slices (shapes keep the slot
        dim, so they scatter straight into another pool); extras are
        always None."""
        c = (gather_slots(self.caches, [slot]) if self.caches is not None
             else None)
        return c, None


def migrate_slot(src: KVPool, src_slot: int, dst: KVPool, dst_slot: int,
                 rid: int) -> int:
    """Move one in-flight slot between replicas; returns bytes moved.
    Pure gather+scatter — the migrated stream's continuation is
    bit-identical."""
    c, e = src.read(src_slot)
    length = int(src.lengths[src_slot])
    dst.assign(dst_slot, rid, length)
    dst.write(dst_slot, c, e)
    src.release(src_slot)
    return src.slot_bytes(src_slot)
