"""Flat-state backbone: ZeRO interval tables + per-stage buffers, in PyTorch.

Mirrors ``repro.core.statespace``:

* :class:`IntervalTable` — precomputed, memoized ownership tables for one
  ``(kind, layer_sizes, dp)``; the tables stay numpy int64.  ``gather`` /
  ``scatter`` / ``shard_view`` walk the same precomputed contiguous-run
  slices and work on torch tensors (on any device) and numpy arrays alike.
* :class:`StageState` — one contiguous fp32 buffer per optimizer component
  (``master``/``mu``/``nu``) per stage, in **shard order**, as a tensor on
  the cluster's device; every rank's ZeRO shard is a zero-copy view.
* :class:`EntryFlattener` — the ``ravel_pytree`` leaf order (dict keys
  sorted, lists in order, C order), so flat vectors equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Interval = Tuple[int, int]

COMPONENTS = ("master", "mu", "nu")

STEM = -1      # pseudo entry ids for stage state spaces
HEAD = -2


def _empty(like, n: int):
    if isinstance(like, torch.Tensor):
        return like.new_empty(n)
    return np.empty(n, dtype=like.dtype)


class IntervalTable:
    """Precomputed ownership tables for one ``(kind, layer_sizes, dp)``.

    Semantics match the reference's ``zero.Layout`` exactly, including empty
    intervals and the last-rank remainder.  Use :func:`get_table`.
    """

    __slots__ = ("kind", "layer_sizes", "dp", "total", "entry_offsets",
                 "starts", "ends", "shard_sizes", "shard_offsets",
                 "_runs", "_intervals")

    def __init__(self, kind: str, layer_sizes: Tuple[int, ...], dp: int):
        assert kind in ("contiguous", "interleaved"), kind
        self.kind = kind
        self.layer_sizes = tuple(int(s) for s in layer_sizes)
        self.dp = int(dp)
        sizes = np.asarray(self.layer_sizes, dtype=np.int64)
        self.total = int(sizes.sum())
        self.entry_offsets = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(sizes)])
        if kind == "contiguous":
            per = self.total // self.dp
            starts = (np.arange(self.dp, dtype=np.int64) * per)[:, None]
            ends = starts + per
            ends[self.dp - 1, 0] = self.total
        else:
            per = sizes // self.dp
            starts = (self.entry_offsets[:-1][None, :]
                      + np.arange(self.dp, dtype=np.int64)[:, None] * per[None, :])
            ends = starts + per[None, :]
            if len(self.layer_sizes):
                ends[self.dp - 1, :] = self.entry_offsets[1:]
        self.starts, self.ends = starts, ends
        lens = ends - starts
        self.shard_sizes = lens.sum(axis=1)
        self.shard_offsets = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(self.shard_sizes)])
        # contiguous-run copy list (stage_start, stage_end, shard_off), built
        # once: gather/scatter are a few slice copies, on host or device
        runs: List[Tuple[int, int, int]] = []
        off = 0
        for j in range(self.dp):
            for s, e in zip(starts[j], ends[j]):
                s, e = int(s), int(e)
                if e > s:
                    runs.append((s, e, off))
                    off += e - s
        self._runs = runs
        self._intervals: List[Optional[List[Interval]]] = [None] * self.dp

    def owner_intervals(self, rank: int) -> List[Interval]:
        """Intervals of the stage state space owned by ``rank`` (cached)."""
        cached = self._intervals[rank]
        if cached is None:
            cached = [(int(s), int(e)) for s, e in
                      zip(self.starts[rank], self.ends[rank])]
            self._intervals[rank] = cached
        return list(cached)

    def layer_interval(self, layer_pos: int) -> Interval:
        return (int(self.entry_offsets[layer_pos]),
                int(self.entry_offsets[layer_pos + 1]))

    def gather(self, full):
        """Stage-space vector -> shard-order flat buffer."""
        out = _empty(full, self.total)
        for s, e, o in self._runs:
            out[o:o + (e - s)] = full[s:e]
        return out

    def scatter(self, flat, out=None):
        """Shard-order flat buffer -> stage-space vector."""
        if out is None:
            out = _empty(flat, self.total)
        for s, e, o in self._runs:
            out[s:e] = flat[o:o + (e - s)]
        return out

    def shard_slice(self, j: int) -> slice:
        return slice(int(self.shard_offsets[j]), int(self.shard_offsets[j + 1]))

    def shard_view(self, flat, j: int):
        """Rank ``j``'s shard as a zero-copy view of the flat buffer."""
        return flat[self.shard_slice(j)]

    def split(self, flat) -> list:
        """All ranks' shards as views, in rank order."""
        return [self.shard_view(flat, j) for j in range(self.dp)]


_TABLE_CACHE: Dict[Tuple[str, Tuple[int, ...], int], IntervalTable] = {}


def get_table(kind: str, layer_sizes: Sequence[int], dp: int) -> IntervalTable:
    """Memoized IntervalTable lookup."""
    key = (kind, tuple(int(s) for s in layer_sizes), int(dp))
    tbl = _TABLE_CACHE.get(key)
    if tbl is None:
        tbl = IntervalTable(*key)
        _TABLE_CACHE[key] = tbl
    return tbl


@dataclasses.dataclass
class StageState:
    """Optimizer state of one pipeline stage, ZeRO-1 sharded over its DP group.

    ``flat[comp]`` is ONE contiguous fp32 tensor in **shard order** (rank 0's
    owned elements, then rank 1's, ...) on the cluster's device; each rank's
    shard is a zero-copy view.
    """
    entries: List[int]                      # [STEM?] + layer ids + [HEAD?]
    sizes: List[int]                        # element count per entry
    layout_kind: str
    dp_ranks: List[int]                     # surviving dp indices of this group
    flat: Dict[str, torch.Tensor]           # comp -> shard-order buffer

    @classmethod
    def from_full(cls, entries: List[int], sizes: List[int], kind: str,
                  dp_ranks: List[int],
                  full_by_comp: Dict[str, torch.Tensor]) -> "StageState":
        tbl = get_table(kind, sizes, len(dp_ranks))
        flat = {c: tbl.gather(full_by_comp[c].float()) for c in COMPONENTS}
        return cls(list(entries), list(sizes), kind, list(dp_ranks), flat)

    @property
    def table(self) -> IntervalTable:
        return get_table(self.layout_kind, self.sizes, len(self.dp_ranks))

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def shards(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """``{dp_rank: {comp: shard-view}}`` — zero-copy."""
        tbl = self.table
        return {r: {c: tbl.shard_view(self.flat[c], j) for c in COMPONENTS}
                for j, r in enumerate(self.dp_ranks)}

    def shard(self, r: int) -> Dict[str, torch.Tensor]:
        j = self.dp_ranks.index(r)
        tbl = self.table
        return {c: tbl.shard_view(self.flat[c], j) for c in COMPONENTS}

    def full(self, comp: str = "master") -> torch.Tensor:
        """All-gather equivalent: the stage's full state-space vector."""
        return self.table.scatter(self.flat[comp])


# --------------------------------------------------------------------------
# ravel_pytree-ordered flattening of parameter trees
# --------------------------------------------------------------------------
def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, lists and tuples
    in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


class EntryFlattener:
    """Flat fp32 vectors of the VirtualCluster's state-space entries (STEM /
    layer id / HEAD) in ``ravel_pytree``'s element order."""

    def __init__(self):
        self._entry_leaves: Dict[int, List[torch.Tensor]] = {}

    def flatten_entry(self, entry: int, tree) -> torch.Tensor:
        """The entry's leaves, raveled in C order and concatenated as fp32;
        remembers the leaves for :meth:`write_entry`."""
        leaves = tree_leaves(tree)
        self._entry_leaves[entry] = leaves
        return flatten_leaves(leaves)

    def write_entry(self, entry: int, vec: torch.Tensor) -> None:
        """Copy ``vec`` into the entry's leaves in place, each cast to its
        leaf's dtype (round to nearest even, as ravel_pytree's unravel)."""
        off = 0
        with torch.no_grad():
            for leaf in self._entry_leaves[entry]:
                n = leaf.numel()
                leaf.copy_(vec[off:off + n].view(leaf.shape))
                off += n
        assert off == vec.numel(), (off, vec.numel())


def flatten_leaves(leaves: Sequence[torch.Tensor],
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate raveled leaves as one fp32 vector (into ``out`` if given)."""
    n = sum(x.numel() for x in leaves)
    if out is None:
        dev = leaves[0].device if leaves else None
        out = torch.empty(n, dtype=torch.float32, device=dev)
    off = 0
    for x in leaves:
        out[off:off + x.numel()].copy_(x.reshape(-1))
        off += x.numel()
    return out
