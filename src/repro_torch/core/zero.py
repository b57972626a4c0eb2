"""ZeRO optimizer-state layouts (paper §6.3): Contiguous vs Interleaved.

State space: per *stage*, the concatenation of its layers' flattened optimizer
vectors.  Ownership within the stage's DP group:

* **Contiguous**: one global byte array per DP group; rank j owns one
  contiguous block of ~equal size.  Migrating layer i's state across stages
  shifts every cut point by ~|O_i|/D -> many-to-many intra-stage resharding;
  total bytes ~= (D+1)/2 * |O_i|.
* **Interleaved**: each layer's vector is split into D equal shards; rank j
  owns shard j of *every* layer.  Migration = D disjoint rank-to-rank sends;
  total bytes = |O_i| and no intra-stage resharding.

`migration_plan` returns the exact transfer list (src_rank, dst_rank, nbytes,
intra_stage) for either layout, priced by core/migration.py.

A copy of ``repro.core.zero`` (the JAX package), numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]   # [start, end) byte offsets


@dataclasses.dataclass(frozen=True)
class Layout:
    kind: str                           # "contiguous" | "interleaved"
    layer_sizes: Tuple[int, ...]        # bytes per layer in this stage
    dp: int

    @property
    def total(self) -> int:
        return sum(self.layer_sizes)

    def owner_intervals(self, rank: int) -> List[Interval]:
        """Intervals of the stage state space owned by `rank`."""
        if self.kind == "contiguous":
            per = self.total // self.dp
            start = rank * per
            end = self.total if rank == self.dp - 1 else start + per
            return [(start, end)]
        out: List[Interval] = []
        off = 0
        for sz in self.layer_sizes:
            per = sz // self.dp
            s = off + rank * per
            e = off + sz if rank == self.dp - 1 else s + per
            out.append((s, e))
            off += sz
        return out

    def layer_interval(self, layer_pos: int) -> Interval:
        off = sum(self.layer_sizes[:layer_pos])
        return (off, off + self.layer_sizes[layer_pos])


def _overlap(a: Interval, b: Interval) -> int:
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


@dataclasses.dataclass(frozen=True)
class Transfer:
    src_rank: int
    dst_rank: int
    nbytes: int
    intra_stage: bool     # True: resharding within a stage's DP group
    src_stage: int = 0
    dst_stage: int = 0


def migration_plan(kind: str, layer_sizes: Sequence[int], layer_pos: int,
                   dp: int, src_stage: int, dst_stage: int,
                   dst_layer_sizes: Sequence[int]) -> List[Transfer]:
    """Plan for migrating layer `layer_pos`'s optimizer state from src_stage
    (layout over `layer_sizes`) to dst_stage (receiving it appended)."""
    sizes = tuple(layer_sizes)
    size_i = sizes[layer_pos]
    transfers: List[Transfer] = []

    if kind == "interleaved":
        # D disjoint rank-to-rank sends: rank j -> rank j.
        per = size_i // dp
        for j in range(dp):
            n = size_i - per * (dp - 1) if j == dp - 1 else per
            transfers.append(Transfer(j, j, n, intra_stage=False,
                                      src_stage=src_stage, dst_stage=dst_stage))
        return transfers

    assert kind == "contiguous"
    old = Layout("contiguous", sizes, dp)
    new_sizes = tuple(s for i, s in enumerate(sizes) if i != layer_pos)
    new = Layout("contiguous", new_sizes, dp)
    li = old.layer_interval(layer_pos)

    # map old offsets -> new offsets (remove the layer's interval)
    def to_new(off: int) -> int:
        return off if off <= li[0] else off - (li[1] - li[0])

    # 1) cross-stage: the migrating layer's bytes leave, from whoever owns them
    for j in range(dp):
        for iv in old.owner_intervals(j):
            n = _overlap(iv, li)
            if n:
                transfers.append(Transfer(j, j, n, intra_stage=False,
                                          src_stage=src_stage, dst_stage=dst_stage))
    # 2) intra-stage resharding: remaining bytes move to restore contiguity
    for j_old in range(dp):
        for iv in old.owner_intervals(j_old):
            # subtract the migrated interval, remap to new space
            pieces = []
            if iv[0] < li[0]:
                pieces.append((iv[0], min(iv[1], li[0])))
            if iv[1] > li[1]:
                pieces.append((max(iv[0], li[1]), iv[1]))
            for (s, e) in pieces:
                ns, ne = to_new(s), to_new(e)
                for j_new in range(dp):
                    for tv in new.owner_intervals(j_new):
                        n = _overlap((ns, ne), tv)
                        if n and j_new != j_old:
                            transfers.append(Transfer(
                                j_old, j_new, n, intra_stage=True,
                                src_stage=src_stage, dst_stage=src_stage))
    return transfers


def plan_bytes(transfers: Sequence[Transfer]) -> Dict[str, int]:
    cross = sum(t.nbytes for t in transfers if not t.intra_stage)
    intra = sum(t.nbytes for t in transfers if t.intra_stage)
    return {"cross_stage": cross, "intra_stage": intra, "total": cross + intra}


def theoretical_bytes(kind: str, size_i: int, dp: int) -> float:
    """Paper §6.3 closed forms: contiguous ~ (D+1)/2 |O_i|; interleaved |O_i|."""
    if kind == "interleaved":
        return float(size_i)
    return (dp + 1) / 2 * size_i
