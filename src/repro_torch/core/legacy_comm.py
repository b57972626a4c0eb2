"""Seed dict/set DynamicCommunicator, preserved as the equivalence oracle.

A copy of ``repro.core.legacy_comm`` (the JAX package), plain Python.

``core.communicator.DynamicCommunicator`` is now rank-vectorized (int64
link-code arrays + memoized group index tables).  This module keeps the seed
implementation — Python dicts of member lists, a ``set`` of ``frozenset``
links — so that ``core.invariants.MttrThroughputChecker`` and the tests can hold
the vectorized ``apply(delta, policy)`` to byte-identical ``OpStats``,
group tables, link sets, ``affected_groups`` ordering and MTTR accounting.

One intentional delta from the seed: affected groups are processed in
``sorted(...)`` name order instead of Python ``set`` iteration order, in both
implementations, so the per-group accumulation order is well defined.  For
ring groups that share at most one rank (every hybrid dp/pp/tp layout) the
order never changes any count; making it deterministic lets the oracle
compare accumulators exactly.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

from .clusterview import GroupDelta
from .communicator import (BOOTSTRAP_PER_RANK_S, EDIT_CONST_S, LINK_SETUP_S,
                           PARTIAL_PER_RANK_S, Link, OpStats, ring_links)


class LegacyDynamicCommunicator:
    """The seed implementation, verbatim modulo sorted affected-group order,
    with the new ``apply``/``price`` entrypoints layered on top."""

    def __init__(self, groups: Dict[str, List[int]]):
        self.groups: Dict[str, List[int]] = {k: list(v) for k, v in groups.items()}
        self.links: Set[Link] = set()
        for g in self.groups.values():
            self.links |= ring_links(g)
        self.history: List[OpStats] = []

    # ---- helpers ----
    def clone(self) -> "LegacyDynamicCommunicator":
        c = LegacyDynamicCommunicator(self.groups)
        c.links = set(self.links)
        return c

    def _group_links(self) -> Set[Link]:
        s: Set[Link] = set()
        for g in self.groups.values():
            s |= ring_links(g)
        return s

    def affected_groups(self, ranks: Sequence[int]) -> List[str]:
        rs = set(ranks)
        return [k for k, g in self.groups.items() if rs & set(g)]

    def all_ranks(self) -> Set[int]:
        out: Set[int] = set()
        for g in self.groups.values():
            out |= set(g)
        return out

    # ---- unified entrypoints (delegating to the seed recovery modes) ----
    def apply(self, delta: GroupDelta, policy: str = "edit") -> OpStats:
        if policy == "edit":
            return self.edit(remove=delta.remove, add=delta.add)
        if policy == "partial_rebuild":
            return self.partial_rebuild(remove=delta.remove, add=delta.add)
        if policy == "full_rebuild":
            rem = set(delta.remove)
            new_groups = {k: [r for r in v if r not in rem]
                          for k, v in self.groups.items()}
            for g, r in delta.add:
                new_groups.setdefault(g, []).append(r)
            return self.full_rebuild(new_groups)
        raise ValueError(f"unknown recovery policy {policy!r}")

    def price(self, delta: GroupDelta, policy: str = "edit") -> OpStats:
        """Price without committing (the clone-based seed idiom)."""
        return self.clone().apply(delta, policy)

    # ---- recovery modes (seed implementations) ----
    def full_rebuild(self, new_groups: Dict[str, List[int]]) -> OpStats:
        old_links = set(self.links)
        self.groups = {k: list(v) for k, v in new_groups.items()}
        new_links = self._group_links()
        n_ranks = len(self.all_ranks())
        secs = (BOOTSTRAP_PER_RANK_S * n_ranks + LINK_SETUP_S * len(new_links))
        self.links = new_links
        st = OpStats("full_rebuild", len(new_links), 0, len(old_links), n_ranks, secs)
        self.history.append(st)
        return st

    def partial_rebuild(self, remove: Sequence[int] = (),
                        add: Sequence[Tuple[str, int]] = ()) -> OpStats:
        affected = set(self.affected_groups(remove)) | {g for g, _ in add}
        created = destroyed = 0
        touched: Set[int] = set()
        for name in sorted(affected):
            old = ring_links(self.groups[name])
            self.groups[name] = [r for r in self.groups[name] if r not in set(remove)]
            for g, r in add:
                if g == name:
                    self.groups[name].append(r)
            new = ring_links(self.groups[name])
            # partial rebuild: tears down & re-creates ALL links of the group
            destroyed += len(old)
            created += len(new)
            touched |= set(self.groups[name])
            self.links -= old
            self.links |= new
        secs = PARTIAL_PER_RANK_S * len(touched) + LINK_SETUP_S * created
        st = OpStats("partial_rebuild", created, 0, destroyed, len(touched), secs)
        self.history.append(st)
        return st

    def edit(self, remove: Sequence[int] = (),
             add: Sequence[Tuple[str, int]] = ()) -> OpStats:
        """ElasWave in-place edit: reuse intact links, create only missing."""
        affected = set(self.affected_groups(remove)) | {g for g, _ in add}
        created = destroyed = reused = 0
        touched: Set[int] = set()
        for name in sorted(affected):
            old = ring_links(self.groups[name])
            self.groups[name] = [r for r in self.groups[name] if r not in set(remove)]
            for g, r in add:
                if g == name:
                    self.groups[name].append(r)
            new = ring_links(self.groups[name])
            newly = new - self.links          # only links not yet established
            dead = old - new
            created += len(newly)
            reused += len(new & self.links)
            destroyed += len(dead)
            touched |= set(self.groups[name])
            self.links -= dead
            self.links |= newly
        secs = EDIT_CONST_S + LINK_SETUP_S * created
        st = OpStats("edit", created, reused, destroyed, len(touched), secs)
        self.history.append(st)
        return st
