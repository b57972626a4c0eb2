"""Dynamic Communicator (paper §6.1): in-place communication-group edits.

A copy of ``repro.core.communicator`` (the JAX package), numpy only; its
``OpStats`` seconds are the reference's modeled costs, not measured times.

The communicator tracks the *link graph* (established point-to-point
connections, NCCL/HCCL-ring style: a group of n ranks maintains n ring links)
and the group table.  Three recovery policies, matching the paper's Fig. 12b,
unified behind one entrypoint — ``apply(GroupDelta, policy) -> OpStats``:

* ``full_rebuild``   — tear down everything, global barrier, re-init every
                       group (what restart-based systems pay).
* ``partial_rebuild``— re-init only groups containing an affected rank.
* ``edit``           — ElasWave: keep every intact link; for each affected
                       group, drop the failed rank's links and create only the
                       single reconnecting link between its ring neighbors
                       (scale-down), or only the new member's links (scale-up).

``price(delta, policy)`` computes the same ``OpStats`` *without* committing,
so rebuild alternatives are priced against identical pre-event state.  The
seed's per-mode methods (``edit``/``partial_rebuild``/``full_rebuild``)
remain as thin deprecated shims over ``apply``, and ``clone`` gives an
independent copy.

Internally the link graph is rank-vectorized so a 10^5-rank table prices a
correlated burst in milliseconds:

* links are canonical **int64 codes** (``min << 32 | max``) instead of
  ``frozenset`` pairs; the established-link set is a set of codes, per-group
  ring codes are numpy arrays;
* per-group ring codes are **memoized** (``_ring_cache``), invalidated only
  for groups a delta actually edits — the seed recomputed every group's links
  from scratch on every ``affected_groups``/accounting call;
* the group table keeps a lazily rebuilt **CSR index** (flat member array +
  offsets + rank-sorted permutation), so ``affected_groups`` over a burst is
  one ``np.isin`` instead of a scan of every group's membership.

Cost model (calibrated to the paper's measurements on 200Gbps RoCE):
  link setup ~ LINK_SETUP_S each (QP/transport handshake), plus per-rank
  bootstrap/barrier costs for rebuild modes.  Paper: full 12–16 s,
  partial 0.54–1.09 s, edit 0.15–0.37 s over 8–64 ranks; our constants land
  in those bands and, more importantly, reproduce the *scaling shape*:
  edit is O(degree) (flat), rebuilds grow with rank count.

The seed dict/set implementation survives as
``core.legacy_comm.LegacyDynamicCommunicator``, the equivalence oracle of
``core.invariants.MttrThroughputChecker``.

On a real deployment the "links" are NCCL communicators; editing means
re-making only the affected groups — the planning layer (which groups are
affected) is identical.
"""
from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

import numpy as np

from .clusterview import GroupDelta

Link = FrozenSet[int]

# calibrated constants (seconds)
LINK_SETUP_S = 0.012          # per point-to-point transport setup
BOOTSTRAP_PER_RANK_S = 0.18   # store/rendezvous + context init per rank (full)
PARTIAL_PER_RANK_S = 0.055    # re-init cost per rank in affected groups
EDIT_CONST_S = 0.10           # plan + group-table swap (in-place edit)

RECOVERY_POLICIES = ("edit", "partial_rebuild", "full_rebuild")

_CODE_SHIFT = np.int64(32)    # link {u, v} -> (min << 32) | max; ranks < 2^31


def ring_links(ranks: Sequence[int]) -> Set[Link]:
    n = len(ranks)
    if n < 2:
        return set()
    return {frozenset((ranks[i], ranks[(i + 1) % n])) for i in range(n)}


def _ring_codes(members: np.ndarray) -> np.ndarray:
    """Sorted unique int64 link codes of one ring group (vectorized
    ``ring_links``; a 2-ring's two directed edges collapse to one code)."""
    if members.shape[0] < 2:
        return np.empty(0, np.int64)
    u = members.astype(np.int64, copy=False)
    v = np.roll(u, -1)
    return np.unique((np.minimum(u, v) << _CODE_SHIFT) | np.maximum(u, v))


def _decode_codes(codes) -> Set[Link]:
    mask = np.int64((1 << 32) - 1)
    out = set()
    for c in codes:
        c = np.int64(c)
        out.add(frozenset((int(c >> _CODE_SHIFT), int(c & mask))))
    return out


def _table_codes(groups: Dict[str, List[int]]) -> Tuple[np.ndarray, int]:
    """(unique link codes, distinct rank count) over a whole group table —
    one vectorized pass over the flat membership, no per-group Python ring
    construction."""
    sizes = np.fromiter((len(v) for v in groups.values()), np.int64,
                        len(groups))
    total = int(sizes.sum())
    if total == 0:
        return np.empty(0, np.int64), 0
    members = np.fromiter(itertools.chain.from_iterable(groups.values()),
                          np.int64, total)
    offsets = np.concatenate([np.zeros(1, np.int64), np.cumsum(sizes)])
    nxt = np.arange(1, total + 1, dtype=np.int64)
    nz = sizes > 0
    nxt[offsets[1:][nz] - 1] = offsets[:-1][nz]      # ring wrap per group
    u, v = members, members[nxt]
    valid = np.repeat(sizes >= 2, sizes)
    lo = np.minimum(u, v)[valid]
    hi = np.maximum(u, v)[valid]
    return np.unique((lo << _CODE_SHIFT) | hi), int(np.unique(members).size)


@dataclasses.dataclass
class OpStats:
    mode: str
    links_created: int
    links_reused: int
    links_destroyed: int
    ranks_touched: int
    seconds: float


class DynamicCommunicator:
    def __init__(self, groups: Dict[str, List[int]]):
        self.groups: Dict[str, List[int]] = {k: list(v) for k, v in groups.items()}
        self.history: List[OpStats] = []
        self._ring_cache: Dict[str, np.ndarray] = {}
        self._version = 0          # bumped on any membership change
        self._csr = None           # (version, names, members, sizes, sorted_members, sorted_gid)
        codes, _ = _table_codes(self.groups)
        self._link_codes: Set[int] = set(codes.tolist())

    # ---- vectorized state ------------------------------------------------
    @property
    def links(self) -> Set[Link]:
        """The established link set, materialized as the seed's
        frozenset-pair representation (tests / debugging; O(|links|))."""
        return _decode_codes(self._link_codes)

    def _codes(self, name: str) -> np.ndarray:
        """Memoized ring-link codes of one group; invalidated on group edit."""
        c = self._ring_cache.get(name)
        if c is None:
            c = _ring_codes(np.asarray(self.groups[name], dtype=np.int64))
            self._ring_cache[name] = c
        return c

    def _table(self):
        """Lazily rebuilt CSR group index: flat members + per-member group id,
        rank-sorted for O(log) membership lookups."""
        if self._csr is None or self._csr[0] != self._version:
            names = list(self.groups)
            sizes = np.fromiter((len(self.groups[n]) for n in names),
                                np.int64, len(names))
            members = np.fromiter(
                itertools.chain.from_iterable(self.groups[n] for n in names),
                np.int64, int(sizes.sum()))
            gid = np.repeat(np.arange(len(names), dtype=np.int64), sizes)
            order = np.argsort(members, kind="stable")
            self._csr = (self._version, names, members, sizes,
                         members[order], gid[order])
        return self._csr

    # ---- helpers ----
    def clone(self) -> "DynamicCommunicator":
        """Independent copy with the same group table and established links.
        The scenario engine prices alternatives via :meth:`price`; clone
        remains for API compatibility."""
        c = DynamicCommunicator.__new__(DynamicCommunicator)
        c.groups = {k: list(v) for k, v in self.groups.items()}
        c.history = []
        c._ring_cache = dict(self._ring_cache)
        c._version = 0
        c._csr = None
        c._link_codes = set(self._link_codes)
        return c

    def _group_links(self) -> Set[Link]:
        out: Set[Link] = set()
        for name in self.groups:
            out |= _decode_codes(self._codes(name))
        return out

    def affected_groups(self, ranks: Sequence[int]) -> List[str]:
        """Groups containing any of ``ranks`` (table insertion order, like
        the seed) — one vectorized membership test over the CSR index."""
        rs = np.asarray(list(ranks), dtype=np.int64)
        if rs.size == 0:
            return []
        _, names, _, _, sorted_members, sorted_gid = self._table()
        hit = sorted_gid[np.isin(sorted_members, rs)]
        return [names[g] for g in np.unique(hit)]

    def all_ranks(self) -> Set[int]:
        _, _, members, _, _, _ = self._table()
        return set(np.unique(members).tolist())

    # ---- unified entrypoint ----------------------------------------------
    def apply(self, delta: GroupDelta, policy: str = "edit") -> OpStats:
        """Commit one membership delta under a recovery policy and return its
        priced ``OpStats``.  The single entrypoint replacing the per-mode
        methods."""
        st = self._execute(delta, policy, commit=True)
        self.history.append(st)
        return st

    def price(self, delta: GroupDelta, policy: str = "edit") -> OpStats:
        """Price a delta under a policy *without* mutating any state — the
        runner prices edit vs partial vs full from identical pre-event
        state."""
        return self._execute(delta, policy, commit=False)

    def _execute(self, delta: GroupDelta, policy: str, commit: bool) -> OpStats:
        if policy not in RECOVERY_POLICIES:
            raise ValueError(f"unknown recovery policy {policy!r}; "
                             f"expected one of {RECOVERY_POLICIES}")
        if policy == "full_rebuild":
            rem = set(delta.remove)
            new_groups = {k: [r for r in v if r not in rem]
                          for k, v in self.groups.items()}
            for g, r in delta.add:
                new_groups.setdefault(g, []).append(r)
            return self._full_rebuild(new_groups, commit)

        removed = set(delta.remove)
        adds_by_group: Dict[str, List[int]] = {}
        for g, r in delta.add:
            adds_by_group.setdefault(g, []).append(r)
        affected = set(self.affected_groups(delta.remove)) | set(adds_by_group)
        created = destroyed = reused = 0
        touched: Set[int] = set()
        links = self._link_codes if commit else set(self._link_codes)
        for name in sorted(affected):
            old_codes = self._codes(name)
            new_members = [r for r in self.groups[name] if r not in removed]
            new_members += adds_by_group.get(name, [])
            new_codes = _ring_codes(np.asarray(new_members, dtype=np.int64))
            if policy == "edit":
                in_links = np.fromiter((c in links for c in new_codes.tolist()),
                                       np.bool_, new_codes.size)
                newly = new_codes[~in_links]
                dead = np.setdiff1d(old_codes, new_codes, assume_unique=True)
                created += int(newly.size)
                reused += int(in_links.sum())
                destroyed += int(dead.size)
                links.difference_update(dead.tolist())
                links.update(newly.tolist())
            else:        # partial_rebuild: tear down + re-create ALL links
                created += int(new_codes.size)
                destroyed += int(old_codes.size)
                links.difference_update(old_codes.tolist())
                links.update(new_codes.tolist())
            touched.update(new_members)
            if commit:
                self.groups[name] = new_members
                self._ring_cache[name] = new_codes
                self._version += 1
        if policy == "edit":
            secs = EDIT_CONST_S + LINK_SETUP_S * created
            return OpStats("edit", created, reused, destroyed, len(touched), secs)
        secs = PARTIAL_PER_RANK_S * len(touched) + LINK_SETUP_S * created
        return OpStats("partial_rebuild", created, 0, destroyed, len(touched),
                       secs)

    def _full_rebuild(self, new_groups: Dict[str, List[int]],
                      commit: bool) -> OpStats:
        new_codes, n_ranks = _table_codes(new_groups)
        old_links = len(self._link_codes)
        secs = BOOTSTRAP_PER_RANK_S * n_ranks + LINK_SETUP_S * new_codes.size
        if commit:
            self.groups = {k: list(v) for k, v in new_groups.items()}
            self._ring_cache = {}
            self._version += 1
            self._link_codes = set(new_codes.tolist())
        return OpStats("full_rebuild", int(new_codes.size), 0, old_links,
                       n_ranks, secs)

    # ---- deprecated per-mode shims ---------------------------------------
    def edit(self, remove: Sequence[int] = (),
             add: Sequence[Tuple[str, int]] = ()) -> OpStats:
        """Deprecated: use ``apply(GroupDelta(remove, add), "edit")``."""
        warnings.warn("DynamicCommunicator.edit is deprecated; use "
                      "apply(GroupDelta(...), 'edit')", DeprecationWarning,
                      stacklevel=2)
        return self.apply(GroupDelta(tuple(remove), tuple(add)), "edit")

    def partial_rebuild(self, remove: Sequence[int] = (),
                        add: Sequence[Tuple[str, int]] = ()) -> OpStats:
        """Deprecated: use ``apply(GroupDelta(remove, add),
        "partial_rebuild")``."""
        warnings.warn("DynamicCommunicator.partial_rebuild is deprecated; "
                      "use apply(GroupDelta(...), 'partial_rebuild')",
                      DeprecationWarning, stacklevel=2)
        return self.apply(GroupDelta(tuple(remove), tuple(add)),
                          "partial_rebuild")

    def full_rebuild(self, new_groups: Dict[str, List[int]]) -> OpStats:
        """Deprecated: use ``apply(delta, "full_rebuild")`` (the new-group
        table is derived from the delta); this shim keeps the seed's explicit
        new-table signature."""
        warnings.warn("DynamicCommunicator.full_rebuild is deprecated; use "
                      "apply(GroupDelta(...), 'full_rebuild')",
                      DeprecationWarning, stacklevel=2)
        st = self._full_rebuild({k: list(v) for k, v in new_groups.items()},
                                commit=True)
        self.history.append(st)
        return st


def build_hybrid_groups(dp: int, pp: int, tp: int = 1) -> Dict[str, List[int]]:
    """Rank layout: rank = ((d * pp) + p) * tp + t (DP-major, then PP, TP)."""
    groups: Dict[str, List[int]] = {}

    def rank(d, p, t=0):
        return (d * pp + p) * tp + t

    for p in range(pp):
        for t in range(tp):
            groups[f"dp_stage{p}_tp{t}"] = [rank(d, p, t) for d in range(dp)]
    for d in range(dp):
        for t in range(tp):
            groups[f"pp_rep{d}_tp{t}"] = [rank(d, p, t) for p in range(pp)]
    if tp > 1:
        for d in range(dp):
            for p in range(pp):
                groups[f"tp_rep{d}_stage{p}"] = [rank(d, p, t) for t in range(tp)]
    return groups
