"""Rank-vectorized ClusterView: the analytic plane's single currency.

A copy of ``repro.core.clusterview`` (the JAX package), numpy only.

The paper's premise is elasticity at 10^5–10^6 accelerators.  The seed
analytic path walked Python dicts and per-rank loops, which caps
``AnalyticScenarioRunner`` far below paper scale.  This module makes the
cluster state a first-class *array-of-ranks* object, mirroring the
``IntervalTable`` memoization idiom from the flat-state backbone
(``core.statespace``): precompute coordinate tables once, express every
state change and every reduction as a numpy array op.

* :class:`ClusterView` — one flat rank-major buffer per observable
  (``rank_alive``/``rank_freq``/``rank_slow``/``rank_domain``), with the
  classic ``[dp, pp]`` 2-D arrays exposed as **zero-copy reshape views** of
  the same buffers, so existing per-cell code (``view.alive[d, p] = False``)
  and vectorized code (``view.rank_alive[ranks] = False``) mutate identical
  state.  Stage/replica reductions (``stage_width``, ``stage_slow``, ...)
  are single masked-array reductions instead of Python ``for d in range(dp)``
  loops.  This is the single input/output type of the analytic stack:
  policies consume it, planners consume it, the scenario runner mutates it.
* :class:`FailureDomainMap` — correlated rack/pod failure domains: a block
  of ``domain_size`` consecutive ranks shares a domain id, so at-scale
  scenarios sample *whole domains*, not i.i.d. ranks.
* :class:`GroupDelta` — the declarative membership delta consumed by
  ``DynamicCommunicator.apply(delta, policy)``.

Rank convention (shared with ``scenarios.spec`` and the runner):
``rank = d * pp + p`` — DP-major, one rank per (replica, stage) worker cell
(a worker is a TP group; TP only materializes in the communicator's group
table).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=128)
def rank_coords(dp: int, pp: int) -> Tuple[np.ndarray, np.ndarray]:
    """Memoized coordinate tables for the DP-major rank layout:
    ``rank_dp[r], rank_stage[r]`` with ``r = d * pp + p``."""
    r = np.arange(dp * pp, dtype=np.int64)
    out = (r // pp, r % pp)
    for a in out:
        a.setflags(write=False)
    return out


@dataclasses.dataclass(frozen=True)
class GroupDelta:
    """A communicator membership delta: ranks leaving every group they are
    in, plus explicit ``(group, rank)`` additions.  The single argument of
    ``DynamicCommunicator.apply``/``price``."""
    remove: Tuple[int, ...] = ()
    add: Tuple[Tuple[str, int], ...] = ()

    @staticmethod
    def shrink(ranks: Sequence[int]) -> "GroupDelta":
        return GroupDelta(remove=tuple(int(r) for r in ranks))

    @staticmethod
    def grow(adds: Sequence[Tuple[str, int]]) -> "GroupDelta":
        return GroupDelta(add=tuple((g, int(r)) for g, r in adds))


@dataclasses.dataclass(frozen=True)
class FailureDomainMap:
    """Correlated failure domains: ``domain_size`` consecutive ranks (a rack
    or pod) share one domain id; sampling failures per *domain* produces the
    correlated bursts that only exist at paper scale."""
    n_ranks: int
    domain_size: int

    def __post_init__(self):
        assert self.n_ranks >= 1 and self.domain_size >= 1

    @property
    def n_domains(self) -> int:
        return -(-self.n_ranks // self.domain_size)

    def domain_of(self, ranks) -> np.ndarray:
        return np.asarray(ranks, dtype=np.int64) // self.domain_size

    def ranks_of(self, domains) -> np.ndarray:
        """All ranks of the given domain ids (sorted, deduplicated,
        clipped to the cluster size) — one broadcasted arange, no loops."""
        d = np.unique(np.asarray(domains, dtype=np.int64))
        r = (d[:, None] * self.domain_size
             + np.arange(self.domain_size, dtype=np.int64)[None, :]).ravel()
        return r[r < self.n_ranks]

    def sample(self, n_domains: int, seed: int = 0) -> np.ndarray:
        """Deterministically sample ``n_domains`` distinct domain ids."""
        rng = np.random.default_rng(seed)
        n = min(n_domains, self.n_domains)
        return np.sort(rng.choice(self.n_domains, size=n, replace=False))


class ClusterView:
    """What the Agent reports to the Core, as arrays of ranks.

    Drop-in constructor-compatible with the legacy dataclass (2-D
    ``[dp, pp]`` ``alive``/``freq``/``slow`` arguments are accepted and
    raveled); ``view.alive`` etc. remain ``[dp, pp]`` arrays — now zero-copy
    views of the flat rank-major buffers ``view.rank_alive`` etc.
    """

    __slots__ = ("dp", "pp", "global_batch", "num_micro", "seq",
                 "layer_assignment", "mem_cap", "rank_alive", "rank_freq",
                 "rank_slow", "rank_domain", "alive", "freq", "slow",
                 "domains")

    def __init__(self, dp: int, pp: int, global_batch: int, num_micro: int,
                 seq: int, layer_assignment: Sequence[Tuple[int, int]],
                 alive: Optional[np.ndarray] = None,
                 freq: Optional[np.ndarray] = None,
                 slow: Optional[np.ndarray] = None,
                 mem_cap: float = float("inf"),
                 domain: Optional[np.ndarray] = None,
                 domains: Optional[FailureDomainMap] = None):
        self.dp, self.pp = int(dp), int(pp)
        self.global_batch = int(global_batch)
        self.num_micro = int(num_micro)
        self.seq = int(seq)
        self.layer_assignment = list(layer_assignment)
        self.mem_cap = mem_cap
        n = self.dp * self.pp
        self.rank_alive = self._buf(alive, n, np.bool_, True)
        self.rank_freq = self._buf(freq, n, np.float64, 1.0)
        self.rank_slow = self._buf(slow, n, np.float64, 1.0)
        self.domains = domains
        if domain is None and domains is not None:
            domain = domains.domain_of(np.arange(n))
        self.rank_domain = self._buf(domain, n, np.int64, -1)
        # zero-copy 2-D aliases of the flat buffers
        self.alive = self.rank_alive.reshape(self.dp, self.pp)
        self.freq = self.rank_freq.reshape(self.dp, self.pp)
        self.slow = self.rank_slow.reshape(self.dp, self.pp)

    @staticmethod
    def _buf(arr, n: int, dtype, fill) -> np.ndarray:
        if arr is None:
            return np.full(n, fill, dtype=dtype)
        # aliases the caller's buffer when it is already contiguous with the
        # right dtype (same semantics as the legacy dataclass, which stored
        # the caller's [dp, pp] arrays directly)
        return np.ascontiguousarray(arr, dtype=dtype).reshape(n)

    # -- identity -----------------------------------------------------------
    @property
    def n_ranks(self) -> int:
        return self.dp * self.pp

    def rank_of(self, d, p) -> np.ndarray:
        return np.asarray(d, dtype=np.int64) * self.pp + np.asarray(p)

    @property
    def rank_dp(self) -> np.ndarray:
        return rank_coords(self.dp, self.pp)[0]

    @property
    def rank_stage(self) -> np.ndarray:
        return rank_coords(self.dp, self.pp)[1]

    def copy(self) -> "ClusterView":
        return ClusterView(self.dp, self.pp, self.global_batch,
                           self.num_micro, self.seq,
                           list(self.layer_assignment),
                           alive=self.rank_alive.copy(),
                           freq=self.rank_freq.copy(),
                           slow=self.rank_slow.copy(),
                           mem_cap=self.mem_cap,
                           domain=self.rank_domain.copy(),
                           domains=self.domains)

    # -- vectorized reductions (replace per-rank Python loops) --------------
    def stage_width(self) -> np.ndarray:
        """Surviving DP width per stage: ``[pp]`` int64."""
        return self.alive.sum(axis=0, dtype=np.int64)

    def replica_width(self) -> np.ndarray:
        """Surviving stage count per DP replica: ``[dp]`` int64."""
        return self.alive.sum(axis=1, dtype=np.int64)

    def stage_slow(self) -> np.ndarray:
        """Worst straggler factor among alive ranks per stage (1.0 where the
        stage has no survivors)."""
        return np.where(self.alive, self.slow, 1.0).max(axis=0, initial=1.0)

    def stage_freq(self) -> np.ndarray:
        """Best frequency among alive ranks per stage (1.0 fallback)."""
        best = np.where(self.alive, self.freq, 0.0).max(axis=0, initial=0.0)
        return np.where(self.alive.any(axis=0), best, 1.0)

    def alive_count(self) -> int:
        return int(self.rank_alive.sum())

    def dead_ranks(self) -> np.ndarray:
        return np.flatnonzero(~self.rank_alive)

    # -- vectorized event application (whole bursts as one array op) --------
    def apply_elastic(self, ev) -> np.ndarray:
        """Mutate the view for one (possibly multi-rank burst) event; returns
        the affected rank array.  Replaces the runner's per-rank dict
        surgery."""
        from .events import EventKind          # local: avoid import cycle
        ranks = np.asarray(ev.ranks, dtype=np.int64)
        if ev.kind == EventKind.FAIL_SLOW:
            self.rank_slow[ranks] = np.maximum(self.rank_slow[ranks],
                                               ev.slow_factor)
        elif ev.kind == EventKind.DVFS_SET:
            self.rank_freq[ranks] = ev.freq
        elif ev.is_grow:
            self.rank_alive[ranks] = True
        elif ev.is_shrink:
            self.rank_alive[ranks] = False
        return ranks

    def describe(self) -> Dict:
        return {"dp": self.dp, "pp": self.pp, "n_ranks": self.n_ranks,
                "alive": int(self.rank_alive.sum()),
                "global_batch": self.global_batch,
                "num_micro": self.num_micro, "seq": self.seq,
                "n_domains": (self.domains.n_domains
                              if self.domains else None)}
