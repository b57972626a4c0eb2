"""Per-step ring snapshot (paper §5.1, Fig. 6).

Worker i backs up the optimizer-state partition of worker (i+1) mod n into
its *host* memory.  Only **gradient shards** cross to the host (>= 4x
smaller than mixed-precision Adam state); the host replays the Adam update
with the numpy oracle, so after each step O_i^host == O_{(i+1)%n}^device
bit-for-bit (the device runs the fused-AdamW kernel, bitwise equal to the
oracle).  Live Remap relies on that for integrity.

Mirrors ``repro.core.fabric.snapshot.SnapshotPool``.  The host side stays
numpy (the paper's host-memory ring).  On the default batched path every
holder's state is one concatenated buffer per component, and one host Adam
update (and, under ``compress="bf16"``, one compression round trip) covers
the whole DP group.  ``batched=False`` keeps the seed's per-rank loop (one
host Adam update and one compression a holder), elementwise the same; the
seed path of the cluster (``core/legacy.py``) uses it.  CRC32 checksums of
the host copies are stamped at every write, and recovery re-hashes a shard
before trusting it (``verify_and_repair``, with the reference's
graceful-degradation tiers).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adam import AdamConfig, adam_update_flat_np

from ..statespace import COMPONENTS as _COMPONENTS

GRAD_BYTES = 4        # fp32 gradient shard element
ADAM_STATE_BYTES = 12  # master + mu + nu fp32
VERIFY_BW = 5e9        # modeled host checksum scan rate (bytes/s)

#: graceful-degradation ladder for :meth:`SnapshotPool.verify_and_repair`
INTEGRITY_TIERS = ("verified", "rederived", "rebuilt", "lost")


@dataclasses.dataclass
class SnapshotStats:
    step: int
    grad_bytes_sent: int
    state_bytes_equiv: int       # what shipping full Adam state would cost
    host_update_seconds: float   # modeled host-side work (overlapped)
    d2d_seconds: float           # modeled transfer (overlapped with Step/AG)


def _host(v) -> np.ndarray:
    """A float32 numpy copy of ``v`` (a tensor on any device, or an array)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy().copy()
    return np.array(v, dtype=np.float32)


class SnapshotPool:
    """In-memory snapshot pool across a DP group of n workers.

    compress="bf16" halves the gradient payload; the host replays the update
    with the *compressed* gradient, so the snapshot drifts from the device
    copy by bf16 rounding only."""

    def __init__(self, n: int, adam_cfg: Optional[AdamConfig] = None,
                 d2d_bw: float = 25e9, host_flops: float = 5e10,
                 compress: str = "none", batched: bool = True,
                 integrity: bool = True):
        self.n = n
        self.adam = adam_cfg or AdamConfig()
        self.d2d_bw = d2d_bw
        self.host_flops = host_flops
        assert compress in ("none", "bf16")
        self.compress = compress
        self.batched = batched
        self.integrity = integrity
        # host[i] = snapshot of worker (i+1) % n's shard state; on the
        # batched path, after the first step, zero-copy views into one
        # concatenated buffer per component (_cat)
        self.host: List[Optional[Dict[str, np.ndarray]]] = [None] * n
        self.snap_step: List[int] = [-1] * n
        self.stats: List[SnapshotStats] = []
        self._cat: Optional[Dict[str, np.ndarray]] = None
        self._offs: Optional[np.ndarray] = None
        # crc[i][c] = CRC32 of holder i's copy of component c, stamped at
        # write time (bootstrap / snapshot_step)
        self.crc: List[Optional[Dict[str, int]]] = [None] * n

    def backup_rank(self, i: int) -> int:
        """Which worker's state does worker i hold?"""
        return (i + 1) % self.n

    def holder_of(self, j: int) -> int:
        """Which worker holds worker j's snapshot?"""
        return (j - 1) % self.n

    def bootstrap(self, step: int, shard_states: List[Dict[str, object]]):
        """Initial full-state copy (once, before training).  Shard states may
        be device tensors; each is copied to host memory."""
        for i in range(self.n):
            j = self.backup_rank(i)
            self.host[i] = {k: _host(v) for k, v in shard_states[j].items()}
            self.snap_step[i] = step
        self._cat = None
        self._stamp_all()

    def _ensure_cat(self):
        """Build (lazily) the concatenated per-component buffers the batched
        update runs on; host[i] become views into them."""
        if self._cat is not None:
            return
        for st in self.host:
            assert st is not None, "bootstrap() first"
        sizes = [self.host[i]["master"].size for i in range(self.n)]
        self._offs = np.concatenate([np.zeros(1, np.int64),
                                     np.cumsum(sizes)]).astype(np.int64)
        self._cat = {c: (np.concatenate([self.host[i][c]
                                         for i in range(self.n)])
                         if self.n else np.zeros(0, np.float32))
                     for c in _COMPONENTS}
        self._refresh_views()

    def _refresh_views(self):
        for i in range(self.n):
            s, e = int(self._offs[i]), int(self._offs[i + 1])
            self.host[i] = {c: self._cat[c][s:e] for c in _COMPONENTS}

    def snapshot_step(self, step: int, grad_shards: List[np.ndarray],
                      opt_step: int) -> SnapshotStats:
        """Per-step update: worker (i+1)%n sends its *gradient shard* to
        worker i, whose host CPU applies the Adam update to O^host.

        grad_shards[j]: fp32 host gradient of worker j's owned shard (1-D).
        """
        if not self.batched:
            return self._snapshot_step_loop(step, grad_shards, opt_step)
        self._ensure_cat()
        gs = [np.asarray(grad_shards[self.backup_rank(i)], dtype=np.float32)
              for i in range(self.n)]
        gcat = np.concatenate(gs) if gs else np.zeros(0, np.float32)
        if self.compress == "bf16":
            gcat = torch.from_numpy(gcat).to(torch.bfloat16).float().numpy()
            total_grad_bytes = gcat.size * 2        # bf16 on the wire
        else:
            total_grad_bytes = int(gcat.nbytes)
        self._cat = adam_update_flat_np(gcat, self._cat, opt_step, self.adam)
        self._refresh_views()
        for i in range(self.n):
            self.snap_step[i] = step
        self._stamp_all()
        stats = SnapshotStats(
            step=step,
            grad_bytes_sent=total_grad_bytes,
            state_bytes_equiv=total_grad_bytes // GRAD_BYTES * ADAM_STATE_BYTES,
            host_update_seconds=gcat.size * 12 / self.host_flops,
            d2d_seconds=total_grad_bytes / self.d2d_bw,
        )
        self.stats.append(stats)
        return stats

    def _snapshot_step_loop(self, step: int, grad_shards: List[np.ndarray],
                            opt_step: int) -> SnapshotStats:
        """Seed per-rank loop: one compression and one host Adam update a
        holder (``adam_update_flat_np``, bitwise the reference's eager
        ``adam_update_flat``)."""
        total_grad_bytes = 0
        host_flops = 0
        for i in range(self.n):
            g = np.asarray(grad_shards[self.backup_rank(i)], dtype=np.float32)
            if self.compress == "bf16":
                g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
                total_grad_bytes += g.size * 2        # bf16 on the wire
            else:
                total_grad_bytes += g.nbytes
            st = self.host[i]
            assert st is not None, "bootstrap() first"
            self.host[i] = adam_update_flat_np(g, st, opt_step, self.adam)
            host_flops += g.size * 12     # ~12 flops/element Adam
            self.snap_step[i] = step
        self._stamp_all()
        stats = SnapshotStats(
            step=step,
            grad_bytes_sent=total_grad_bytes,
            state_bytes_equiv=total_grad_bytes // GRAD_BYTES * ADAM_STATE_BYTES,
            host_update_seconds=host_flops / self.host_flops,
            d2d_seconds=total_grad_bytes / self.d2d_bw,
        )
        self.stats.append(stats)
        return stats

    @staticmethod
    def _checksum(state: Dict[str, np.ndarray]) -> Dict[str, int]:
        # hashes the host buffer in place (no bytes copy of multi-GB shards)
        return {c: zlib.crc32(memoryview(np.ascontiguousarray(v)).cast("B"))
                for c, v in state.items()}

    def _stamp_all(self):
        """Refresh write-time checksums for every live holder slot."""
        if not self.integrity:
            return
        for i in range(self.n):
            self.crc[i] = (self._checksum(self.host[i])
                           if self.host[i] is not None else None)

    def lose_rank(self, i: int):
        """Simulate fail-stop of worker i: its host snapshots die with it."""
        self.host[i] = None
        self.snap_step[i] = -1
        self.crc[i] = None
        self._cat = None    # survivors' views stay valid standalone arrays

    def recover_shard(self, j: int) -> Optional[Dict[str, np.ndarray]]:
        """Fetch failed worker j's state from its ring holder, if alive."""
        return self.host[self.holder_of(j)]

    # -- integrity (paper §5.1 "online verification") ----------------------

    def corrupt_shard(self, j: int, component: str = "master",
                      index: int = 0):
        """Chaos/test hook: silently flip a mantissa bit in the *stored* copy
        of worker j's snapshot (holder-side bit rot).  The write-time
        checksum is deliberately NOT refreshed, so verification must catch
        it."""
        st = self.host[self.holder_of(j)]
        if st is None or st[component].size == 0:
            return
        arr = st[component]
        i = index % arr.size
        raw = arr[i:i + 1].view(np.uint32)
        raw ^= np.uint32(0x00400000)   # writes through the _cat view

    def verify_shard(self, j: int) -> bool:
        """Re-hash worker j's stored snapshot against its write-time
        checksum.  True = intact.  Raises if the shard is absent."""
        h = self.holder_of(j)
        st = self.host[h]
        assert st is not None, f"no snapshot for rank {j} (holder {h} dead)"
        if not self.integrity or self.crc[h] is None:
            return True
        return self._checksum(st) == self.crc[h]

    def verify_cost_seconds(self, j: int) -> float:
        """Modeled wall time of the verification scan (deterministic)."""
        st = self.host[self.holder_of(j)]
        if st is None:
            return 0.0
        return sum(v.nbytes for v in st.values()) / VERIFY_BW

    def verify_and_repair(
        self, j: int,
        device_state: Optional[Dict[str, object]] = None,
        master_fallback: Optional[Callable[[], object]] = None,
    ) -> Tuple[str, Optional[Dict[str, np.ndarray]]]:
        """Online verification with graceful degradation (INTEGRITY_TIERS).

        Returns ``(tier, state)``:

        * ``verified``  — checksum matches; the stored shard is trusted.
        * ``rederived`` — checksum failed but worker j is still alive
          (``device_state`` given, e.g. a proactive drain): the snapshot is
          re-copied bit-for-bit from the device (tensors cross to the host
          here) and re-stamped.
        * ``rebuilt``   — checksum failed and the device copy is gone: the
          fp32 master is regenerated from ``master_fallback()`` (the
          replicated model parameters) with **zeroed** Adam moments.
        * ``lost``      — no repair source.

        Repairs write standalone host arrays into the holder slot (detaching
        it from the batched ``_cat`` buffer) and refresh the checksum.
        """
        h = self.holder_of(j)
        st = self.host[h]
        if st is None:
            return "lost", None
        if self.verify_shard(j):
            return "verified", st
        if device_state is not None:
            self._install_repair(h, {c: _host(v)
                                     for c, v in device_state.items()})
            return "rederived", self.host[h]
        if master_fallback is not None:
            master = _host(master_fallback()).ravel()
            self._install_repair(h, {"master": master,
                                     "mu": np.zeros_like(master),
                                     "nu": np.zeros_like(master)})
            return "rebuilt", self.host[h]
        return "lost", None

    def _install_repair(self, holder: int, state: Dict[str, np.ndarray]):
        # detach every slot from the shared _cat before replacing one slot's
        # arrays, as lose_rank() does: views of survivors stay valid
        self._cat = None
        self.host[holder] = state
        if self.integrity:
            self.crc[holder] = self._checksum(state)

    def critical_path_overhead(self) -> float:
        """Fraction of snapshot work NOT hidden (Fig. 6b: ~0; small launch
        overhead remains): the reference's modeled constant, not a
        measurement of this port (whose snapshot runs inline)."""
        return 0.004
