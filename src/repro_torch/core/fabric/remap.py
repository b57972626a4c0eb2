"""Live Remap (paper §5.2, Fig. 7): four-step optimizer-state redistribution.

1. **Integrity check** — failed workers' state must be recoverable from the
   union of surviving on-device partitions (O^device) and host snapshots
   (O^host).
2. **Transfer plan** — consolidated source partitions intersected with the
   target partitions give the overlap matrix M_overlap: exact (src, dst,
   interval, channel) tuples.  Diagonal entries (src==dst, on-device) move
   nothing.
3. **Optimized redistribution** — D2D for device-resident bytes, H2D(+D2D)
   for snapshot-resident bytes; disjoint pairs proceed in parallel, so the
   modeled time is the max per-endpoint byte load over bandwidth.
4. **Finalization** — destination shards reassembled; coverage re-verified.

The state space is the stage's flat optimizer vector (see core/zero.Layout).
A copy of ``repro.core.fabric.remap`` (the JAX package): the plan is the
same interval algebra, and :meth:`LiveRemap.execute` moves torch tensors —
device segments are slices of the stage's buffers, host (snapshot)
segments are copied to the target device explicitly, and each destination
shard is assembled there; coverage and overlap checks are unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Interval = Tuple[int, int]


class IntegrityError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Move:
    src: int                  # source worker (holder)
    dst: int                  # destination worker
    interval: Interval        # [start, end) in stage state space
    channel: str              # "local" | "d2d" | "h2d"

    @property
    def nbytes(self) -> int:
        return self.interval[1] - self.interval[0]


@dataclasses.dataclass
class RemapPlan:
    moves: List[Move]
    total_bytes: int
    d2d_bytes: int
    h2d_bytes: int
    est_seconds: float

    def overlap_matrix(self, n: int) -> np.ndarray:
        m = np.zeros((n, n), dtype=np.int64)
        for mv in self.moves:
            m[mv.src, mv.dst] += mv.nbytes
        return m


def _intersect(a: Interval, b: Interval) -> Optional[Interval]:
    s, e = max(a[0], b[0]), min(a[1], b[1])
    return (s, e) if s < e else None


def _coverage(ivs: Sequence[Interval]) -> int:
    return sum(e - s for s, e in ivs)


class LiveRemap:
    def __init__(self, d2d_bw: float = 25e9, h2d_bw: float = 12e9):
        self.d2d_bw = d2d_bw
        self.h2d_bw = h2d_bw

    def integrity_check(self, total: int,
                        device_parts: Dict[int, List[Interval]],
                        host_parts: Dict[int, List[Interval]]) -> None:
        """Union of available intervals must cover [0, total)."""
        ivs = sorted(iv for parts in (device_parts, host_parts)
                     for lst in parts.values() for iv in lst)
        cur = 0
        for s, e in ivs:
            if s > cur:
                raise IntegrityError(f"gap [{cur},{s}) unrecoverable")
            cur = max(cur, e)
        if cur < total:
            raise IntegrityError(f"gap [{cur},{total}) unrecoverable")

    def compute_plan(self, total: int,
                     device_parts: Dict[int, List[Interval]],
                     host_parts: Dict[int, List[Interval]],
                     target_parts: Dict[int, List[Interval]]) -> RemapPlan:
        """Step 2: overlap matrix.  Preference order per target byte:
        already-local device bytes > remote device (D2D) > host snapshot
        (H2D+D2D)."""
        self.integrity_check(total, device_parts, host_parts)
        moves: List[Move] = []
        for dst, tlist in target_parts.items():
            for tiv in tlist:
                remaining = [tiv]
                for source, channel_order in ((device_parts, "d2d"),
                                              (host_parts, "h2d")):
                    nxt: List[Interval] = []
                    for iv in remaining:
                        pieces = [iv]
                        for src, slist in source.items():
                            new_pieces: List[Interval] = []
                            for piece in pieces:
                                hit = None
                                for siv in slist:
                                    hit = _intersect(piece, siv)
                                    if hit:
                                        ch = ("local" if (channel_order == "d2d"
                                                          and src == dst) else channel_order)
                                        moves.append(Move(src, dst, hit, ch))
                                        if piece[0] < hit[0]:
                                            new_pieces.append((piece[0], hit[0]))
                                        if hit[1] < piece[1]:
                                            new_pieces.append((hit[1], piece[1]))
                                        break
                                if hit is None:
                                    new_pieces.append(piece)
                            pieces = new_pieces
                            if not pieces:
                                break
                        nxt.extend(pieces)
                    remaining = nxt
                    if not remaining:
                        break
                if remaining:
                    raise IntegrityError(f"target {dst} interval {remaining} uncovered")
        d2d = sum(m.nbytes for m in moves if m.channel == "d2d")
        h2d = sum(m.nbytes for m in moves if m.channel == "h2d")
        # disjoint endpoint pairs run in parallel: time = max endpoint load
        load: Dict[Tuple[str, int], float] = {}
        for m in moves:
            if m.channel == "local":
                continue
            bw = self.d2d_bw if m.channel == "d2d" else self.h2d_bw
            load[("s", m.src)] = load.get(("s", m.src), 0.0) + m.nbytes / bw
            load[("d", m.dst)] = load.get(("d", m.dst), 0.0) + m.nbytes / bw
        est = max(load.values()) if load else 0.0
        return RemapPlan(moves, d2d + h2d, d2d, h2d, est)

    def execute(self, plan: RemapPlan, total: int,
                 device_data: Dict[int, Dict[Interval, torch.Tensor]],
                 host_data: Dict[int, Dict[Interval, object]],
                 device=None) -> Dict[int, torch.Tensor]:
        """Step 3+4: materialize each destination's new shard on ``device``.

        device_data[rank][interval] holds the fp32 state tensors for the
        intervals a surviving rank owns (views of its shard, on ``device``);
        host_data[rank][interval] the host copies (numpy arrays or CPU
        tensors) of a failed rank's intervals, from its ring holder.  Only
        the moved slice of a host segment crosses to the device.  ``device``
        defaults to that of the device segments.  Returns
        ``{dst_rank: assembled shard}`` and verifies exact coverage.
        """
        if device is None:
            device = next((t.device for segs in device_data.values()
                           for t in segs.values()), torch.device("cpu"))
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        out: Dict[int, Dict[Interval, torch.Tensor]] = {}
        for mv in plan.moves:
            store = device_data if mv.channel in ("local", "d2d") else host_data
            src_map = store[mv.src]
            # find the owning interval containing mv.interval: exact match
            # first (the common whole-interval move), linear scan otherwise
            arr = src_map.get(mv.interval)
            if arr is not None:
                iv = mv.interval
            else:
                seg = None
                for iv, arr in src_map.items():
                    if iv[0] <= mv.interval[0] and mv.interval[1] <= iv[1]:
                        seg = (iv, arr)
                        break
                assert seg is not None, (mv, list(src_map))
                iv, arr = seg
            lo = mv.interval[0] - iv[0]
            hi = mv.interval[1] - iv[0]
            piece = torch.as_tensor(arr[lo:hi])
            if mv.channel == "h2d":
                piece = piece.to(device, torch.float32)
            elif piece.device != device:
                raise IntegrityError(
                    f"device segment of rank {mv.src} on {piece.device}, "
                    f"remap target {device}")
            out.setdefault(mv.dst, {})[mv.interval] = piece
        # finalize: stitch intervals per destination in offset order.
        # (Interleaved layouts legitimately own disjoint intervals — verify
        # only that nothing overlaps, i.e. each byte written exactly once.)
        result: Dict[int, torch.Tensor] = {}
        for dst, segs in out.items():
            ivs = sorted(segs)
            for (s0, e0), (s1, e1) in zip(ivs, ivs[1:]):
                if e0 > s1:
                    raise IntegrityError(f"dst {dst}: overlap {ivs}")
            result[dst] = torch.cat([segs[iv] for iv in ivs]) if ivs else \
                torch.zeros(0, dtype=torch.float32, device=device)
        return result
