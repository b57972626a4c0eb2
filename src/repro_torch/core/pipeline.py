"""1F1B pipeline discrete-event simulator.

Given per-stage per-micro-batch forward/backward times (from the Eq. 1 cost
model x device frequency x straggler factor), simulate the 1F1B schedule and
report step time, per-stage bubble, and peak in-flight activation counts.
The cluster's modeled step time (``simulate_step_time``) and migration
windows come from it.

A copy of ``simulate_1f1b`` of ``repro.core.pipeline`` (the JAX package),
plain Python; the reference's interleaved and DP x PP variants, which only
its benchmarks use, are not copied.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass
class StageTiming:
    fwd: float                      # per-micro-batch forward seconds
    bwd: float                      # per-micro-batch backward seconds
    num_micro: int                  # micro-batches this stage processes


@dataclasses.dataclass
class SimResult:
    step_time: float
    stage_busy: List[float]
    stage_bubble: List[float]
    peak_inflight: List[int]        # max concurrent stored activations / stage

    @property
    def pipeline_efficiency(self) -> float:
        total = self.step_time * len(self.stage_busy)
        return sum(self.stage_busy) / total if total else 0.0


def simulate_1f1b(stages: Sequence[StageTiming],
                  p2p: float = 0.0) -> SimResult:
    """Event-driven 1F1B.  All stages must process the same number of
    micro-batches (standard PP); per-rank load differences enter through
    fwd/bwd times (micro-batch resizing)."""
    P = len(stages)
    M = stages[0].num_micro
    assert all(s.num_micro == M for s in stages)
    warmup = [min(P - i, M) for i in range(P)]   # in-flight fwd before 1F1B

    # event-driven: track per-stage ready times and dependency times
    fwd_done = [[0.0] * M for _ in range(P)]
    bwd_done = [[0.0] * M for _ in range(P)]
    stage_free = [0.0] * P
    # schedule order per stage: warmup fwds, then alternate (1F1B), then cooldown
    order: List[List[Tuple[str, int]]] = []
    for i in range(P):
        w = warmup[i]
        seq: List[Tuple[str, int]] = [("f", m) for m in range(w)]
        nf, nb = w, 0
        while nb < M:
            if nb < M:
                seq.append(("b", nb)); nb += 1
            if nf < M:
                seq.append(("f", nf)); nf += 1
        order.append(seq)

    inflight = [0] * P
    peak = [0] * P
    ptr = [0] * P
    done = [False] * P
    # iterate until all stages drained; simple fixed-point loop over ready ops
    progressed = True
    while any(not d for d in done):
        progressed = False
        for i in range(P):
            while ptr[i] < len(order[i]):
                kind, m = order[i][ptr[i]]
                if kind == "f":
                    if i > 0 and fwd_done[i - 1][m] == 0.0:
                        break   # upstream forward not yet scheduled
                    dep = fwd_done[i - 1][m] + p2p if i > 0 else 0.0
                    start = max(stage_free[i], dep)
                    end = start + stages[i].fwd
                    fwd_done[i][m] = end
                    inflight[i] += 1
                    peak[i] = max(peak[i], inflight[i])
                else:
                    dep_self = fwd_done[i][m]
                    dep_next = bwd_done[i + 1][m] + p2p if i < P - 1 else fwd_done[i][m]
                    if i < P - 1 and bwd_done[i + 1][m] == 0.0:
                        break   # dependency not yet scheduled
                    start = max(stage_free[i], dep_self, dep_next)
                    end = start + stages[i].bwd
                    bwd_done[i][m] = end
                    inflight[i] -= 1
                stage_free[i] = end
                ptr[i] += 1
                progressed = True
            if ptr[i] == len(order[i]):
                done[i] = True
        if not progressed and not all(done):
            # shouldn't happen with a valid 1F1B order; avoid infinite loop
            raise RuntimeError("pipeline deadlock in simulation")

    step_time = max(max(r) for r in bwd_done)
    busy = [stages[i].num_micro * (stages[i].fwd + stages[i].bwd) for i in range(P)]
    bubble = [step_time - b for b in busy]
    return SimResult(step_time, busy, bubble, peak)
