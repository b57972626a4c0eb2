"""1F1B pipeline discrete-event simulator.

Given per-stage per-micro-batch forward/backward times (from the Eq. 1 cost
model x device frequency x straggler factor), simulate the 1F1B schedule and
report step time, per-stage bubble, and peak in-flight activation counts.
The cluster's modeled step time (``simulate_step_time``) and migration
windows come from it.

Supports per-rank *extra* micro-batches (ReCycle rerouting: surviving ranks
of the failed stage absorb the failed rank's micro-batches, the
``core.policies`` baselines) and interleaved virtual stages.

A copy of ``repro.core.pipeline`` (the JAX package), plain Python.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


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
    fwd/bwd times (micro-batch resizing) — see simulate_dp_pp for the DP
    dimension."""
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


def simulate_interleaved_1f1b(stages: Sequence[StageTiming], v: int = 2,
                              p2p: float = 0.0) -> SimResult:
    """Interleaved 1F1B with `v` virtual stages per physical stage
    (Megatron-LM interleaving; the schedule family AdaPipe starts from).

    Each physical stage p hosts v model chunks; chunk j of stage p is virtual
    stage j*P + p.  We simulate the virtual pipeline of depth v*P where each
    virtual stage costs 1/v of the physical stage's per-micro time, then fold
    the per-virtual-stage busy/bubble back onto physical stages.  Warmup
    bubble shrinks by ~1/v at the cost of more P2P messages (modeled via the
    deeper virtual chain)."""
    P = len(stages)
    virt = []
    for j in range(v):
        for p in range(P):
            s = stages[p]
            virt.append(StageTiming(s.fwd / v, s.bwd / v, s.num_micro))
    r = simulate_1f1b(virt, p2p=p2p)
    busy = [0.0] * P
    peak = [0] * P
    for idx in range(v * P):
        p = idx % P
        busy[p] += r.stage_busy[idx]
        peak[p] += r.peak_inflight[idx]
    # Device-sharing bound: the virtual pipeline above lets chunks of the
    # same physical device overlap; a device must serialize its v chunks, so
    # step >= busy_p + fill/drain residual (P-1)(f_p + b_p)/v — for balanced
    # stages this recovers the Megatron interleaved bubble (P-1)/(vM).
    dev_bound = max(busy[p] + (P - 1) * (stages[p].fwd + stages[p].bwd) / v
                    + 2 * (P - 1) * p2p
                    for p in range(P))
    step = max(r.step_time, dev_bound)
    bubble = [step - b for b in busy]
    return SimResult(step, busy, bubble, peak)


def simulate_dp_pp(fwd: Sequence[Sequence[float]], bwd: Sequence[Sequence[float]],
                   num_micro: int, p2p: float = 0.0,
                   extra_micro: Optional[Dict[Tuple[int, int], int]] = None,
                   ) -> Tuple[float, List[SimResult]]:
    """fwd[d][p], bwd[d][p]: per-micro times for DP replica d, stage p.
    extra_micro[(d, p)]: additional micro-batches rerouted to that rank
    (ReCycle).  DP replicas run the same schedule; the step ends at the
    slowest replica (gradient all-reduce joins them), and within a replica a
    rank with extra micro-batches stretches its stage.
    Returns (step_time, per-replica SimResult)."""
    extra_micro = extra_micro or {}
    results = []
    for d in range(len(fwd)):
        stages = []
        for p in range(len(fwd[d])):
            extra = extra_micro.get((d, p), 0)
            scale = (num_micro + extra) / num_micro
            stages.append(StageTiming(fwd[d][p] * scale, bwd[d][p] * scale,
                                      num_micro))
        results.append(simulate_1f1b(stages, p2p=p2p))
    return max(r.step_time for r in results), results
