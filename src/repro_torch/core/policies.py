"""Recovery policies: ElasWave (ours) + three baselines.

A copy of ``repro.core.policies`` (the JAX package), numpy only: decisions
come from the cost model's modeled seconds, never from measured times.

All policies consume the same rank-vectorized :class:`ClusterView`
(``core.clusterview`` — re-exported here for compatibility) and produce a
Decision the pipeline simulator can evaluate, so Fig. 11/12a/14 comparisons
are apples-to-apples.  Per-rank Python loops are replaced by stage/replica
array reductions, so ``decide`` stays sub-second at 10^5 ranks: the only
remaining loops run over pipeline stages (pp) or unique (freq, slow)
configurations, never over dp.

* **TorchFTPolicy** — DP-replica granularity: a failure drops the entire DP
  replica (pipeline) containing the failed rank; remaining replicas re-split
  the global batch.  Wastes the failed replica's surviving ranks.
* **ReCyclePolicy** — keep the layout; reroute the failed rank's micro-batches
  to same-stage peers in other DP replicas (decoupled-backward bubbles absorb
  some of it).  Creates stage stragglers when the bubble budget is exhausted
  and extends activation lifetimes (OOM risk), per paper Fig. 1.
* **OobleckPolicy** — pipeline-template fallback (Oobleck): precomputed
  minimax partitions per surviving-stage count; a damaged replica is
  re-instantiated on its k surviving workers from template[k] instead of
  being dropped.
* **ElasWavePolicy** — multi-dimensional: dataflow resize (DP domain) +
  minimax layer re-partition (PP domain) + DVFS top-up.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .clusterview import ClusterView, FailureDomainMap, GroupDelta  # noqa: F401  (re-export)
from .cost_model import HardwareSpec, SegmentCosts, mini_step_time
from .pipeline import StageTiming, simulate_1f1b, simulate_dp_pp
from .planners.graph import minimax_layer_partition
from .planners.dvfs import plan_dvfs


@dataclasses.dataclass
class Decision:
    name: str
    step_time: float
    feasible: bool
    detail: Dict


def _stage_times(seg: SegmentCosts, view: ClusterView, assignment,
                 mbs_by_stage: Sequence[int], freq: np.ndarray,
                 slow: np.ndarray, d: int) -> List[StageTiming]:
    stages = []
    for p, (a, b) in enumerate(assignment):
        eff = seg.hw.peak_flops * seg.hw.mfu * freq[d, p] / slow[d, p]
        fl = seg.seg_fwd_flops(a, b, mbs_by_stage[p])
        stages.append(StageTiming(fl / eff, 2 * fl / eff, view.num_micro))
    return stages


class TorchFTPolicy:
    name = "torchft"

    def decide(self, seg: SegmentCosts, view: ClusterView) -> Decision:
        # replicas with any dead rank are dropped entirely
        alive_rows = view.alive.all(axis=1)                     # [dp]
        n = int(alive_rows.sum())
        if n == 0:
            return Decision(self.name, float("inf"), False, {"alive_reps": 0})
        # global batch is re-split over the surviving replicas: same
        # micro-batch size, proportionally more micro-batches per replica.
        mbs = max(1, view.global_batch // (view.num_micro * view.dp))
        num_micro_n = -(-view.global_batch // (mbs * n))
        fl = [seg.seg_fwd_flops(a, b, mbs) for a, b in view.layer_assignment]
        # replicas synchronized by grad all-reduce -> step = max over
        # replicas; identical (freq, slow) rows give identical times, so
        # simulate each distinct configuration once (at scale: one row).
        rows = np.concatenate([view.freq[alive_rows], view.slow[alive_rows]],
                              axis=1)
        times = []
        for row in np.unique(rows, axis=0):
            f, s = row[:view.pp], row[view.pp:]
            st = [StageTiming(
                fl[p] / (seg.hw.peak_flops * seg.hw.mfu * f[p] / s[p]),
                2 * fl[p] / (seg.hw.peak_flops * seg.hw.mfu * f[p] / s[p]),
                num_micro_n) for p in range(view.pp)]
            times.append(simulate_1f1b(st).step_time)
        return Decision(self.name, max(times), True,
                        {"alive_reps": n, "mbs": mbs, "num_micro": num_micro_n,
                         "wasted_ranks": int((view.alive.sum()
                                              - n * view.pp))})


class ReCyclePolicy:
    name = "recycle"

    def __init__(self, oom_pressure_limit: float = 2.5):
        # memory-pressure model: rerouting extends activation lifetimes and
        # defers weight-gradients on every affected stage.  pressure =
        # sum over affected stages of (extra / num_micro).  Calibrated so the
        # paper's observation holds: Llama2-34B (DP=3) OOMs at 3-node loss
        # (6 affected stages x 0.5 = 3.0 > limit) but not at 1-2 nodes.
        self.oom_pressure_limit = oom_pressure_limit

    def decide(self, seg: SegmentCosts, view: ClusterView) -> Decision:
        mbs = max(1, view.global_batch // (view.num_micro * view.dp))
        extra: Dict[Tuple[int, int], int] = {}
        for p in range(view.pp):
            dead = [d for d in range(view.dp) if not view.alive[d, p]]
            live = [d for d in range(view.dp) if view.alive[d, p]]
            if dead and not live:
                return Decision(self.name, float("inf"), False, {"stage_lost": p})
            for i, d in enumerate(dead):
                # reroute the failed rank's micro-batches round-robin to peers
                share = view.num_micro // max(len(live), 1)
                for j, ld in enumerate(live):
                    add = share + (1 if j < view.num_micro % max(len(live), 1) else 0)
                    extra[(ld, p)] = extra.get((ld, p), 0) + add
        # OOM check: deferred weight-grad + extended activation pressure
        pressure = sum(e / view.num_micro for e in extra.values())
        oom = pressure > self.oom_pressure_limit
        fwd = [[0.0] * view.pp for _ in range(view.dp)]
        bwd = [[0.0] * view.pp for _ in range(view.dp)]
        for d in range(view.dp):
            st = _stage_times(seg, view, view.layer_assignment,
                              [mbs] * view.pp, view.freq, view.slow, d)
            for p, s in enumerate(st):
                fwd[d][p], bwd[d][p] = s.fwd, s.bwd
        # replicas with dead ranks still run (peers cover), but dead rank rows
        # excluded from timing by copying a live replica's times (uniform
        # hardware -> any live row; if none is fully live, rows are already
        # per-stage correct since peers cover the dead cells)
        live_rows = [d for d in range(view.dp) if view.alive[d].all()]
        if live_rows:
            for d in range(view.dp):
                if not view.alive[d].all():
                    fwd[d] = list(fwd[live_rows[0]])
                    bwd[d] = list(bwd[live_rows[0]])
        step, _ = simulate_dp_pp(fwd, bwd, view.num_micro,
                                 extra_micro=extra)
        return Decision(self.name, step, not oom,
                        {"extra_micro": dict(extra), "oom": oom, "mbs": mbs})


class OobleckPolicy:
    """Oobleck-style pipeline-template fallback.

    For each surviving-stage count k the policy precomputes (and caches) a
    minimax layer partition of all L layers over k stages — the "pipeline
    template".  A replica that lost ranks is re-instantiated on its k
    surviving workers from template[k], so its capacity is kept (unlike
    TorchFT, which drops the replica) at the price of a deeper-stage,
    higher-latency pipeline.  Replicas whose template is memory-infeasible
    are dropped; survivors re-split the global batch TorchFT-style.
    """
    name = "oobleck"

    def __init__(self, hw: Optional[HardwareSpec] = None):
        self.hw = hw or HardwareSpec()
        self._templates: Dict[Tuple, object] = {}

    def _template(self, seg: SegmentCosts, view: ClusterView, k: int, mbs: int):
        key = (id(seg.cfg), view.seq, k, mbs, view.mem_cap,
               min(k, view.num_micro))
        plan = self._templates.get(key)
        if plan is None:
            L = seg.cfg.num_layers

            def t(p, a, b):
                return mini_step_time(seg, a, b, mbs, hw=self.hw)

            def mem(p, a, b):
                return seg.seg_mem(a, b, mbs,
                                   inflight=min(k, view.num_micro), dp_size=1)

            plan = minimax_layer_partition(L, k, t, mem, [view.mem_cap] * k)
            self._templates[key] = plan
        return plan

    def decide(self, seg: SegmentCosts, view: ClusterView) -> Decision:
        k_rep = view.replica_width()                            # [dp]
        mbs = max(1, view.global_batch // (view.num_micro * view.dp))
        ks = [int(k) for k in np.unique(k_rep[k_rep > 0])]
        tmpl = {k: self._template(seg, view, k, mbs) for k in ks}
        feasible_ks = [k for k in ks if tmpl[k].feasible]
        live = (k_rep > 0) & np.isin(k_rep, feasible_ks)
        n = int(live.sum())
        if n == 0:
            return Decision(self.name, float("inf"), False, {"alive_reps": 0})
        num_micro_n = -(-view.global_batch // (mbs * n))
        # each live replica runs template[k] on its survivors, slowed by its
        # worst straggler / slowest clock; distinct (k, slow, freq) configs
        # are simulated once (at scale: a handful).
        rep_slow = np.where(view.alive, view.slow, 1.0).max(axis=1, initial=1.0)
        rep_freq = np.where(view.alive, view.freq, np.inf).min(axis=1,
                                                               initial=np.inf)
        triples = np.stack([k_rep.astype(np.float64), rep_slow, rep_freq],
                           axis=1)[live]
        times = []
        for k, s, f in np.unique(triples, axis=0):
            ranges = tmpl[int(k)].stage_ranges
            eff = self.hw.peak_flops * self.hw.mfu * f / s
            st = [StageTiming(seg.seg_fwd_flops(a, b, mbs) / eff,
                              2 * seg.seg_fwd_flops(a, b, mbs) / eff,
                              num_micro_n) for a, b in ranges]
            times.append(simulate_1f1b(st).step_time)
        return Decision(self.name, max(times), True,
                        {"alive_reps": n, "mbs": mbs, "num_micro": num_micro_n,
                         "templates": {k: tmpl[k].layers_per_stage
                                       for k in feasible_ks},
                         "dropped_reps": int((k_rep > 0).sum()) - n,
                         "wasted_ranks": int(view.alive.sum()
                                             - k_rep[live].sum())})


class ElasWavePolicy:
    name = "elaswave"

    def __init__(self, hw: Optional[HardwareSpec] = None, use_dvfs: bool = True,
                 use_migration: bool = True, pipeline_v: int = 1):
        self.hw = hw or HardwareSpec()
        self.use_dvfs = use_dvfs
        self.use_migration = use_migration
        self.pipeline_v = pipeline_v     # >1: interleaved-1F1B virtual stages

    def decide(self, seg: SegmentCosts, view: ClusterView) -> Decision:
        L = seg.cfg.num_layers
        P = view.pp
        # per-stage surviving DP width (one reduction, not a dp loop)
        width_v = view.stage_width()
        width = [int(w) for w in width_v]
        if min(width) == 0:
            return Decision(self.name, float("inf"), False, {"stage_lost": True})
        # 1) dataflow: per-stage micro-batch sizes (failed rank's share spread)
        per_micro = view.global_batch // view.num_micro
        mbs_stage = [int(m) for m in np.ceil(per_micro / width_v)]

        # 2) graph: minimax layer re-partition under memory caps.
        # Per-stage straggler factors enter the cost (a slow stage should
        # receive FEWER layers — fail-slow mitigation via migration).
        slow_stage = view.stage_slow()

        def t(p, a, b):
            return mini_step_time(seg, a, b, mbs_stage[p], hw=self.hw) \
                * slow_stage[p]

        def mem(p, a, b):
            return seg.seg_mem(a, b, mbs_stage[p], inflight=min(P, view.num_micro),
                               dp_size=width[p])

        if self.use_migration:
            plan = minimax_layer_partition(L, P, t, mem,
                                           [view.mem_cap] * P)
            if not plan.feasible:
                return Decision(self.name, float("inf"), False, {"mem_infeasible": True})
            assignment = list(plan.stage_ranges)
        else:
            assignment = list(view.layer_assignment)

        # 3) DVFS: up-clock residual stragglers to match the best stage time
        freq = view.freq.copy()
        base_times = []
        for p, (a, b) in enumerate(assignment):
            eff = self.hw.peak_flops * self.hw.mfu / slow_stage[p]
            fl = seg.seg_fwd_flops(a, b, mbs_stage[p])
            base_times.append(3 * fl / eff)
        target = min(base_times)
        dvfs_detail = []
        if self.use_dvfs:
            for p in range(P):
                if base_times[p] <= target * 1.001:
                    continue

                def obs(f, p=p):
                    return base_times[p] / f

                dplan = plan_dvfs(obs, 1.0, self.hw.max_freq, target,
                                  eps=0.02 * target, df_min=0.01, rank=p)
                freq[:, p] = np.maximum(freq[:, p], dplan.freq)
                base_times[p] = base_times[p] / dplan.freq
                dvfs_detail.append((p, round(dplan.freq, 3), dplan.status))

        # evaluate: stage p runs with its own width/mbs; replicas sync on DP
        # all-reduce — simulate one "effective" pipeline with per-stage times
        stage_freq = np.where(view.alive, freq, 0.0).max(axis=0)
        stages = []
        for p, (a, b) in enumerate(assignment):
            eff = (self.hw.peak_flops * self.hw.mfu * stage_freq[p]
                   / slow_stage[p])
            fl = seg.seg_fwd_flops(a, b, mbs_stage[p])
            stages.append(StageTiming(fl / eff, 2 * fl / eff, view.num_micro))
        if self.pipeline_v > 1:
            from .pipeline import simulate_interleaved_1f1b
            step = simulate_interleaved_1f1b(stages, v=self.pipeline_v).step_time
        else:
            step = simulate_1f1b(stages).step_time
        return Decision(self.name, step, True,
                        {"assignment": assignment, "mbs_stage": mbs_stage,
                         "dvfs": dvfs_detail, "width": width})
