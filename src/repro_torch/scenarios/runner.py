"""Trace-driven ScenarioRunner: one engine for every elasticity experiment.

A copy of ``repro.scenarios.runner`` (the JAX package) for the port.  In
cluster mode the numerics run on the cluster's device (the card by default:
the hand-written kernels); analytic mode is numpy only.

Two execution modes share the :class:`~repro_torch.scenarios.metrics.MetricsCollector`
artifact schema:

* :class:`ClusterScenarioRunner` — drives a real
  :class:`~repro_torch.core.cluster.VirtualCluster` step by step.  At each step the
  scenario's due events go through the paper's full recovery path
  (``Agent``-shaped event -> ``ScheduleEngine.plan`` -> executor inside
  ``VirtualCluster.apply_event``/``apply_plan``), then one real training step
  runs.  Records: loss, simulated step time, throughput, DP width, itemized
  MTTR per recovery — the substrate for convergence-consistency checks.

* :class:`AnalyticScenarioRunner` — evaluates paper-scale workloads through a
  recovery *policy* (ElasWave / ReCycle / TorchFT) plus the cost models,
  without training numerics.  The runner walks the event timeline, mutates
  the cluster view (alive / slow / freq), re-decides after every event
  boundary, and integrates throughput over intervals, optionally charging an
  MTTR penalty per capacity change (spot-trace replays).  It additionally
  accounts the data-plane alternatives at every shrink/grow: communicator
  edit vs partial vs full rebuild seconds, and — for directed MIGRATE
  probes — blocking vs non-blocking migration stall, which is how the MTTR
  micro-benchmarks ride the same engine.

``run_scenario`` picks the mode from the workload type.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.clusterview import GroupDelta
from repro_torch.core.communicator import DynamicCommunicator, build_hybrid_groups
from repro_torch.core.events import ElasticEvent, EventKind
from repro_torch.core.migration import MigrationSpec, migration_timing

from .metrics import MetricsCollector, ScenarioResult
from .spec import AnalyticWorkload, ClusterWorkload, Scenario


class ClusterScenarioRunner:
    """Numeric mode: scenario events against a live VirtualCluster.

    ``checkers`` — a list of :class:`repro_torch.core.invariants.InvariantChecker`
    hooks, called after every event application and every training step, so
    the paper's consistency guarantees are asserted at each point of the
    trace rather than only at the end.
    """

    def __init__(self, scenario: Scenario, workload: ClusterWorkload, *,
                 checkers=()):
        self.scenario = scenario
        self.workload = workload
        self.checkers = list(checkers)

    def run(self) -> ScenarioResult:
        m = MetricsCollector()
        cl = self.workload.make_cluster()
        for c in self.checkers:
            c.on_cluster_start(self, cl)
        gb = self.workload.global_batch
        for step in range(self.scenario.horizon):
            for ev in self.scenario.events_at(step):
                rec = cl.apply_event(ev)
                m.record_recovery(step, ev, rec)
                for c in self.checkers:
                    c.after_cluster_event(step, ev, cl, rec)
            loss = cl.train_step()
            for c in self.checkers:
                c.after_cluster_step(step, cl, loss)
            t = cl.simulate_step_time()
            widths = [int(cl.alive[:, p].sum()) for p in range(cl.pp)]
            m.record_step(step, loss=float(loss), step_time=float(t),
                          throughput=gb / t, dp_width=int(min(widths)),
                          alive=int(cl.alive.sum()))
        losses = [s["loss"] for s in m.steps]
        summary = {
            "first_loss": losses[0] if losses else None,
            "final_loss": losses[-1] if losses else None,
            "n_recoveries": len(m.recoveries),
            "mttr_total": sum(r["mttr"].get("total", 0.0)
                              for r in m.recoveries),
            "final_step_time": m.steps[-1]["step_time"] if m.steps else None,
        }
        res = m.result(self.scenario, "cluster", self.workload.describe(),
                       summary)
        res.summary["losses"] = losses    # convergence-consistency record
        return res


class AnalyticScenarioRunner:
    """Policy mode: paper-scale what-if evaluation with MTTR accounting."""

    def __init__(self, scenario: Scenario, workload: AnalyticWorkload,
                 policy, *, reference_policy=None,
                 mttr_model: Optional[Dict[str, float]] = None,
                 zero_layout: str = "interleaved",
                 blocking_migration: bool = False,
                 account_communicator: bool = True,
                 comm_factory=DynamicCommunicator,
                 checkers=()):
        self.scenario = scenario
        self.workload = workload
        self.policy = policy
        self.reference_policy = reference_policy
        self.mttr_model = mttr_model or {}
        self.zero_layout = zero_layout
        self.blocking_migration = blocking_migration
        self.account_communicator = account_communicator
        # injection point for the dict/set oracle
        # (core.legacy_comm.LegacyDynamicCommunicator) in equivalence tests
        self.comm_factory = comm_factory
        # repro_torch.core.invariants.InvariantChecker hooks, fired after every
        # event application and every decision boundary
        self.checkers = list(checkers)

    # -- data-plane accounting --------------------------------------------
    def delta_for_event(self, ev: ElasticEvent) -> GroupDelta:
        """The group-membership delta this runner's accounting applies for
        ``ev`` — shared with the MTTR invariant checker so its
        legacy-communicator oracle replays the exact same delta sequence."""
        if ev.is_grow:
            return GroupDelta.grow(
                [(f"dp_stage{r % self.workload.pp}_tp0", r)
                 for r in ev.ranks])
        return GroupDelta.shrink(list(ev.ranks))

    def _communicator_accounting(self, comm: DynamicCommunicator,
                                 ev: ElasticEvent) -> Dict[str, float]:
        """Price the three recovery modes from identical pre-event state
        (``price`` is pure — no clones), then commit the in-place edit
        (ElasWave's choice) to ``comm``."""
        delta = self.delta_for_event(ev)
        if ev.is_grow:
            return {"edit_seconds": comm.apply(delta, "edit").seconds}
        part = comm.price(delta, "partial_rebuild").seconds
        full = comm.price(delta, "full_rebuild").seconds
        edit = comm.apply(delta, "edit").seconds
        return {"edit_seconds": edit, "partial_rebuild_seconds": part,
                "full_rebuild_seconds": full}

    def _migration_accounting(self, seg, ev: ElasticEvent) -> Dict[str, float]:
        """Stall seconds of a directed migration under this runner's layout /
        blocking config, against one step's compute window."""
        w = self.workload
        L = w.cfg.num_layers
        fl = seg.seg_fwd_flops(0, L // w.pp - 1, w.mbs) * 3
        window = fl / (w.hw.peak_flops * w.hw.mfu) * w.num_micro
        pbytes = int(sum(seg.param_bytes[l] for l in ev.layers))
        obytes = int(sum(seg.opt_bytes[l] for l in ev.layers))
        spec = MigrationSpec(tuple(ev.layers), ev.src_stage, ev.dst_stage,
                             pbytes, obytes, dp=w.dp,
                             zero_layout=self.zero_layout,
                             blocking=self.blocking_migration)
        t = migration_timing(spec, w.hw.link_bw, window)
        return {"stall_seconds": t.stall_seconds,
                "param_seconds": t.param_seconds,
                "opt_seconds": t.opt_seconds,
                "overlapped_seconds": t.overlapped_seconds,
                "n_layers": len(ev.layers)}

    # -- main loop ---------------------------------------------------------
    def _decide(self, seg, view):
        t0 = time.perf_counter()
        d = self.policy.decide(seg, view.copy())
        wall = time.perf_counter() - t0
        thr = (self.workload.global_batch / d.step_time
               if d.feasible and np.isfinite(d.step_time) else 0.0)
        return d, thr, wall

    def run(self) -> ScenarioResult:
        w = self.workload
        m = MetricsCollector()
        seg = w.build_seg()
        # one persistent rank-vectorized view; every burst is applied as a
        # single fancy-indexed array op (no per-rank dict surgery)
        view = w.build_view(seg)
        comm = self.comm_factory(build_hybrid_groups(w.dp, w.pp))

        ref = self.reference_policy or self.policy
        base = ref.decide(seg, w.build_view(seg))
        thr0 = w.global_batch / base.step_time

        for c in self.checkers:
            c.on_analytic_start(self, seg, view, comm)

        boundaries = sorted({0} | set(self.scenario.event_steps))
        total_samples = 0.0
        decision = None
        for i, t in enumerate(boundaries):
            charge = 0.0
            for ev in self.scenario.events_at(t):
                extra: Dict = {}
                mttr: Dict[str, float] = {}
                if ev.kind == EventKind.MIGRATE:
                    mig = self._migration_accounting(seg, ev)
                    mttr = {"migration": mig["stall_seconds"],
                            "total": mig["stall_seconds"]}
                    extra["migration"] = mig
                else:
                    view.apply_elastic(ev)
                    if self.account_communicator and (ev.is_shrink or ev.is_grow):
                        comm_acct = self._communicator_accounting(comm, ev)
                        extra["communicator"] = comm_acct
                        mttr["communicator"] = comm_acct["edit_seconds"]
                    paid = self.mttr_model.get(
                        getattr(self.policy, "name", "")) \
                        if t > 0 and (ev.is_shrink or ev.is_grow) else None
                    if paid is not None:   # capacity change mid-run pays MTTR
                        charge = paid
                        mttr["total"] = paid
                    else:
                        mttr["total"] = sum(mttr.values())
                m.record_recovery(t, ev, mttr, **extra)
                for c in self.checkers:
                    c.after_analytic_event(t, ev, view, comm, extra)
            decision, thr, wall = self._decide(seg, view)
            for c in self.checkers:
                c.after_analytic_decision(t, view, decision, thr, thr0)
            end = boundaries[i + 1] if i + 1 < len(boundaries) else \
                self.scenario.horizon
            dur = end - t
            total_samples += thr * max(dur - charge, 0)
            m.record_step(t, duration=dur, rel_throughput=thr / thr0,
                          step_time=float(decision.step_time),
                          feasible=bool(decision.feasible),
                          policy=getattr(self.policy, "name", "?"),
                          mttr_charged=charge,
                          decide_wall_seconds=wall)
        horizon = max(self.scenario.horizon, 1)
        summary = {
            "policy": getattr(self.policy, "name", "?"),
            "time_avg_rel_throughput": total_samples / horizon / thr0,
            "final_rel_throughput": m.steps[-1]["rel_throughput"]
            if m.steps else None,
            "final_feasible": m.steps[-1]["feasible"] if m.steps else None,
            "n_events": len(self.scenario.events),
        }
        if decision is not None:
            summary["final_decision_detail"] = {
                k: v for k, v in decision.detail.items()
                if isinstance(v, (int, float, bool, str))}
        return m.result(self.scenario, "analytic", w.describe(), summary)


def run_scenario(scenario: Scenario, workload, **kw) -> ScenarioResult:
    """Mode is inferred from the workload type."""
    if isinstance(workload, ClusterWorkload):
        return ClusterScenarioRunner(scenario, workload, **kw).run()
    if isinstance(workload, AnalyticWorkload):
        return AnalyticScenarioRunner(scenario, workload, **kw).run()
    raise TypeError(f"unknown workload type: {type(workload)!r}")
