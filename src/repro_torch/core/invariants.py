"""Machine-checked forms of the paper's four elastic guarantees (§4, §6).

A copy of ``repro.core.invariants`` (the JAX package) for the port's
``VirtualCluster``.  Where the reference flips ``use_pallas`` (Pallas kernels
vs plain jnp), the port flips the device: a cluster on the card runs the
hand-written kernels, a cluster on the CPU their plain versions.  Stage
state lives in device tensors (``st.full(comp)``); the checkers compare it on
the host, as numpy.

ElasWave's claim is that *every* legal elastic event sequence preserves four
invariants.  This module turns each one from prose into an
:class:`InvariantChecker` that the scenario runners
(``scenarios.runner.ClusterScenarioRunner`` / ``AnalyticScenarioRunner``,
``checkers=[...]``) call after every event application, every training step,
and every policy decision:

1. **Parameter consistency** — :class:`ParameterConsistencyChecker` drives a
   bit-exact twin cluster on the opposite code path (``fast_path=False``,
   the seed implementation) through the identical event/step sequence and
   asserts shard-for-shard equality, and independently re-derives every
   rank's shard from the stage's reassembled master vector through the
   pure-Python ``zero.Layout`` ownership map.  The port has no seed path
   yet: building the twin raises ``NotImplementedError``.
   :class:`KernelConsistencyChecker` holds a card cluster to its CPU twin
   under the declared kernel tolerance.
2. **Dataflow consistency (§4.1)** — :class:`DataflowConsistencyChecker`:
   the global batch size is preserved exactly across every dataflow resize
   (``sum(mbs) * num_micro == global_batch``), per-rank gradient weights sum
   to 1 and equal each rank's sample share, and the sampler partition covers
   the step's global sample ids exactly once.  Analytic mode additionally
   checks each policy's decision covers the global batch.
3. **RNG / computation consistency (§4.4)** — :class:`RngConsistencyChecker`:
   the per-(sample, layer) stream map is content-addressed, so the stream of
   every surviving sample is unchanged by any reassignment.  The checker
   recomputes the normalized sample->stream map after every event; the
   paper's "naive" rank-addressed ablation mode trips it on the first
   dataflow resize.
4. **Bounded MTTR / throughput recovery (§6.1)** —
   :class:`MttrThroughputChecker` (analytic) replays the runner's exact
   ``GroupDelta`` sequence through the dict/set
   ``legacy_comm.LegacyDynamicCommunicator`` oracle and requires equal
   ``OpStats`` seconds, bounds the committed edit cost by the O(degree)
   budget (independent of cluster size), and brackets post-event throughput:
   pristine view -> exactly base throughput; any legal degraded view ->
   within (DVFS-capped upper bound, width/straggler floor).
   :class:`MttrBoundChecker` is the numeric-mode counterpart over the
   itemized recovery records.

A violation raises :class:`InvariantViolation` (an ``AssertionError``
subclass).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .communicator import EDIT_CONST_S, LINK_SETUP_S


def _host(t) -> np.ndarray:
    """A stage vector (a tensor on any device) as a host numpy array."""
    return t.detach().cpu().numpy()


class InvariantViolation(AssertionError):
    """One of the paper's four elastic guarantees failed on a trace."""


class InvariantChecker:
    """Hook interface called by the scenario runners; all hooks are no-ops.

    Cluster (numeric) mode: ``on_cluster_start`` once, then
    ``after_cluster_event`` per applied event and ``after_cluster_step`` per
    training step.  Analytic mode: ``on_analytic_start`` once, then
    ``after_analytic_event`` per event and ``after_analytic_decision`` per
    re-decision boundary.
    """

    name = "invariant"

    # -- numeric (VirtualCluster) hooks ------------------------------------
    def on_cluster_start(self, runner, cluster):
        pass

    def after_cluster_event(self, step, event, cluster, record):
        pass

    def after_cluster_step(self, step, cluster, loss):
        pass

    # -- analytic (ClusterView / policy) hooks -----------------------------
    def on_analytic_start(self, runner, seg, view, comm):
        pass

    def after_analytic_event(self, step, event, view, comm, extra):
        pass

    def after_analytic_decision(self, step, view, decision, throughput,
                                base_throughput):
        pass

    def fail(self, msg: str):
        raise InvariantViolation(f"[{self.name}] {msg}")


# ---------------------------------------------------------------------------
# 1. parameter consistency (fast path == legacy oracle, shards == zero.Layout)
# ---------------------------------------------------------------------------
class ParameterConsistencyChecker(InvariantChecker):
    """Twin-oracle lockstep: a second cluster on the opposite code path
    receives the identical event/step sequence; state must stay bit-identical
    (float ``==``, no tolerance) after every event and every step."""

    name = "parameter-consistency"

    def __init__(self):
        self.twin = None

    def on_cluster_start(self, runner, cluster):
        self.twin = runner.workload.make_cluster(
            fast_path=not cluster.fast_path)
        self._compare_state("start", cluster)

    def after_cluster_event(self, step, event, cluster, record):
        twin_rec = self.twin.apply_event(event)
        for k in ("detect", "communicator", "rng_moves"):
            if twin_rec.get(k) != record.get(k):
                self.fail(f"step {step} {event.describe()}: recovery record "
                          f"field {k!r} diverged (fast={record.get(k)!r}, "
                          f"legacy={twin_rec.get(k)!r})")
        self._compare_state(f"step {step} after {event.describe()}", cluster)

    def after_cluster_step(self, step, cluster, loss):
        twin_loss = self.twin.train_step()
        if float(twin_loss) != float(loss):
            self.fail(f"step {step}: loss diverged from legacy oracle "
                      f"(fast={float(loss)!r}, legacy={float(twin_loss)!r})")
        self._compare_state(f"step {step} after train_step", cluster)

    def _compare_state(self, where: str, cl):
        from .statespace import COMPONENTS
        tw = self.twin
        if cl.layer_assignment != tw.layer_assignment:
            self.fail(f"{where}: layer assignment diverged "
                      f"({cl.layer_assignment} vs {tw.layer_assignment})")
        if list(cl.per_rank_mbs) != list(tw.per_rank_mbs):
            self.fail(f"{where}: per-rank micro-batch sizes diverged")
        if list(cl.grad_weights) != list(tw.grad_weights):
            self.fail(f"{where}: gradient weights diverged")
        for p, (st, ts) in enumerate(zip(cl.stages, tw.stages)):
            if (list(st.entries) != list(ts.entries)
                    or list(st.sizes) != list(ts.sizes)
                    or list(st.dp_ranks) != list(ts.dp_ranks)):
                self.fail(f"{where}: stage {p} structure diverged")
            for comp in COMPONENTS:
                a = _host(st.full(comp))
                b = _host(ts.full(comp))
                if not np.array_equal(a, b):
                    i = int(np.flatnonzero(a != b)[0])
                    self.fail(f"{where}: stage {p} {comp} full vector "
                              f"diverged from legacy oracle at element {i} "
                              f"({a[i]!r} vs {b[i]!r})")
                for r in st.dp_ranks:
                    if not np.array_equal(_host(st.shard(r)[comp]),
                                          _host(ts.shard(r)[comp])):
                        self.fail(f"{where}: stage {p} rank {r} {comp} shard "
                                  f"diverged from legacy oracle")
            self._check_layout(where, p, st)

    def _check_layout(self, where: str, p: int, st):
        """Every rank's shard must equal the reassembled master gathered
        through the pure-Python ``zero.Layout`` ownership intervals."""
        from .statespace import COMPONENTS
        from .zero import Layout
        layout = Layout(st.layout_kind, tuple(st.sizes), len(st.dp_ranks))
        for comp in COMPONENTS:
            full = _host(st.full(comp))
            for j, r in enumerate(st.dp_ranks):
                parts = [full[s:e] for s, e in layout.owner_intervals(j)]
                want = (np.concatenate(parts) if parts
                        else np.zeros(0, np.float32))
                if not np.array_equal(_host(st.shard(r)[comp]), want):
                    self.fail(f"{where}: stage {p} rank {r} {comp} shard "
                              f"does not match zero.Layout reassembly")


# ---------------------------------------------------------------------------
# 1b. kernel consistency (card-vs-CPU parameter consistency, tolerance tiers)
# ---------------------------------------------------------------------------
class KernelConsistencyChecker(InvariantChecker):
    """The card's replacement for the bit-exact parameter twin.

    The hand-written kernels are numerically equivalent but not
    bit-identical to their plain versions (blocked online softmax, chunked
    scan, tensor-core products), so a trace on the card cannot be held to
    float ``==``.  This checker relaxes invariant 1 to the *declared*
    tolerance instead of dropping it:

    * at cluster start, every kernel is spot-checked on the card against its
      ``kernels/ref.py`` plain version under ``kernels.ops.TOLERANCE_TIERS``
      (the corpus in ``kernels/check.py``);
    * a device-flipped twin cluster (a card cluster gets a CPU twin, a CPU
      cluster a card twin; the same initial parameters, the same fast_path)
      receives the identical event/step sequence; structure (layer
      assignment, dataflow shape, stage entries/sizes/dp_ranks) and the
      control-plane recovery-record fields stay EXACT, while losses and the
      master/mu/nu state vectors are compared under a tolerance that grows
      with the optimizer step count — each Adam step can move an element of
      the two runs apart by at most ~2*lr (sign flip of the bounded update)
      plus the forward tolerance, so ``atol = ATOL0 + 2*lr*opt_step``.
      The kernels' backwards differentiate the plain versions, as the
      reference's custom VJPs do.

    Without a visible card the spot check and a CPU cluster's card twin
    raise.  ``loss_within`` and ``param_atol`` state the bounds once, for
    every card-vs-CPU twin that is not driven through this checker.
    """

    name = "kernel-consistency"

    LOSS_RTOL = 1e-4
    LOSS_ATOL = 1e-6
    PARAM_RTOL = 1e-4
    PARAM_ATOL0 = 1e-5

    def __init__(self, spot_check: bool = True):
        self.twin = None
        self.spot_check = spot_check

    @classmethod
    def loss_within(cls, a: float, b: float) -> bool:
        """Loss ``a`` of one device within the bound of ``b`` of the other."""
        return abs(a - b) <= cls.LOSS_ATOL + cls.LOSS_RTOL * abs(b)

    @classmethod
    def param_atol(cls, cl) -> float:
        """The state vectors' atol after ``cl.opt_step`` optimizer steps."""
        return cls.PARAM_ATOL0 + 2.0 * cl.adam.lr * cl.opt_step

    def on_cluster_start(self, runner, cluster):
        if self.spot_check:
            from repro_torch.kernels.check import check_kernels
            for row in check_kernels(seed=0, device="cuda"):
                if not row["within_tolerance"]:
                    self.fail(
                        f"kernel-vs-ref spot check failed: {row['case']} "
                        f"max_abs_err={row['max_abs_err']:.3e} exceeds tier "
                        f"rtol={row['rtol']} atol={row['atol']}")
        self.twin = runner.workload.make_cluster(
            device="cpu" if cluster.device.type == "cuda" else "cuda",
            init_params=(cluster.stem, cluster.layer_params, cluster.head))
        self._compare_state("start", cluster)

    def after_cluster_event(self, step, event, cluster, record):
        twin_rec = self.twin.apply_event(event)
        for k in ("detect", "communicator", "rng_moves"):
            if twin_rec.get(k) != record.get(k):
                self.fail(f"step {step} {event.describe()}: recovery record "
                          f"field {k!r} diverged across devices "
                          f"({record.get(k)!r} vs {twin_rec.get(k)!r})")
        self._compare_state(f"step {step} after {event.describe()}", cluster)

    def after_cluster_step(self, step, cluster, loss):
        twin_loss = self.twin.train_step()
        a, b = float(loss), float(twin_loss)
        if not self.loss_within(a, b):
            self.fail(f"step {step}: loss diverged across devices "
                      f"beyond tolerance ({a!r} vs {b!r})")
        self._compare_state(f"step {step} after train_step", cluster)

    def _compare_state(self, where: str, cl):
        from .statespace import COMPONENTS
        tw = self.twin
        if cl.layer_assignment != tw.layer_assignment:
            self.fail(f"{where}: layer assignment diverged "
                      f"({cl.layer_assignment} vs {tw.layer_assignment})")
        if list(cl.per_rank_mbs) != list(tw.per_rank_mbs):
            self.fail(f"{where}: per-rank micro-batch sizes diverged")
        if list(cl.grad_weights) != list(tw.grad_weights):
            self.fail(f"{where}: gradient weights diverged")
        atol = self.param_atol(cl)
        for p, (st, ts) in enumerate(zip(cl.stages, tw.stages)):
            if (list(st.entries) != list(ts.entries)
                    or list(st.sizes) != list(ts.sizes)
                    or list(st.dp_ranks) != list(ts.dp_ranks)):
                self.fail(f"{where}: stage {p} structure diverged")
            for comp in COMPONENTS:
                a = _host(st.full(comp))
                b = _host(ts.full(comp))
                if not np.allclose(a, b, rtol=self.PARAM_RTOL, atol=atol):
                    err = np.abs(a - b) - atol - self.PARAM_RTOL * np.abs(b)
                    i = int(np.argmax(err))
                    self.fail(
                        f"{where}: stage {p} {comp} diverged across "
                        f"devices beyond tolerance (element {i}: {a[i]!r} vs "
                        f"{b[i]!r}, atol={atol:.3e} after {cl.opt_step} "
                        f"optimizer steps)")


# ---------------------------------------------------------------------------
# 2. dataflow consistency (§4.1)
# ---------------------------------------------------------------------------
class DataflowConsistencyChecker(InvariantChecker):
    """Global batch size and gradient scale preserved across every resize."""

    name = "dataflow-consistency"

    # -- numeric mode ------------------------------------------------------
    def on_cluster_start(self, runner, cluster):
        self._check_cluster("start", cluster)

    def after_cluster_event(self, step, event, cluster, record):
        self._check_cluster(f"step {step} after {event.describe()}", cluster)

    def after_cluster_step(self, step, cluster, loss):
        self._check_cluster(f"step {step}", cluster)

    def _check_cluster(self, where: str, cl):
        gb, nm = cl.global_batch, cl.num_micro
        if sum(cl.per_rank_mbs) * nm != gb:
            self.fail(f"{where}: global batch not preserved — "
                      f"sum(mbs)={sum(cl.per_rank_mbs)} x num_micro={nm} "
                      f"!= {gb}")
        s = float(sum(cl.grad_weights))
        if abs(s - 1.0) > 1e-9:
            self.fail(f"{where}: gradient weights sum to {s!r}, not 1.0")
        per_micro = gb // nm
        for r, (sz, wgt) in enumerate(zip(cl.per_rank_mbs, cl.grad_weights)):
            if abs(wgt - sz / per_micro) > 1e-12:
                self.fail(f"{where}: rank {r} weight {wgt!r} != sample share "
                          f"{sz}/{per_micro}")
        ids = cl.sampler.partition(cl.step_count, cl.per_rank_mbs, nm)
        got = np.sort(np.concatenate([i for rr in ids for i in rr]))
        want = cl.sampler.sample_ids(cl.step_count)
        if not np.array_equal(got, want):
            self.fail(f"{where}: sampler partition does not cover the global "
                      f"batch exactly once")

    # -- analytic mode -----------------------------------------------------
    def on_analytic_start(self, runner, seg, view, comm):
        self._gb0, self._nm0 = view.global_batch, view.num_micro

    def after_analytic_event(self, step, event, view, comm, extra):
        if (view.global_batch, view.num_micro) != (self._gb0, self._nm0):
            self.fail(f"step {step}: event mutated global batch shape "
                      f"({view.global_batch} x {view.num_micro}, was "
                      f"{self._gb0} x {self._nm0})")
        if int(view.stage_width().min()) >= 1:
            from .planners.dataflow import plan_dataflow_view
            try:
                plan_dataflow_view(view)    # validate() asserts exactness
            except AssertionError as e:
                self.fail(f"step {step}: dataflow plan over surviving width "
                          f"violates batch exactness: {e}")

    def after_analytic_decision(self, step, view, decision, throughput,
                                base_throughput):
        if not decision.feasible:
            return
        d = decision.detail
        per_micro = view.global_batch // view.num_micro
        if "mbs_stage" in d and "width" in d:       # elaswave
            for p, (m, wd) in enumerate(zip(d["mbs_stage"], d["width"])):
                if m * wd < per_micro:
                    self.fail(f"step {step}: stage {p} under-covers the "
                              f"per-micro slice ({m} x {wd} < {per_micro})")
        elif {"mbs", "num_micro", "alive_reps"} <= set(d):  # torchft/oobleck
            got = d["mbs"] * d["num_micro"] * d["alive_reps"]
            if got < view.global_batch:
                self.fail(f"step {step}: replica split covers {got} < "
                          f"global batch {view.global_batch}")


# ---------------------------------------------------------------------------
# 3. RNG / computation consistency (§4.4)
# ---------------------------------------------------------------------------
def _normalized_stream_map(cl) -> np.ndarray:
    """``map[sample_offset] -> stream id`` for the cluster's next step, with
    the step's contiguous id base removed.  Content-addressed ("reshard")
    streams make this the identity regardless of rank assignment; the naive
    rank-addressed mode makes it a function of the current dataflow."""
    step = cl.step_count
    base = step * cl.global_batch
    ids_by_rank = cl.sampler.partition(step, cl.per_rank_mbs, cl.num_micro)
    out = np.full(cl.global_batch, -1, dtype=np.int64)
    for m in range(cl.num_micro):
        for r, rank_ids in enumerate(ids_by_rank):
            ids = rank_ids[m]
            if not len(ids):
                continue
            if cl.rng_mode == "reshard":
                sids = ids.astype(np.int64) - base
            else:           # naive: position-in-rank + rank offset
                sids = np.arange(len(ids), dtype=np.int64) + r * 100003
            out[ids - base] = sids
    return out


class RngConsistencyChecker(InvariantChecker):
    """Per-(sample, layer) streams unchanged for surviving work (§4.4)."""

    name = "rng-consistency"

    def on_cluster_start(self, runner, cluster):
        from .planners.rng import verify_equivalence
        self._ref = _normalized_stream_map(cluster)
        L = cluster.cfg.num_layers
        if not verify_equivalence(cluster.base_key, cluster.step_count,
                                  [0, L - 1], [0, 1]):
            self.fail("content-addressed stream keys are not "
                      "owner-independent (key derivation regressed)")

    def after_cluster_event(self, step, event, cluster, record):
        self._check(f"step {step} after {event.describe()}", cluster)

    def after_cluster_step(self, step, cluster, loss):
        self._check(f"step {step}", cluster)

    def _check(self, where: str, cl):
        now = _normalized_stream_map(cl)
        moved = np.flatnonzero(now != self._ref)
        if moved.size:
            o = int(moved[0])
            self.fail(f"{where}: {moved.size}/{now.size} per-sample RNG "
                      f"streams moved under rng_mode={cl.rng_mode!r} (e.g. "
                      f"sample offset {o}: stream {self._ref[o]} -> {now[o]})"
                      f" — computation consistency (§4.4) broken")


# ---------------------------------------------------------------------------
# 4. bounded MTTR / throughput recovery
# ---------------------------------------------------------------------------
class MttrBoundChecker(InvariantChecker):
    """Numeric-mode MTTR: itemized records are internally consistent and the
    committed communicator edit stays within the O(degree) budget."""

    name = "mttr-bound"

    # detection interval bound modeled in VirtualCluster.apply_event
    DETECT_BOUND_S = 0.5
    # links an in-place edit may create per touched rank (ring reconnects on
    # its two hybrid groups), i.e. the "degree" of the O(degree) claim
    LINKS_PER_RANK = 4

    def after_cluster_event(self, step, event, cluster, record):
        parts = sum(record.get(k, 0.0) for k in
                    ("detect", "plan", "communicator", "remap", "migration",
                     "verify"))
        if abs(record.get("total", 0.0) - parts) > 1e-9:
            self.fail(f"step {step} {event.describe()}: MTTR total "
                      f"{record.get('total')!r} != sum of itemized phases "
                      f"{parts!r}")
        if record.get("detect", 0.0) > self.DETECT_BOUND_S + 1e-9:
            self.fail(f"step {step}: detection {record['detect']!r}s exceeds "
                      f"the heartbeat bound {self.DETECT_BOUND_S}s")
        if event.is_shrink or event.is_grow:
            k = max(1, len(event.ranks))
            budget = k * (EDIT_CONST_S
                          + LINK_SETUP_S * self.LINKS_PER_RANK)
            got = record.get("communicator", 0.0)
            if got > budget + 1e-9:
                self.fail(f"step {step} {event.describe()}: communicator "
                          f"edit {got!r}s exceeds the O(degree) budget "
                          f"{budget!r}s for {k} rank(s) — edit cost must not "
                          f"scale with cluster size")


class MttrThroughputChecker(InvariantChecker):
    """Analytic-mode MTTR + throughput recovery.

    * communicator: the runner's ``OpStats`` accounting must equal a
      dict/set ``LegacyDynamicCommunicator`` oracle replaying the same
      ``GroupDelta`` sequence, and the committed edit must stay within the
      O(degree) budget;
    * migration: stall bounded by the un-overlapped transfer time;
    * throughput: policy-contract feasibility, and for every feasible
      decision ``0 < thr <= thr0 * max_freq`` with a pristine view recovering
      ``thr0`` exactly and a degraded view held above the width/straggler
      floor (``floor_slack`` absorbs pipeline-shape rounding, validated
      empirically over the deterministic fuzz corpus).
    """

    name = "mttr-throughput"

    LINKS_PER_RANK = 4

    def __init__(self, floor_slack: float = 8.0):
        self.floor_slack = floor_slack

    def on_analytic_start(self, runner, seg, view, comm):
        from .communicator import build_hybrid_groups
        from .legacy_comm import LegacyDynamicCommunicator
        self._runner = runner
        w = runner.workload
        self._hw = w.hw
        self._oracle = LegacyDynamicCommunicator(
            build_hybrid_groups(w.dp, w.pp))

    def after_analytic_event(self, step, event, view, comm, extra):
        mig = extra.get("migration")
        if mig is not None:
            from .migration import ORCH_OVERHEAD_S
            stall = mig["stall_seconds"]
            orch = ORCH_OVERHEAD_S * max(mig["n_layers"], 1)
            # ceiling: orchestration + fully-unhidden copy + payback grads
            # (2x params at the 20% unhidden fraction); floor: orchestration
            # is never hidden (§6.2)
            hi = orch + 1.4 * mig["param_seconds"] + mig["opt_seconds"]
            if not (orch - 1e-9 <= stall <= hi + 1e-9):
                self.fail(f"step {step}: migration stall {stall!r}s outside "
                          f"[{orch!r}, {hi!r}]s (orch + param/opt copy + "
                          f"payback bound)")
            return
        acct = extra.get("communicator")
        if acct is None:
            return
        delta = self._runner.delta_for_event(event)
        if not event.is_grow:
            for policy, key in (("partial_rebuild", "partial_rebuild_seconds"),
                                ("full_rebuild", "full_rebuild_seconds")):
                want = self._oracle.price(delta, policy).seconds
                if acct.get(key) != want:
                    self.fail(f"step {step} {event.describe()}: {policy} "
                              f"pricing diverged from the legacy oracle "
                              f"({acct.get(key)!r} vs {want!r})")
        edit = self._oracle.apply(delta, "edit").seconds
        if acct["edit_seconds"] != edit:
            self.fail(f"step {step} {event.describe()}: vectorized "
                      f"communicator edit {acct['edit_seconds']!r}s != "
                      f"legacy oracle {edit!r}s")
        k = max(1, len(event.ranks))
        budget = EDIT_CONST_S + LINK_SETUP_S * self.LINKS_PER_RANK * k
        if acct["edit_seconds"] > budget + 1e-9:
            self.fail(f"step {step} {event.describe()}: edit "
                      f"{acct['edit_seconds']!r}s exceeds the O(degree) "
                      f"budget {budget!r}s for {k} rank(s)")

    def after_analytic_decision(self, step, view, decision, throughput,
                                base_throughput):
        min_width = int(view.stage_width().min())
        if decision.name == "elaswave" and min_width >= 1 \
                and not decision.feasible:
            self.fail(f"step {step}: elaswave infeasible although every "
                      f"stage keeps >= 1 replica (detail={decision.detail})")
        if decision.name == "torchft":
            expect = bool(view.alive.all(axis=1).any())
            if bool(decision.feasible) != expect:
                self.fail(f"step {step}: torchft feasibility "
                          f"{decision.feasible} != fully-alive-replica "
                          f"predicate {expect}")
        if not decision.feasible:
            return
        thr, thr0 = throughput, base_throughput
        if not (thr > 0.0 and np.isfinite(thr)):
            self.fail(f"step {step}: feasible decision with non-positive "
                      f"throughput {thr!r}")
        cap = thr0 * self._hw.max_freq * (1.0 + 1e-6)
        if thr > cap:
            self.fail(f"step {step}: throughput {thr!r} exceeds the "
                      f"DVFS-capped bound {cap!r} (thr0 x max_freq)")
        alive = view.rank_alive
        pristine = (bool(alive.all())
                    and bool((view.rank_slow == 1.0).all())
                    and bool((view.rank_freq == 1.0).all()))
        if pristine:
            if abs(thr - thr0) > 1e-9 * max(thr0, 1.0):
                self.fail(f"step {step}: pristine cluster did not recover "
                          f"base throughput ({thr!r} vs {thr0!r})")
            return
        if not alive.any():
            return
        max_slow = float(view.rank_slow[alive].max())
        min_freq = min(1.0, float(view.rank_freq[alive].min()))
        floor = (thr0 * (min_width / view.dp) * min_freq
                 / (max_slow * self.floor_slack))
        if thr < floor:
            self.fail(f"step {step}: recovered throughput {thr!r} below the "
                      f"floor {floor!r} (min_width={min_width}/{view.dp}, "
                      f"max_slow={max_slow}, slack={self.floor_slack}) — "
                      f"throughput did not recover after the event")


def default_cluster_checkers(device=None) -> List[InvariantChecker]:
    """The four paper guarantees for numeric (VirtualCluster) traces on
    ``device``, the card by default (the reference's ``use_pallas``).

    On the card, the tolerance-tier :class:`KernelConsistencyChecker`
    (card/CPU twin) holds invariant 1, relaxed to the kernels' declared
    tolerance; on the CPU the bit-exact fast/seed
    :class:`ParameterConsistencyChecker` does (its twin raises
    ``NotImplementedError`` until the seed path is ported).  The other
    three are unchanged."""
    on_card = device is None or str(device).startswith("cuda")
    param: InvariantChecker = (KernelConsistencyChecker() if on_card
                               else ParameterConsistencyChecker())
    return [param, DataflowConsistencyChecker(),
            RngConsistencyChecker(), MttrBoundChecker()]


def default_analytic_checkers() -> List[InvariantChecker]:
    """The analytic-plane guarantees (dataflow + MTTR/throughput)."""
    return [DataflowConsistencyChecker(), MttrThroughputChecker()]
