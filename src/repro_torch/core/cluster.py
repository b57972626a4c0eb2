"""VirtualCluster — the elastic train step of ElasWave, in PyTorch.

An in-process cluster of virtual workers arranged as a DP x PP grid, mirroring
the fast path of ``repro.core.cluster.VirtualCluster``, for the families the
port runs (dense attention blocks and Mamba2 blocks; it reaches them through
``models/registry.py``):

* per-layer parameters owned by pipeline stages (dicts of tensors);
* ZeRO-1 optimizer shards per (stage, dp-rank) under contiguous or
  interleaved layouts, on the flat-state backbone (``core/statespace.py``):
  one contiguous fp32 tensor per component per stage, on the device;
* one fused-AdamW kernel launch per stage per step over those buffers;
* per-step ring snapshots to host memory (``core/fabric/snapshot.py``);
* the recovery half and its control plane, as the reference's fast path:
  probes -> ``Agent``/``ElasticController`` -> ``ScheduleEngine`` plan ->
  snapshot verify -> communicator edit (``core/communicator.py``) -> live
  remap (``core/fabric/remap.py``) -> layer migration -> dataflow resize.
  Stage state never leaves the device: remap and migration slice, assemble
  and check (``torch.equal``) the flat buffers where they live; only the
  ring snapshot is host memory.  The control plane is numpy, as the
  reference's, so plans, records and remap tables equal the reference's;
  the record's seconds are the reference's modeled costs (``plan`` is the
  planner's measured wall clock).

Gradients are computed over the *full* model per micro-batch item (the
logically-centralized equivalent of the pipeline's math) and accumulated in
the seed's (micro, rank) order, so the loss trajectory can be held against
the JAX package's.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises if
no card is visible.  Float32 matrix products run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``, set on construction), as
the reference leaves them to XLA.

Dropout draws the reference's masks bit for bit: the key chain is
``fold_in(key(seed), step)``, then layer, op and sample id
(``models/layers.py``), with each item's global sample ids under
``rng_mode="reshard"`` and rank-addressed ids (``arange(B) + rank*100003``,
the paper's "w/o RNG resharding") under ``"naive"``.

Not yet ported, and raising ``NotImplementedError``: the seed path
(``fast_path=False``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import GlobalBatchSampler, materialize_samples
from repro_torch.kernels.threefry import fold_in, key_from_seed
from repro_torch.models import registry as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RngCtx
from repro_torch.models.transformer import softmax_xent
from repro_torch.optim.adam import AdamConfig, adam_update_flat_
from repro_torch.weights import params_from_numpy
from .agent import Agent, Probe
from .clusterview import ClusterView, GroupDelta
from .communicator import DynamicCommunicator, build_hybrid_groups
from .controller import ElasticController
from .cost_model import HardwareSpec, SegmentCosts
from .engine import RecoveryPlan, ScheduleEngine
from .events import ElasticEvent, EventKind
from .fabric.remap import LiveRemap, RemapPlan
from .fabric.snapshot import SnapshotPool
from .migration import MigrationSpec, migration_timing
from .pipeline import StageTiming, simulate_1f1b
from .planners.dataflow import plan_dataflow
from .planners.graph import minimax_layer_partition
from .statespace import (COMPONENTS, HEAD, STEM, EntryFlattener, StageState,
                         flatten_leaves, get_table, tree_leaves)


def _recovery_record(*, detect: float = 0.0, plan: float = 0.0,
                     communicator: float = 0.0, remap: float = 0.0,
                     migration: float = 0.0, verify: float = 0.0,
                     rng_moves: int = 0, degraded: int = 0,
                     overlap_saved: float = 0.0) -> Dict[str, float]:
    """One schema for every recovery record, regardless of event kind.

    ``verify`` (snapshot integrity scan) is a phase included in the total;
    ``degraded`` counts tolerance-tier shard rebuilds (zeroed Adam moments)
    and ``overlap_saved`` is stall hidden inside a preemption-notice window
    — info counters, not stall time, so they stay out of the total."""
    return {"detect": detect, "plan": plan, "communicator": communicator,
            "remap": remap, "migration": migration, "verify": verify,
            "total": detect + plan + communicator + remap + migration + verify,
            "rng_moves": rng_moves, "degraded": degraded,
            "overlap_saved": overlap_saved}


def resolve_device(device) -> torch.device:
    """``None`` -> the card; raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "VirtualCluster runs on the card by default and no CUDA device "
            "is available; pass device='cpu' to run the plain versions")
    return dev


class VirtualCluster:
    def __init__(self, cfg: ModelConfig, dp: int, pp: int, *,
                 global_batch: int, num_micro: int, seq_len: int,
                 seed: int = 0, zero_layout: str = "interleaved",
                 adam: Optional[AdamConfig] = None,
                 rng_mode: str = "reshard",        # "reshard" | "naive"
                 hw: Optional[HardwareSpec] = None,
                 mem_cap: Optional[float] = None,
                 snapshot_enabled: bool = True,
                 non_blocking_migration: bool = True,
                 fast_path: bool = True,
                 device=None,
                 init_params: Optional[Tuple[Any, List[Any], Any]] = None):
        assert global_batch % num_micro == 0
        assert (global_batch // num_micro) % dp == 0, "initial even split"
        if not fast_path:
            raise NotImplementedError(
                "fast_path=False (the seed per-item loops) is not ported; "
                "the JAX package stays the seed-path oracle")
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.dp0, self.pp = dp, pp
        self.global_batch, self.num_micro, self.seq = global_batch, num_micro, seq_len
        self.adam = adam or AdamConfig(master_weights=True)
        self.rng_mode = rng_mode
        self.hw = hw or HardwareSpec()
        self.zero_layout = zero_layout
        self.snapshot_enabled = snapshot_enabled
        self.non_blocking_migration = non_blocking_migration
        self.fast_path = fast_path
        self.sampler = GlobalBatchSampler(global_batch, seed)
        self.base_key = key_from_seed(seed)

        # ---- model state ----
        L = cfg.num_layers
        if init_params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            self.stem = R.init_stem(gen, cfg)
            self.layer_params: List[Any] = [R.init_layer(gen, cfg, i)
                                            for i in range(L)]
            self.head = R.init_head(gen, cfg)
        else:
            self.stem, self.layer_params, self.head = params_from_numpy(
                *init_params, device=self.device)
        # model-flat leaf order == ravel_pytree((stem, layers, head))
        self._leaves = tree_leaves((self.stem, self.layer_params, self.head))
        for leaf in self._leaves:
            leaf.requires_grad_(True)
        self.flattener = EntryFlattener()
        # balanced initial layer assignment
        per = L // pp
        rem = L % pp
        ranges, a = [], 0
        for p in range(pp):
            b = a + per + (1 if p < rem else 0) - 1
            ranges.append((a, b))
            a = b + 1
        self.layer_assignment: List[Tuple[int, int]] = ranges

        # ---- workers / health ----
        self.alive = np.ones((dp, pp), dtype=bool)
        self.freq = np.ones((dp, pp))
        self.slow = np.ones((dp, pp))
        self.mem_used = np.zeros((dp, pp))   # fraction of capacity (probes)

        # ---- ZeRO stage states + snapshots ----
        self.stages: List[StageState] = []
        self.snapshots: List[SnapshotPool] = []
        for p in range(pp):
            st = self._build_stage_state(p, list(range(dp)))
            self.stages.append(st)
            pool = SnapshotPool(dp, self.adam)
            if snapshot_enabled:
                pool.bootstrap(0, [st.shard(r) for r in st.dp_ranks])
            self.snapshots.append(pool)

        # ---- control plane (numpy, as the reference's) ----
        self.comm = DynamicCommunicator(build_hybrid_groups(dp, pp))
        # rank = d * pp + p, so the agent's stage topology is rank % pp
        self.agent = Agent(dp * pp,
                           stage_of={r: r % pp for r in range(dp * pp)})
        self.controller = ElasticController(self.agent)
        self.engine = ScheduleEngine(cfg, seq_len, self.hw, mem_cap)
        self.remapper = LiveRemap()

        # ---- bookkeeping ----
        self.step_count = 0
        self.opt_step = 0
        self.per_rank_mbs: List[int] = [global_batch // num_micro // dp] * dp
        self.grad_weights: List[float] = [1.0 / dp] * dp
        self.losses: List[float] = []
        self.recoveries: List[Dict[str, float]] = []
        self.warnings: List[ElasticEvent] = []   # advisory (OOM_RISK) events
        self.seg = SegmentCosts.build(cfg, seq_len, self.hw)
        # host seconds of each step's ring-snapshot update (host Adam + CRC)
        self.snapshot_seconds: List[float] = []

    # ------------------------------------------------------------------
    # state-space helpers
    # ------------------------------------------------------------------
    def _entry_tree(self, entry: int):
        if entry == STEM:
            return self.stem
        if entry == HEAD:
            return self.head
        return self.layer_params[entry]

    def _stage_entries(self, p: int) -> List[int]:
        a, b = self.layer_assignment[p]
        entries = list(range(a, b + 1))
        if p == 0:
            entries = [STEM] + entries
        if p == self.pp - 1:
            entries = entries + [HEAD]
        return entries

    def _build_stage_state(self, p: int, dp_ranks: List[int]) -> StageState:
        entries = self._stage_entries(p)
        with torch.no_grad():
            vecs = [self.flattener.flatten_entry(e, self._entry_tree(e))
                    for e in entries]
        sizes = [v.numel() for v in vecs]
        full = torch.cat(vecs) if vecs else torch.zeros(0, device=self.device)
        del vecs
        return StageState.from_full(
            entries, sizes, self.zero_layout, dp_ranks,
            {"master": full, "mu": torch.zeros_like(full),
             "nu": torch.zeros_like(full)})

    def _write_params_from_masters(self):
        """Scatter each stage's masters back to stage-space order on the
        device and copy them into the parameters in place (cast to each
        leaf's dtype)."""
        for st in self.stages:
            full = st.full("master")
            tbl = st.table
            for pos, e in enumerate(st.entries):
                s_, e_ = tbl.layer_interval(pos)
                self.flattener.write_entry(e, full[s_:e_])

    # ------------------------------------------------------------------
    # training math
    # ------------------------------------------------------------------
    def _loss_fn(self, stem, layers, head, tokens, labels, ctx: RngCtx):
        cfg = self.cfg
        x = R.apply_stem(stem, cfg, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lid in range(cfg.num_layers):
            x, aux = R.apply_layer(layers[lid], cfg, lid, x, positions, ctx)
            aux_total = aux_total + aux
        logits = R.apply_head(head, cfg, x)
        return softmax_xent(logits[:, :-1], labels[:, 1:]) + aux_total

    def _micro_grads(self, step: int) -> Tuple[float, torch.Tensor]:
        """Weighted accumulation over micro-batches and DP slices — the
        numerics of dataflow-resized hybrid-parallel training.

        A plain loop over items in the seed's (micro, rank) order, one
        ``torch.autograd.grad`` per item, each item's gradient flattened to
        fp32 in model-flat order and accumulated on the device.  The update
        ``acc += flat * w`` runs in place (two separately rounded fp32 ops,
        the same bits as the reference's ``acc = acc + flat * w``).
        Returns ``(total_loss, model-flat gradient)``.
        """
        ids_by_rank = self.sampler.partition(step, self.per_rank_mbs,
                                             self.num_micro)
        items: List[Tuple[int, np.ndarray]] = []    # (rank, ids), seed order
        for m in range(self.num_micro):
            for r, rank_ids in enumerate(ids_by_rank):
                ids = rank_ids[m]
                if len(ids):
                    items.append((r, ids))
        n_flat = sum(x.numel() for x in self._leaves)
        acc = torch.empty(n_flat, dtype=torch.float32, device=self.device)
        flat = torch.empty_like(acc)
        total_loss = 0.0
        deterministic = self.cfg.dropout_rate <= 0.0
        step_key = fold_in(self.base_key, step)
        for k, (r, ids) in enumerate(items):
            toks = torch.from_numpy(materialize_samples(
                ids, self.seq, self.cfg.vocab_size)).to(self.device)
            sids = None
            if not deterministic:
                if self.rng_mode == "reshard":
                    sids = ids.astype(np.int32)
                else:   # naive: rank-addressed streams (the paper's "w/o")
                    sids = np.arange(len(ids), dtype=np.int32) \
                        + np.int32(r * 100003)
                sids = torch.from_numpy(sids).to(self.device)
            ctx = RngCtx(step_key=step_key, sample_ids=sids,
                         deterministic=deterministic)
            loss = self._loss_fn(self.stem, self.layer_params, self.head,
                                 toks, toks, ctx)
            grads = torch.autograd.grad(loss, self._leaves)
            flatten_leaves(grads, out=flat)
            del grads
            w = self.grad_weights[r] / self.num_micro
            w32 = float(np.float32(w))
            if k == 0:
                torch.mul(flat, w32, out=acc)
            else:
                acc.add_(flat.mul_(w32))
            total_loss += float(loss.detach()) * w
        return total_loss, acc

    def train_step(self) -> float:
        """One elastic training step.  Per stage, the gradient is gathered to
        shard order and ONE fused-AdamW kernel launch updates the stage's flat
        buffers in place on the card; the gradient shards then cross to the
        host once (one copy per stage) for the ring snapshot."""
        step = self.step_count
        loss, gflat = self._micro_grads(step)
        self.opt_step += 1
        grad_shard_by_stage: List[List[np.ndarray]] = []
        off = 0
        for st in self.stages:
            gshard = st.table.gather(gflat[off:off + st.total])
            off += st.total
            if st.total:
                adam_update_flat_(gshard, st.flat, self.opt_step, self.adam)
            if self.snapshot_enabled:
                grad_shard_by_stage.append(
                    st.table.split(gshard.cpu().numpy()))
            del gshard
        del gflat
        self._write_params_from_masters()
        if self.snapshot_enabled:
            t0 = time.perf_counter()
            for p in range(self.pp):
                self.snapshots[p].snapshot_step(step, grad_shard_by_stage[p],
                                                self.opt_step)
            self.snapshot_seconds.append(time.perf_counter() - t0)
        self.step_count += 1
        self.losses.append(loss)
        return loss

    def run(self, steps: int) -> List[float]:
        return [self.train_step() for _ in range(steps)]

    # ------------------------------------------------------------------
    # timing model (modeled seconds, from the HardwareSpec)
    # ------------------------------------------------------------------
    def simulate_step_time(self) -> float:
        stages = []
        per_micro = self.global_batch // self.num_micro
        for p, (a, b) in enumerate(self.layer_assignment):
            live = [d for d in range(self.dp0) if self.alive[d, p]]
            width = max(len(live), 1)
            mbs = -(-per_micro // width)
            worst = max((self.slow[d, p] / self.freq[d, p] for d in live),
                        default=1.0)
            eff = self.hw.peak_flops * self.hw.mfu / worst
            fl = self.seg.seg_fwd_flops(a, b, mbs)
            stages.append(StageTiming(fl / eff, 2 * fl / eff, self.num_micro))
        return simulate_1f1b(stages).step_time

    # ------------------------------------------------------------------
    # elasticity
    # ------------------------------------------------------------------
    def inject_fail_stop(self, d: int, p: int):
        self.alive[d, p] = False

    def inject_fail_slow(self, d: int, p: int, factor: float):
        self.slow[d, p] = factor

    def inject_mem_pressure(self, d: int, p: int, used_fraction: float):
        """Set the fraction of device memory worker (d, p) reports via its
        probes — feeds the Agent's OOM early-warning trend."""
        self.mem_used[d, p] = used_fraction

    def detect_and_recover(self) -> Optional[Dict[str, float]]:
        """Controller probes -> events -> ScheduleEngine plan -> executor.

        The loop bound is the controller's worst-case confirmation threshold
        (``max_confirm_misses``): a rank that flapped earlier has an
        exponentially backed-off bar to clear."""
        probes = []
        base_t = self.simulate_step_time()
        for d in range(self.dp0):
            for p in range(self.pp):
                rank = d * self.pp + p
                probes.append(Probe(self.step_count, rank,
                                    heartbeat=bool(self.alive[d, p]),
                                    step_seconds=base_t * self.slow[d, p],
                                    mem_used=float(self.mem_used[d, p])))
        events: List[ElasticEvent] = []
        for _ in range(self.controller.max_confirm_misses()):
            events = self.controller.observe(probes)
            if events:
                break
        if not events:
            return None
        return self.apply_event(events[0])

    def apply_event(self, ev: ElasticEvent) -> Dict[str, float]:
        """Recovery Executor entry point: one elastic event -> itemized MTTR.

        Multi-rank events (failure bursts) are applied as a deterministic
        rank-ordered sequence of single-rank recoveries; detection is paid
        once and the control-plane phases accumulate."""
        t_detect = 0.5  # heartbeat interval bound (modeled)
        cells = [(r // self.pp, r % self.pp) for r in sorted(ev.ranks)]
        if ev.kind in (EventKind.FAIL_STOP, EventKind.SCALE_IN):
            return _merge_recovery_records([
                self.recover_fail_stop(d, p,
                                       t_detect=t_detect if i == 0 else 0.0)
                for i, (d, p) in enumerate(cells)])
        if ev.kind == EventKind.FAIL_SLOW:
            return _merge_recovery_records([
                self.recover_fail_slow(d, p, ev.slow_factor,
                                       t_detect=t_detect if i == 0 else 0.0)
                for i, (d, p) in enumerate(cells)])
        if ev.kind == EventKind.PREEMPT_NOTICE:
            # proactive drain: no detection phase (the scheduler TOLD us),
            # and recovery work overlaps the notice window
            return _merge_recovery_records([
                self.drain_rank(d, p, deadline=ev.deadline)
                for d, p in cells])
        if ev.kind == EventKind.SCALE_OUT:
            return _merge_recovery_records([
                self.recover_scale_out(d, p) for d, p in cells])
        if ev.kind == EventKind.DVFS_SET:
            for d, p in cells:
                self.freq[d, p] = ev.freq
            return _recovery_record()
        if ev.kind == EventKind.OOM_RISK:
            # advisory: record the warning, no state or liveness change
            self.warnings.append(ev)
            return _recovery_record()
        raise ValueError(f"unsupported elastic event kind here: {ev.kind}")

    def build_view(self) -> ClusterView:
        """The cluster's health/topology state as a ``ClusterView``; its
        buffers alias ``self.alive``/``self.freq``/``self.slow``."""
        return ClusterView(self.dp0, self.pp, self.global_batch,
                           self.num_micro, self.seq,
                           list(self.layer_assignment),
                           alive=self.alive, freq=self.freq, slow=self.slow,
                           mem_cap=self.engine.mem_cap)

    def plan_event(self, ev: ElasticEvent) -> RecoveryPlan:
        """Mark the event's (single) rank dead and ask the ScheduleEngine for
        a joint Dataflow/Graph/DVFS/RNG RecoveryPlan (paper §4)."""
        rank = ev.ranks[0]
        d, p = rank // self.pp, rank % self.pp
        st = self.stages[p]
        if d not in st.dp_ranks:
            raise ValueError(
                f"rank {rank} (dp={d}, stage={p}) was already removed from "
                f"the stage's DP group; scenario traces must not re-fail a "
                f"recovered rank")
        self.alive[d, p] = False
        old_sample_rank = self._current_sample_assignment()
        return self.engine.plan_view(
            ev, self.build_view(), failed_dp_ranks=[d],
            old_sample_rank=old_sample_rank, dp=len(st.dp_ranks))

    def recover_fail_stop(self, d: int, p: int, t_detect: float = 0.5,
                          ) -> Dict[str, float]:
        """Full ElasWave recovery: plan + communicator edit + live remap +
        layer migration + dataflow/DVFS/RNG application."""
        ev = ElasticEvent(EventKind.FAIL_STOP, self.step_count,
                          (d * self.pp + p,))
        return self.apply_plan(self.plan_event(ev), t_detect=t_detect)

    def apply_plan(self, plan: RecoveryPlan, t_detect: float = 0.5,
                   drain: bool = False) -> Dict[str, float]:
        """Execute a shrink RecoveryPlan: snapshot verification,
        communicator edit, live remap, layer migration, dataflow resize,
        DVFS top-up.  Returns the itemized (modeled) MTTR record.

        ``drain=True`` is the proactive PREEMPT_NOTICE path: the departing
        rank's device state is still addressable (corrupt snapshots
        re-derive from it bit-for-bit), and the communicator/remap/migration
        work overlaps the notice window — only the part exceeding
        ``plan.event.deadline`` stalls training; the hidden part is recorded
        as ``overlap_saved``."""
        ev = plan.event
        rank = ev.ranks[0]
        d, p = rank // self.pp, rank % self.pp
        t_verify, n_degraded = self._verify_snapshot_sources(
            p, failed=[d], drain=drain)
        comm_stats = self.comm.apply(GroupDelta.shrink([d * self.pp + p]),
                                     "edit")
        t_remap, _remap_plan = self._live_remap_stage(p, failed=[d])
        t_migr = 0.0
        if plan.graph.feasible and plan.migrations:
            t_migr = self._apply_migrations(plan.migrations,
                                            list(plan.graph.stage_ranges))
        self._apply_dataflow()
        for dv in plan.dvfs:
            if dv.rank >= 0:
                for dd in range(self.dp0):
                    if self.alive[dd, dv.rank]:
                        self.freq[dd, dv.rank] = max(self.freq[dd, dv.rank],
                                                     dv.freq)
        # the departed rank leaves the Agent's monitored set (a SCALE_OUT
        # rejoin re-registers it)
        self.agent.remove_rank(rank)

        # --- overlap accounting (proactive drain only) ---
        t_comm = comm_stats.seconds
        overlap_saved = 0.0
        work = t_comm + t_remap + t_migr
        if drain and work > 0:
            stall = max(0.0, work - ev.deadline)
            scale = stall / work
            overlap_saved = work - stall
            t_comm *= scale
            t_remap *= scale
            t_migr *= scale

        rec = _recovery_record(
            detect=t_detect, plan=plan.plan_seconds,
            communicator=t_comm, remap=t_remap, migration=t_migr,
            verify=t_verify,
            rng_moves=len(plan.rng.layer_stream_moves)
            + len(plan.rng.sample_stream_moves),
            degraded=n_degraded, overlap_saved=overlap_saved)
        self.recoveries.append(rec)
        return rec

    def drain_rank(self, d: int, p: int, deadline: float = 120.0,
                   ) -> Dict[str, float]:
        """Proactive drain on PREEMPT_NOTICE: the full shrink recovery,
        inside the notice window.  Detection cost is zero and up to
        ``deadline`` seconds of recovery work overlap ongoing training."""
        ev = ElasticEvent(EventKind.PREEMPT_NOTICE, self.step_count,
                          (d * self.pp + p,), deadline=deadline)
        return self.apply_plan(self.plan_event(ev), t_detect=0.0, drain=True)

    def _verify_snapshot_sources(self, p: int, failed: List[int],
                                 drain: bool = False) -> Tuple[float, int]:
        """Online verification (paper §5.1) of the ring-snapshot shards the
        remap is about to trust, with graceful degradation: intact ->
        ``verified``; corrupt + rank draining -> ``rederived`` from its
        device shard; corrupt + rank dead -> ``rebuilt`` from the model
        parameters with zeroed Adam moments (counted as degraded).  Repairs
        land in ``pool.host`` before ``_live_remap_stage`` reads it.
        Returns (modeled verify seconds, degraded-shard count)."""
        if not self.snapshot_enabled:
            return 0.0, 0
        st = self.stages[p]
        pool = self.snapshots[p]
        if not pool.integrity:
            return 0.0, 0
        t_verify, degraded = 0.0, 0
        old_ranks = list(st.dp_ranks)
        for f in failed:
            j = old_ranks.index(f)
            if pool.host[pool.holder_of(j)] is None:
                continue    # holder dead: remap skips this source anyway
            t_verify += pool.verify_cost_seconds(j)
            tier, _ = pool.verify_and_repair(
                j,
                device_state=st.shard(f) if drain else None,
                master_fallback=None if drain else
                (lambda jj=j: self._master_shard_from_params(p, jj)))
            if tier == "rebuilt":
                degraded += 1
        return t_verify, degraded

    def _master_shard_from_params(self, p: int, j: int) -> torch.Tensor:
        """Tolerance-tier rebuild source: shard ``j`` of stage ``p``'s fp32
        master, regenerated on the device from the model parameters (equal
        to the masters bit for bit where the leaves are fp32)."""
        st = self.stages[p]
        with torch.no_grad():
            vecs = [self.flattener.flatten_entry(e, self._entry_tree(e))
                    for e in st.entries]
        full = torch.cat(vecs) if vecs else \
            torch.zeros(0, dtype=torch.float32, device=self.device)
        return st.table.shard_view(st.table.gather(full), j)

    def recover_scale_out(self, d: int, p: int) -> Dict[str, float]:
        """Worker (d, p) (re)joins: communicator edit (only the new member's
        links), reverse live remap widening the stage's ZeRO group, dataflow
        resize back to the wider DP width."""
        assert not self.alive[d, p], "worker already alive"
        self.alive[d, p] = True
        rank = d * self.pp + p
        self.agent.add_rank(rank, stage=p)
        self.controller.note_join(rank)
        comm_stats = self.comm.apply(
            GroupDelta.grow([(g, rank) for g in self.comm.groups
                             if g == f"dp_stage{p}_tp0"]), "edit")
        t_remap = self._widen_stage(p, joining=[d])
        self._apply_dataflow()
        rec = _recovery_record(communicator=comm_stats.seconds, remap=t_remap)
        self.recoveries.append(rec)
        return rec

    def _widen_stage(self, p: int, joining: List[int]) -> float:
        """Reverse remap: redistribute the stage state over a WIDER group,
        from the current owners' device shards."""
        st = self.stages[p]
        old_ranks = list(st.dp_ranks)
        tbl = st.table
        new_ranks = old_ranks + [j for j in joining if j not in old_ranks]
        pre = {c: st.full(c) for c in COMPONENTS}
        device_parts = {r: tbl.owner_intervals(old_ranks.index(r))
                        for r in old_ranks}
        new_tbl = get_table(st.layout_kind, st.sizes, len(new_ranks))
        target_parts = {r: new_tbl.owner_intervals(j)
                        for j, r in enumerate(new_ranks)}
        plan = self.remapper.compute_plan(st.total, device_parts, {},
                                          target_parts)
        self._remap_into(st, plan, old_ranks, new_ranks, {})
        self._check_remap(st, pre, "widen")
        self._rebootstrap(p)
        return plan.est_seconds

    def recover_fail_slow(self, d: int, p: int, factor: float,
                          t_detect: float = 0.5) -> Dict[str, float]:
        """Straggler mitigation: rebalance layers away from the slow stage
        (no state loss)."""
        self.slow[d, p] = max(self.slow[d, p], factor)
        per_micro = self.global_batch // self.num_micro

        def t(pp_, a, b):
            live = [dd for dd in range(self.dp0) if self.alive[dd, pp_]]
            width = max(len(live), 1)
            mbs = -(-per_micro // width)
            worst = max((self.slow[dd, pp_] for dd in live), default=1.0)
            fl = self.seg.seg_fwd_flops(a, b, mbs)
            return 3 * fl / (self.hw.peak_flops * self.hw.mfu / worst)

        def mem(pp_, a, b):
            return self.seg.seg_mem(a, b, per_micro, inflight=self.pp)

        plan = minimax_layer_partition(self.cfg.num_layers, self.pp, t, mem,
                                       [self.engine.mem_cap] * self.pp)
        t_migr = 0.0
        if plan.feasible:
            old_stage = _stage_of(self.layer_assignment, self.cfg.num_layers)
            new_stage = _stage_of(plan.stage_ranges, self.cfg.num_layers)
            moves = [(lid, old_stage[lid], new_stage[lid])
                     for lid in range(self.cfg.num_layers)
                     if old_stage[lid] != new_stage[lid]]
            if moves:
                t_migr = self._apply_migrations(moves, list(plan.stage_ranges))
        rec = _recovery_record(detect=t_detect, migration=t_migr)
        self.recoveries.append(rec)
        return rec

    # ------------------------------------------------------------------
    # executor pieces
    # ------------------------------------------------------------------
    def _current_sample_assignment(self) -> Dict[int, int]:
        out, cursor = {}, 0
        for r, sz in enumerate(self.per_rank_mbs):
            for _ in range(sz):
                out[cursor] = r
                cursor += 1
        return out

    def _apply_dataflow(self):
        # width of the narrowest stage defines surviving DP for data entry
        widths = [int(self.alive[:, p].sum()) for p in range(self.pp)]
        df = plan_dataflow(self.global_batch, self.num_micro,
                           max(min(widths), 1))
        self.per_rank_mbs = list(df.micro_batch_sizes)
        self.grad_weights = list(df.grad_weights)

    def _remap_into(self, st: StageState, plan: RemapPlan,
                    old_ranks: List[int], new_ranks: List[int],
                    host_segments: Dict[int, Dict[str, np.ndarray]]) -> None:
        """Execute ``plan`` per component on the device and adopt the new
        DP group: device sources are views of the surviving ranks' shards,
        ``host_segments[f][comp]`` the ring copy of failed rank ``f``."""
        tbl = st.table
        empty = torch.zeros(0, dtype=torch.float32, device=self.device)
        new_shards: Dict[int, Dict[str, torch.Tensor]] = \
            {r: {} for r in new_ranks}
        for comp in COMPONENTS:
            device_data = {
                r: tbl.segments(old_ranks.index(r),
                                tbl.shard_view(st.flat[comp],
                                               old_ranks.index(r)))
                for r in old_ranks if r in new_ranks}
            host_data = {f: tbl.segments(old_ranks.index(f), snap[comp])
                         for f, snap in host_segments.items()}
            assembled = self.remapper.execute(plan, st.total, device_data,
                                              host_data, device=self.device)
            del device_data, host_data
            for r in new_ranks:
                new_shards[r][comp] = assembled.get(r, empty)
            del assembled
        st.replace_shards(new_ranks, new_shards)

    def _check_remap(self, st: StageState, pre: Dict[str, torch.Tensor],
                     what: str) -> None:
        """Online verification before resume: the stage's full vectors are
        unchanged, bit for bit, on the device."""
        for comp in COMPONENTS:
            if not torch.equal(st.full(comp), pre[comp]):
                raise AssertionError(f"{what} corrupted {comp}")

    def _rebootstrap(self, p: int) -> None:
        """A fresh ring snapshot pool for stage ``p``'s current DP group."""
        st = self.stages[p]
        self.snapshots[p] = SnapshotPool(len(st.dp_ranks), self.adam)
        if self.snapshot_enabled:
            self.snapshots[p].bootstrap(self.step_count,
                                        [st.shard(r) for r in st.dp_ranks])

    def _live_remap_stage(self, p: int, failed: List[int],
                          ) -> Tuple[float, RemapPlan]:
        st = self.stages[p]
        pool = self.snapshots[p]
        tbl = st.table
        old_ranks = list(st.dp_ranks)
        # pre-failure full vectors, for the exactness check
        pre = {c: self._stage_full_vec_with_snapshots(p, c, failed)
               for c in COMPONENTS}
        surviving = [r for r in old_ranks if r not in failed]
        device_parts = {r: tbl.owner_intervals(old_ranks.index(r))
                        for r in surviving}
        host_parts = {}
        host_segments: Dict[int, Dict[str, np.ndarray]] = {}
        for f in failed:
            holder = pool.holder_of(old_ranks.index(f))
            snap = pool.host[holder]
            if old_ranks[holder] in surviving and snap is not None:
                host_parts[f] = tbl.owner_intervals(old_ranks.index(f))
            if snap is not None:
                host_segments[f] = snap
        new_tbl = get_table(st.layout_kind, st.sizes, len(surviving))
        target_parts = {r: new_tbl.owner_intervals(j)
                        for j, r in enumerate(surviving)}
        plan = self.remapper.compute_plan(st.total, device_parts, host_parts,
                                          target_parts)
        self._remap_into(st, plan, old_ranks, surviving, host_segments)
        self._check_remap(st, pre, "remap")
        del pre
        self._rebootstrap(p)
        return plan.est_seconds, plan

    def _stage_full_vec_with_snapshots(self, p: int, comp: str,
                                       failed: List[int]) -> torch.Tensor:
        """Pre-failure ground truth on the device: survivors' device state +
        failed ranks' snapshot state (copied up from the host ring)."""
        st = self.stages[p]
        pool = self.snapshots[p]
        tbl = st.table
        full = torch.zeros(st.total, dtype=torch.float32, device=self.device)
        for j, r in enumerate(st.dp_ranks):
            if r not in failed:
                src = tbl.shard_view(st.flat[comp], j)
            else:
                snap = pool.host[pool.holder_of(j)]
                if snap is None:
                    continue
                src = torch.from_numpy(snap[comp]).to(self.device)
            tbl.scatter_shard(j, src, full)
        return full

    def _apply_migrations(self, moves: List[Tuple[int, int, int]],
                          new_ranges: List[Tuple[int, int]]) -> float:
        """Move layers between stages: optimizer-state slices (per layout) +
        parameter ownership.  Returns modeled stall seconds (MTTR).

        Only the stages whose entry list changes are rebuilt, on the device,
        from one scatter per component per affected stage.  The parameters
        themselves stay where they are (the flattener writes each entry back
        by id, whichever stage owns it)."""
        total_stall = 0.0
        step_window = self.simulate_step_time()
        for (lid, src, dst) in moves:
            spec = MigrationSpec((lid,), src, dst,
                                 int(self.seg.param_bytes[lid]),
                                 int(self.seg.opt_bytes[lid]),
                                 dp=len(self.stages[src].dp_ranks),
                                 zero_layout=self.zero_layout,
                                 blocking=not self.non_blocking_migration)
            total_stall += migration_timing(spec, self.hw.link_bw,
                                            step_window).stall_seconds
        old_entries = {p: list(self.stages[p].entries) for p in range(self.pp)}
        self.layer_assignment = list(new_ranges)
        new_entries = {p: self._stage_entries(p) for p in range(self.pp)}
        affected = [p for p in range(self.pp)
                    if old_entries[p] != new_entries[p]]
        # entry slices (views of each affected stage's full vectors)
        entry_state: Dict[int, Dict[str, torch.Tensor]] = {}
        for p in affected:
            st = self.stages[p]
            tbl = st.table
            for comp in COMPONENTS:
                fullc = st.full(comp)
                for pos, e in enumerate(st.entries):
                    s_, e_ = tbl.layer_interval(pos)
                    entry_state.setdefault(e, {})[comp] = fullc[s_:e_]
        survivors = {p: list(self.stages[p].dp_ranks) for p in affected}
        for p in affected:                  # old buffers go before new ones
            self.stages[p].flat = {}
        for p in affected:
            entries = new_entries[p]
            sizes = [entry_state[e]["master"].numel() for e in entries]
            full_by_comp = {
                c: (torch.cat([entry_state[e][c] for e in entries])
                    if entries else torch.zeros(0, dtype=torch.float32,
                                                device=self.device))
                for c in COMPONENTS}
            self.stages[p] = StageState.from_full(
                entries, sizes, self.zero_layout, survivors[p], full_by_comp)
            del full_by_comp
            self._rebootstrap(p)
        return total_stall

    def _entry_from_stage(self, e: int) -> Dict[str, torch.Tensor]:
        for st in self.stages:
            if e in st.entries:
                pos = st.entries.index(e)
                s_, e_ = st.table.layer_interval(pos)
                return {c: st.full(c)[s_:e_] for c in COMPONENTS}
        raise KeyError(e)


def _merge_recovery_records(recs: List[Dict[str, float]]) -> Dict[str, float]:
    """Combine per-rank recovery records of one burst into a single record:
    every itemized phase (and the total) accumulates; counters too."""
    if len(recs) == 1:
        return recs[0]
    out: Dict[str, float] = {}
    for rec in recs:
        for k, v in rec.items():
            out[k] = out.get(k, 0.0) + v
    return out


def _stage_of(ranges: Sequence[Tuple[int, int]], L: int) -> List[int]:
    out = [0] * L
    for p, (a, b) in enumerate(ranges):
        for l in range(a, b + 1):
            out[l] = p
    return out
