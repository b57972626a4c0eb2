"""Seed-path implementations of the VirtualCluster hot paths, in PyTorch.

A port of ``repro.core.legacy``: the seed's step and recovery, in the
seed's Python loop structure, which the fast path in ``cluster.py``
optimizes away.  One ``torch.autograd.grad`` call and one ``float(loss)``
host sync per (micro, rank) item with per-leaf gradient accumulation; one
fused-AdamW update per (stage, rank) ZeRO shard; one write-back per entry;
per-rank, per-interval gather loops; segment dicts rebuilt per component
for a remap; every stage and every ring pool rebuilt on a migration.  The
ring snapshot is the per-rank loop (``SnapshotPool(batched=False)``).

Stage state stays on the cluster's device, as on the fast path: the gather
loops, the remap and the migration copy device tensors; only the ring
snapshot is host memory.  Parameters are written into the existing leaf
tensors (``EntryFlattener.write_entry``): the cluster's autograd holds
them.

On float32 configs the two paths do the same arithmetic element for
element: both take one gradient call per item in the seed's (micro, rank)
order, accumulate ``acc + g * w`` in float32 (per leaf here, over the flat
vector there) and run the same AdamW op sequence per element (per shard
here, per stage there).  So the seed path equals the fast path with
``==``, on the CPU and on the card, and ``ParameterConsistencyChecker``
holds them to that.  (The reference's fast path batches its items with
``vmap``, and its two paths no longer agree bit for bit.)

Consumers: the bit-exact twin of ``invariants.ParameterConsistencyChecker``
and the seed-vs-fast step baseline (``chip_smoke.py`` phase 8).  Selected
with ``VirtualCluster(..., fast_path=False)``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import materialize_samples
from repro_torch.kernels.threefry import fold_in
from repro_torch.models.layers import RngCtx
from repro_torch.optim.adam import adam_update_flat_

from .fabric.snapshot import SnapshotPool
from .migration import MigrationSpec, migration_timing
from .statespace import (COMPONENTS, HEAD, STEM, StageState, flatten_leaves,
                         get_table, tree_leaves)


# ------------------------------------------------------------------ step --
def micro_grads(cl, step: int) -> Tuple[float, List[torch.Tensor]]:
    """Seed micro-batch loop: one gradient call and one ``float(loss)`` host
    sync per (micro, rank) slice; per-leaf accumulation in each leaf's own
    dtype.  Returns ``(total_loss, gradient leaves in model-flat order)``;
    an unused leaf's gradient is zeros, as on the fast path."""
    ids_by_rank = cl.sampler.partition(step, cl.per_rank_mbs, cl.num_micro)
    step_key = fold_in(cl.base_key, step)
    deterministic = cl.cfg.dropout_rate <= 0.0
    total_loss = 0.0
    acc: Optional[List[torch.Tensor]] = None
    for m in range(cl.num_micro):
        for r, rank_ids in enumerate(ids_by_rank):
            ids = rank_ids[m]
            if len(ids) == 0:
                continue
            toks = torch.from_numpy(materialize_samples(
                ids, cl.seq, cl.cfg.vocab_size)).to(cl.device)
            sids = None
            if not deterministic:
                if cl.rng_mode == "reshard":
                    sids = ids.astype(np.int32)
                else:   # naive: rank-addressed streams (the paper's "w/o")
                    sids = np.arange(len(ids), dtype=np.int32) \
                        + np.int32(r * 100003)
                sids = torch.from_numpy(sids).to(cl.device)
            ctx = RngCtx(step_key=step_key, sample_ids=sids,
                         deterministic=deterministic)
            loss = cl._loss_fn(cl.stem, cl.layer_params, cl.head, toks, toks,
                               ctx)
            grads = torch.autograd.grad(loss, cl._leaves, allow_unused=True,
                                        materialize_grads=True)
            w = cl.grad_weights[r] / cl.num_micro
            total_loss += float(loss.detach()) * w
            # the reference's ``g * w`` takes the weak-typed w in float32
            w32 = float(np.float32(w))
            gs = [g * w32 for g in grads]
            del grads
            acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
    return total_loss, acc


def _entry_grads(cl, leaves: List[torch.Tensor],
                 ) -> Dict[int, List[torch.Tensor]]:
    """Split model-flat gradient leaves into each entry's (STEM, layer ids,
    HEAD), in the entries' tree order."""
    out: Dict[int, List[torch.Tensor]] = {}
    off = 0
    entries = [(STEM, cl.stem)] + list(enumerate(cl.layer_params)) \
        + [(HEAD, cl.head)]
    for e, tree in entries:
        n = len(tree_leaves(tree))
        out[e] = leaves[off:off + n]
        off += n
    assert off == len(leaves), (off, len(leaves))
    return out


def train_step(cl) -> float:
    """Seed train step: per-entry gradient re-ravel to float32, per-(stage,
    rank) fused AdamW over interval-concatenated shards, per-entry
    parameter write-back, the per-rank ring snapshot."""
    step = cl.step_count
    loss, leaves = micro_grads(cl, step)
    cl.opt_step += 1
    grads = _entry_grads(cl, leaves)
    del leaves
    grad_shard_by_stage: List[List[np.ndarray]] = []
    for st in cl.stages:
        # this stage's full gradient vector, one re-ravel per entry
        parts = [flatten_leaves(grads[e]) for e in st.entries]
        gfull = torch.cat(parts) if parts else \
            torch.zeros(0, dtype=torch.float32, device=cl.device)
        del parts
        tbl = st.table
        shards = []
        for j, r in enumerate(st.dp_ranks):
            gs = torch.cat([gfull[s:e] for s, e in tbl.owner_intervals(j)]) \
                if st.total else gfull
            if st.total:
                new = {k: v.clone() for k, v in st.shard(r).items()}
                adam_update_flat_(gs, new, cl.opt_step, cl.adam)
                st.write_shard(r, new)
                del new
            if cl.snapshot_enabled:
                shards.append(gs.cpu().numpy())
            del gs
        grad_shard_by_stage.append(shards)
        del gfull
    del grads
    write_params_from_masters(cl)
    if cl.snapshot_enabled:
        t0 = time.perf_counter()
        for p in range(cl.pp):
            cl.snapshots[p].snapshot_step(step, grad_shard_by_stage[p],
                                          cl.opt_step)
        cl.snapshot_seconds.append(time.perf_counter() - t0)
    cl.step_count += 1
    cl.losses.append(loss)
    return loss


def stage_full_vec(st: StageState, comp: str = "master") -> torch.Tensor:
    """Seed all-gather equivalent: per-rank, per-interval copy loop, on the
    stage state's device."""
    full = torch.zeros(st.total, dtype=torch.float32,
                       device=st.flat[comp].device)
    tbl = st.table
    shards = st.shards
    for j, r in enumerate(st.dp_ranks):
        off = 0
        src = shards[r][comp]
        for s, e in tbl.owner_intervals(j):
            full[s:e] = src[off:off + (e - s)]
            off += e - s
    return full


def write_params_from_masters(cl) -> None:
    """Seed write-back: one gather of each stage's masters, then one write
    per entry into its existing leaves (cast to each leaf's dtype)."""
    for st in cl.stages:
        full = stage_full_vec(st)
        off = 0
        for e, sz in zip(st.entries, st.sizes):
            cl.flattener.write_entry(e, full[off:off + sz])
            off += sz


# -------------------------------------------------------------- recovery --
def stage_full_vec_with_snapshots(cl, p: int, comp: str,
                                  failed: List[int]) -> torch.Tensor:
    """Pre-failure ground truth on the device: survivors' device state +
    failed ranks' ring state (seed per-interval loop; a host interval
    crosses to the device as it is copied)."""
    st = cl.stages[p]
    pool = cl.snapshots[p]
    full = torch.zeros(st.total, dtype=torch.float32, device=cl.device)
    tbl = st.table
    shards = st.shards
    for j, r in enumerate(st.dp_ranks):
        src = shards[r][comp] if r not in failed else None
        if src is None:
            snap = pool.host[pool.holder_of(j)]
            src = torch.from_numpy(snap[comp]) if snap is not None else None
        if src is None:
            continue
        off = 0
        for s, e in tbl.owner_intervals(j):
            full[s:e] = src[off:off + (e - s)]
            off += e - s
    return full


def _check_full(st: StageState, pre: Dict[str, torch.Tensor],
                what: str) -> None:
    """Online verification before resume, through the seed gather loop."""
    for comp in COMPONENTS:
        if not torch.equal(stage_full_vec(st, comp), pre[comp]):
            raise AssertionError(f"{what} corrupted {comp}")


def _fresh_pool(cl, p: int) -> None:
    """A fresh per-rank ring pool for stage ``p``'s current DP group."""
    st = cl.stages[p]
    cl.snapshots[p] = SnapshotPool(len(st.dp_ranks), cl.adam, batched=False)
    if cl.snapshot_enabled:
        cl.snapshots[p].bootstrap(cl.step_count,
                                  [st.shard(r) for r in st.dp_ranks])


def live_remap_stage(cl, p: int, failed: List[int]):
    """Seed shrink remap: per-component, per-rank segment dicts rebuilt in
    Python; full-vector verification through the seed gather loop."""
    st = cl.stages[p]
    pool = cl.snapshots[p]
    tbl = st.table
    old_ranks = list(st.dp_ranks)
    # record pre-failure full vectors for verification
    pre = {c: stage_full_vec_with_snapshots(cl, p, c, failed)
           for c in COMPONENTS}

    surviving = [r for r in old_ranks if r not in failed]
    device_parts = {r: tbl.owner_intervals(old_ranks.index(r))
                    for r in surviving}
    host_parts = {}
    for f in failed:
        holder = pool.holder_of(old_ranks.index(f))
        holder_rank = old_ranks[holder]
        if holder_rank in surviving and pool.host[holder] is not None:
            host_parts[f] = tbl.owner_intervals(old_ranks.index(f))
    new_tbl = get_table(st.layout_kind, st.sizes, len(surviving))
    target_parts = {r: new_tbl.owner_intervals(j)
                    for j, r in enumerate(surviving)}

    plan = cl.remapper.compute_plan(st.total, device_parts, host_parts,
                                    target_parts)
    # execute with real tensors, per component
    shards = st.shards
    empty = torch.zeros(0, dtype=torch.float32, device=cl.device)
    new_shards: Dict[int, Dict[str, torch.Tensor]] = {r: {} for r in surviving}
    for comp in COMPONENTS:
        device_data = {r: tbl.segments(old_ranks.index(r), shards[r][comp])
                       for r in surviving}
        host_data = {}
        for f in failed:
            snap = pool.host[pool.holder_of(old_ranks.index(f))]
            if snap is None:
                continue
            host_data[f] = tbl.segments(old_ranks.index(f), snap[comp])
        assembled = cl.remapper.execute(plan, st.total, device_data,
                                        host_data, device=cl.device)
        for r in surviving:
            new_shards[r][comp] = assembled.get(r, empty)
    del shards
    st.replace_shards(surviving, new_shards)
    del new_shards
    _check_full(st, pre, "remap")
    del pre
    # rebuild the ring snapshot pool for the shrunken group
    _fresh_pool(cl, p)
    return plan.est_seconds, plan


def widen_stage(cl, p: int, joining: List[int]) -> float:
    """Seed reverse remap: redistribute the stage state over a WIDER
    group."""
    st = cl.stages[p]
    old_ranks = list(st.dp_ranks)
    tbl = st.table
    new_ranks = old_ranks + [j for j in joining if j not in old_ranks]
    pre = {c: stage_full_vec(st, c) for c in COMPONENTS}
    device_parts = {r: tbl.owner_intervals(old_ranks.index(r))
                    for r in old_ranks}
    new_tbl = get_table(st.layout_kind, st.sizes, len(new_ranks))
    target_parts = {r: new_tbl.owner_intervals(j)
                    for j, r in enumerate(new_ranks)}
    plan = cl.remapper.compute_plan(st.total, device_parts, {}, target_parts)
    shards = st.shards
    empty = torch.zeros(0, dtype=torch.float32, device=cl.device)
    new_shards: Dict[int, Dict[str, torch.Tensor]] = {r: {} for r in new_ranks}
    for comp in COMPONENTS:
        device_data = {r: tbl.segments(old_ranks.index(r), shards[r][comp])
                       for r in old_ranks}
        assembled = cl.remapper.execute(plan, st.total, device_data, {},
                                        device=cl.device)
        for r in new_ranks:
            new_shards[r][comp] = assembled.get(r, empty)
    del shards
    st.replace_shards(new_ranks, new_shards)
    del new_shards
    _check_full(st, pre, "widen")
    del pre
    _fresh_pool(cl, p)
    return plan.est_seconds


def entry_from_stage(cl, e: int) -> Dict[str, torch.Tensor]:
    """Seed entry extraction: three full-stage gathers per entry (the
    entry's slice copied out, so the gathers are freed)."""
    for st in cl.stages:
        if e in st.entries:
            s_, e_ = st.table.layer_interval(st.entries.index(e))
            return {comp: stage_full_vec(st, comp)[s_:e_].clone()
                    for comp in COMPONENTS}
    raise KeyError(e)


def apply_migrations(cl, moves: List[Tuple[int, int, int]],
                     new_ranges: List[Tuple[int, int]]) -> float:
    """Seed migration executor: rebuilds EVERY stage's state (and ring
    pool) from per-entry slices, affected or not."""
    total_stall = 0.0
    # per-move timing from the migration model
    step_window = cl.simulate_step_time()
    for (lid, src, dst) in moves:
        spec = MigrationSpec((lid,), src, dst, int(cl.seg.param_bytes[lid]),
                             int(cl.seg.opt_bytes[lid]),
                             dp=len(cl.stages[src].dp_ranks),
                             zero_layout=cl.zero_layout,
                             blocking=not cl.non_blocking_migration)
        total_stall += migration_timing(spec, cl.hw.link_bw,
                                        step_window).stall_seconds
    # state movement: rebuild every stage from the new assignment
    pre_state = {e: entry_from_stage(cl, e) for st in cl.stages
                 for e in st.entries}
    cl.layer_assignment = list(new_ranges)
    for p in range(cl.pp):
        survivors = list(cl.stages[p].dp_ranks)
        entries = cl._stage_entries(p)
        vec_parts = [pre_state[e] for e in entries]
        sizes = [v["master"].numel() for v in vec_parts]
        full_by_comp = {
            c: (torch.cat([v[c] for v in vec_parts]) if vec_parts
                else torch.zeros(0, dtype=torch.float32, device=cl.device))
            for c in COMPONENTS}
        cl.stages[p] = StageState.from_full(entries, sizes, cl.zero_layout,
                                            survivors, full_by_comp)
        del full_by_comp
        _fresh_pool(cl, p)
    return total_stall
