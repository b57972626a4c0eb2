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
* per-step ring snapshots to host memory (``core/fabric/snapshot.py``).

Gradients are computed over the *full* model per micro-batch item (the
logically-centralized equivalent of the pipeline's math) and accumulated in
the seed's (micro, rank) order, so the loss trajectory can be held against
the JAX package's.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises if
no card is visible.  Float32 matrix products run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``, set on construction), as
the reference leaves them to XLA.

Not yet ported, and raising ``NotImplementedError``: the seed path
(``fast_path=False``), dropout with a positive rate, and the recovery
methods with their control plane (communicator, agent, controller, schedule
engine, live remap, cost model), which form the next slice.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import GlobalBatchSampler, materialize_samples
from repro_torch.models import registry as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RngCtx
from repro_torch.models.transformer import softmax_xent
from repro_torch.optim.adam import AdamConfig, adam_update_flat_
from repro_torch.weights import params_from_numpy
from .fabric.snapshot import SnapshotPool
from .statespace import (HEAD, STEM, EntryFlattener, StageState,
                         flatten_leaves, tree_leaves)

_RECOVERY_SLICE = "the recovery slice of the port (recovery, control plane)"


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
                 hw: Any = None, mem_cap: Optional[float] = None,
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
        if cfg.dropout_rate > 0.0:
            raise NotImplementedError(
                "dropout_rate > 0 needs the content-addressed threefry RNG, "
                "which is not ported yet")
        if hw is not None or mem_cap is not None:
            raise NotImplementedError(
                f"hw / mem_cap feed the control plane, which comes with "
                f"{_RECOVERY_SLICE}")
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.dp0, self.pp = dp, pp
        self.global_batch, self.num_micro, self.seq = global_batch, num_micro, seq_len
        self.adam = adam or AdamConfig(master_weights=True)
        self.rng_mode = rng_mode
        self.zero_layout = zero_layout
        self.snapshot_enabled = snapshot_enabled
        self.non_blocking_migration = non_blocking_migration
        self.fast_path = fast_path
        self.sampler = GlobalBatchSampler(global_batch, seed)

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

        # ---- bookkeeping ----
        self.step_count = 0
        self.opt_step = 0
        self.per_rank_mbs: List[int] = [global_batch // num_micro // dp] * dp
        self.grad_weights: List[float] = [1.0 / dp] * dp
        self.losses: List[float] = []
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
        for k, (r, ids) in enumerate(items):
            toks = torch.from_numpy(materialize_samples(
                ids, self.seq, self.cfg.vocab_size)).to(self.device)
            # dropout_rate == 0 (checked at construction): no random op
            # reads the sample ids (reshard) or rank streams (naive) yet
            ctx = RngCtx(step=step, deterministic=True)
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
    # elasticity: the next slice
    # ------------------------------------------------------------------
    def _not_ported(self, *args, **kwargs):
        raise NotImplementedError(f"recovery waits for {_RECOVERY_SLICE}")

    detect_and_recover = apply_event = plan_event = apply_plan = _not_ported
    recover_fail_stop = recover_scale_out = recover_fail_slow = _not_ported
    drain_rank = simulate_step_time = build_view = _not_ported
