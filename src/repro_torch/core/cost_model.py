"""Mini-step cost model — paper Eq. (1) — and the stage memory model.

    T_i = T^Cf + T^Cb + [T^P2Pf - sigma_f T^Cf]_+ + [T^P2Pb - sigma_b T^Cb]_+

Compute terms come from analytic per-layer FLOPs (profiled offline in the
paper; analytic here — same role), scaled by device frequency.  P2P terms are
activation/grad bytes over link bandwidth, parameterized by neighbor ranks
(fan-in/out contention).  Segment costs t_p([a..b]) and Mem[a..b] are
precomputed prefix sums so the Alg.1 DP solver queries them in O(1).

A copy of ``repro.core.cost_model`` (the JAX package), numpy only.  Every
second it returns is modeled, from a :class:`HardwareSpec`, never measured.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.models.config import ATTN, ATTN_MOE, MAMBA_MOE, ModelConfig
from repro_torch.models.registry import flat_layer_types


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """The cost model's hardware.  The defaults are the reference's model
    defaults (its model of a TPU v5e), kept so that the port's plans equal
    the reference's; they are not figures of any card the port runs on."""
    peak_flops: float = 197e12          # bf16 FLOP/s per chip (TPU v5e)
    hbm_bw: float = 819e9               # bytes/s
    link_bw: float = 50e9               # bytes/s per ICI link
    hbm_bytes: float = 16e9             # per-chip HBM capacity
    mfu: float = 0.45                   # achievable fraction of peak (profiled)
    base_freq: float = 1.0              # normalized frequency
    max_freq: float = 1.178             # 1650/1400 MHz, paper's testbed ratio


def layer_flops(cfg: ModelConfig, layer_idx: int, tokens: int) -> float:
    """Forward FLOPs of one layer for `tokens` tokens (bwd ~ 2x fwd)."""
    blk = flat_layer_types(cfg)[layer_idx]
    d = cfg.d_model
    f = 0.0
    if blk in (ATTN, ATTN_MOE):
        if cfg.use_mla:
            qdim = cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
            f += 2 * tokens * d * (cfg.q_lora_rank or qdim)
            if cfg.q_lora_rank:
                f += 2 * tokens * cfg.q_lora_rank * qdim
            f += 2 * tokens * d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            f += 2 * tokens * cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
            f += 2 * tokens * cfg.num_heads * cfg.v_head_dim * d
        else:
            hd = cfg.head_dim
            f += 2 * tokens * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
            f += 2 * tokens * cfg.num_heads * hd * d
        # attention scores+values: 2 * 2 * tokens * seq * H * hd  (causal ~ /2)
        # tokens here = mbs*seq so use seq from cfg context: approximate with
        # quadratic term folded via avg seq — callers pass tokens=mbs*seq and
        # we add attn quadratic separately in segment_costs.
    else:
        di, ds, ng = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
        f += 2 * tokens * d * (2 * di + 2 * ng * ds + cfg.ssm_heads)
        f += 2 * tokens * di * d
        f += 2 * tokens * di * ds * 2      # SSD state update + output (linear)
    if blk in (ATTN_MOE, MAMBA_MOE):
        act = cfg.top_k + cfg.num_shared_experts
        mats = 2 if cfg.activation == "relu2" else 3
        f += 2 * tokens * act * mats * d * cfg.moe_d_ff
        f += 2 * tokens * d * cfg.num_experts  # router
    elif cfg.d_ff > 0:
        mats = 2 if cfg.activation == "relu2" else 3
        f += 2 * tokens * mats * d * cfg.d_ff
    return f


def attn_quadratic_flops(cfg: ModelConfig, layer_idx: int, mbs: int, seq: int) -> float:
    blk = flat_layer_types(cfg)[layer_idx]
    if blk in (ATTN, ATTN_MOE):
        hd = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
        qk = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.use_mla else cfg.head_dim
        return 2 * mbs * cfg.num_heads * seq * seq * (qk + hd) / 2  # causal
    return 0.0


def layer_param_bytes(cfg: ModelConfig, layer_idx: int, dtype_bytes: int = 2) -> float:
    blk = flat_layer_types(cfg)[layer_idx]
    return cfg._block_params(blk) * dtype_bytes


def layer_opt_bytes(cfg: ModelConfig, layer_idx: int) -> float:
    """Mixed-precision Adam: fp32 master + mu + nu = 12 B/param."""
    blk = flat_layer_types(cfg)[layer_idx]
    return cfg._block_params(blk) * 12


def activation_bytes(cfg: ModelConfig, mbs: int, seq: int, dtype_bytes: int = 2) -> float:
    """Boundary activation (what P2P ships between stages)."""
    return mbs * seq * cfg.d_model * dtype_bytes


def layer_act_footprint(cfg: ModelConfig, layer_idx: int, mbs: int, seq: int,
                        dtype_bytes: int = 2) -> float:
    """Stored activation per layer per in-flight micro-batch (w/ recompute of
    attention internals — store ~4 d_model-wide tensors per layer)."""
    return 4 * mbs * seq * cfg.d_model * dtype_bytes


@dataclasses.dataclass
class SegmentCosts:
    """Precomputed prefix sums for Alg.1 O(1) segment queries.

    Prefix sums are memoized (computed once, reused by every scalar *and*
    vectorized query), and the ``*_vec`` methods accept layer-index arrays so
    the planners and policies price all P stages in one array op.  Scalar
    queries keep the seed's exact arithmetic.
    """
    cfg: ModelConfig
    seq: int
    hw: HardwareSpec
    fwd_flops: np.ndarray           # [L] per-layer fwd FLOPs for 1 sample
    param_bytes: np.ndarray         # [L]
    opt_bytes: np.ndarray           # [L]

    @classmethod
    def build(cls, cfg: ModelConfig, seq: int, hw: HardwareSpec) -> "SegmentCosts":
        L = cfg.num_layers
        fwd = np.array([layer_flops(cfg, i, seq) +
                        attn_quadratic_flops(cfg, i, 1, seq) for i in range(L)])
        pb = np.array([layer_param_bytes(cfg, i) for i in range(L)])
        ob = np.array([layer_opt_bytes(cfg, i) for i in range(L)])
        return cls(cfg, seq, hw, fwd, pb, ob)

    def _pre(self, arr):
        key = id(arr)
        cache = getattr(self, "_pre_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_pre_cache", cache)
        out = cache.get(key)
        if out is None:
            out = np.concatenate([[0.0], np.cumsum(arr)])
            out.setflags(write=False)
            cache[key] = out
        return out

    def seg_fwd_flops(self, a: int, b: int, mbs: int) -> float:
        """Layers [a..b] inclusive, 0-indexed."""
        c = self._pre(self.fwd_flops)
        return mbs * (c[b + 1] - c[a])

    def seg_fwd_flops_vec(self, a: np.ndarray, b: np.ndarray, mbs) -> np.ndarray:
        """Vector form of :meth:`seg_fwd_flops` — ``a``/``b``/``mbs`` broadcast;
        per-element arithmetic identical to the scalar path."""
        c = self._pre(self.fwd_flops)
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        return np.asarray(mbs) * (c[b + 1] - c[a])

    def seg_mem(self, a: int, b: int, mbs: int, inflight: int,
                dp_size: int = 1) -> float:
        """params + ZeRO-sharded optimizer + activations for layers [a..b]."""
        pb = self._pre(self.param_bytes)
        ob = self._pre(self.opt_bytes)
        acts = sum(layer_act_footprint(self.cfg, i, mbs, self.seq)
                   for i in range(a, b + 1)) * inflight
        return (pb[b + 1] - pb[a]) + (ob[b + 1] - ob[a]) / max(dp_size, 1) + acts

    def seg_mem_vec(self, a: np.ndarray, b: np.ndarray, mbs, inflight,
                    dp_size=1) -> np.ndarray:
        """Vector form of :meth:`seg_mem`.  The activation term uses
        ``count * footprint`` instead of the scalar path's repeated addition
        (can differ in the last ULP); use only in vectorized contexts — the
        scalar path stays the comparison oracle."""
        pb = self._pre(self.param_bytes)
        ob = self._pre(self.opt_bytes)
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        foot = layer_act_footprint(self.cfg, 0, 1, self.seq)  # layer-uniform
        acts = (b - a + 1) * (foot * np.asarray(mbs)) * np.asarray(inflight)
        return ((pb[b + 1] - pb[a])
                + (ob[b + 1] - ob[a]) / np.maximum(np.asarray(dp_size), 1)
                + acts)


def mini_step_time(seg: SegmentCosts, a: int, b: int, mbs: int,
                   freq: float = 1.0, sigma_f: float = 0.7, sigma_b: float = 0.7,
                   neighbor_ranks: int = 1, hw: Optional[HardwareSpec] = None) -> float:
    """Paper Eq.(1) for one stage holding layers [a..b] with micro-batch mbs."""
    hw = hw or seg.hw
    eff = hw.peak_flops * hw.mfu * freq
    t_cf = seg.seg_fwd_flops(a, b, mbs) / eff
    t_cb = 2.0 * t_cf
    p2p = activation_bytes(seg.cfg, mbs, seg.seq) / (hw.link_bw / max(neighbor_ranks, 1))
    t_f = t_cf + max(0.0, p2p - sigma_f * t_cf)
    t_b = t_cb + max(0.0, p2p - sigma_b * t_cb)
    return t_f + t_b


def mini_step_time_vec(seg: SegmentCosts, a, b, mbs, freq=1.0,
                       sigma_f: float = 0.7, sigma_b: float = 0.7,
                       neighbor_ranks=1,
                       hw: Optional[HardwareSpec] = None) -> np.ndarray:
    """Eq.(1) over stage vectors: ``a``/``b``/``mbs``/``freq``/
    ``neighbor_ranks`` broadcast (typically ``[P]`` arrays), one array op for
    the whole pipeline.  Per-element arithmetic matches the scalar
    :func:`mini_step_time` exactly (same operation order), so vectorized
    policies reproduce the per-stage loop bit-for-bit."""
    hw = hw or seg.hw
    eff = hw.peak_flops * hw.mfu * np.asarray(freq, dtype=np.float64)
    t_cf = seg.seg_fwd_flops_vec(a, b, np.asarray(mbs)) / eff
    t_cb = 2.0 * t_cf
    p2p = ((np.asarray(mbs) * seg.seq * seg.cfg.d_model * 2)
           / (hw.link_bw / np.maximum(np.asarray(neighbor_ranks), 1)))
    t_f = t_cf + np.maximum(0.0, p2p - sigma_f * t_cf)
    t_b = t_cb + np.maximum(0.0, p2p - sigma_b * t_cb)
    return t_f + t_b
