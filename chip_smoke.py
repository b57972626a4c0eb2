#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device: the card's name and power limit (``nvidia-smi``); no card, exit 1;
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc),
   and the tensor-core kernels' SASS (``cuobjdump``) checked: flash for
   HGMMA in both forms and UTMALDG, the SSD scan's three kernels for HMMA
   (bf16, float32 accumulators) and LDGSTS (cp.async) and all three for no
   local-memory traffic (spills);
3. every kernel against its plain PyTorch version on the card at the main
   paths' shapes (rmsnorm [4096, 4096]; flash attention [1, 4096, 32, 128]
   causal on both routes: float32, and bf16 at head_dim 32, on the CUDA
   cores; bf16 on the tensor cores MHA and GQA, plus head_dim 64, ragged S
   4000, bidirectional, a peaked softmax and strided projection views; fused AdamW bitwise
   against the numpy oracle over 3 steps, at n % 4 != 0 and on views off a
   16-byte boundary; the SSD scan at [1, 4096, 80, 64] with n 128, chunk
   256, against the sequential oracle: bf16 on the tensor-core route and,
   on the same inputs, the CUDA-core kernel, fp32 on the CUDA-core route,
   with order-1 and small step sizes, and with 8 groups, its fp32 cases
   also against the oracle in float64), with kernel, plain-version and
   library-call times (rmsnorm and ``F.rms_norm`` interleaved; the SSD scan
   beside ``ref.ssd_chunked`` in bf16, composed of cuBLAS products);
4. a tiny dense and a tiny ssm cluster on the card against the same
   clusters on the CPU, for 3 steps each, within the reference's
   kernel-consistency bounds (the dense twin, float32 at head_dim 16,
   must take the CUDA-core flash route only); then both twins through the
   recovery sequence of ``tests/test_torch_recovery.py`` (fail-stop found
   by the probes with a corrupted snapshot, scale-out, fail-slow with a
   layer migration, drain with a corrupted snapshot, a two-rank burst,
   DVFS and OOM-risk events): records, remap plans, integrity tiers and
   layouts equal exactly, losses and state within the same bounds; and the
   main-path kernels at the shapes recovery gives them (batch-2 items:
   rmsnorm on 8192 rows of 2560 and 5120, the SSD scan at
   [2, 4096, 80, 64]) against their plain versions;
5. the dense main path: ``VirtualCluster.train_step`` on codeqwen1.5-7b at
   its published widths and dtype, depth cut to 2 layers, dp=2, pp=2, seq
   4096, for 3 steps, with exact kernel launch counts (every flash launch
   on the tensor-core route) and the host ring snapshot bitwise equal to
   the device shards after every step;
6. the ssm main path: the same on mamba2-2.7b, depth cut to 4 layers,
   its cost model given the H100 data-sheet figures (peak bf16 rate, HBM
   rate and size; the other ``HardwareSpec`` fields keep the reference's
   model defaults);
7. recovery on that cluster, between train steps: a fail-stop found by the
   probes (``inject_fail_stop`` + ``detect_and_recover``), a scale-out, a
   fail-slow that migrates two layers, and a proactive drain, each followed
   by one step; after every recovery and step the ring snapshot equals the
   device shards bit for bit, the loss is finite and the layout is the
   planned one; exact launch counts over the 4 steps; each recovery's
   measured wall clock by phase (verify, communicator edit, live remap,
   migration, dataflow; ring re-bootstrap inside remap and migration),
   its total and peak device memory beside the record's modeled seconds;
8. a JSON line with every kernel's numbers, one with every recovery's, then
   the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import codeqwen1p5_7b, mamba2_2p7b  # noqa: E402
from repro_torch.core.cluster import VirtualCluster  # noqa: E402
from repro_torch.core.cost_model import HardwareSpec  # noqa: E402
from repro_torch.core.events import ElasticEvent, EventKind  # noqa: E402
from repro_torch.core.fabric.snapshot import SnapshotPool  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, uses_sm90)
from repro_torch.kernels.fused_adam import fused_adam_cuda_  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan_cuda, ssd_scan_cuda_cores, uses_sm90 as ssd_uses_sm90)
from repro_torch.models.registry import tiny_config  # noqa: E402
from repro_torch.optim.adam import AdamConfig, adam_update_flat_np  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the cost model of the ssm phases: the data sheet's figures; link_bw, mfu
# and the frequencies keep the reference's model defaults
H100_HW = HardwareSpec(peak_flops=PEAK_OPS_PER_S[torch.bfloat16],
                       hbm_bw=HBM_BYTES_PER_S, hbm_bytes=80e9)
# kernel-consistency bounds of the reference (core/invariants.py)
LOSS_RTOL, LOSS_ATOL, PARAM_RTOL, PARAM_ATOL0 = 1e-4, 1e-6, 1e-4, 1e-5

SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:22"),
    "flash_attention_sm90": (
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:78"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "fused_adam": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                   "src/repro/kernels/fused_adam.py:52"),
    "ssd_scan_sm90": ("src/repro_torch/kernels/csrc/ssd_scan_sm90.cu",
                      "src/repro/kernels/ssd_scan.py:78"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:78"),
}
DESIGNS = {
    "flash_attention_sm90": "bf16, head_dim 64/128: wgmma m64n128k16 for "
                            "Q.K^T and register-A wgmma for P.V (P as bf16 "
                            "hi + lo), K/V by TMA in a 2-stage mbarrier ring",
    "flash_attention": "float32, and bf16 at head_dim 16/32: float32 FMAs on "
                       "the CUDA cores",
    "ssd_scan_sm90": "bf16, p <= 64, n <= 128, chunk % 64 == 0: "
                     "chunk-parallel (chunk_state, state_pass, chunk_out), "
                     "mma.sync m16n8k16 with float32 operands as three bf16 "
                     "pieces, x/B/C tiles through cp.async",
    "ssd_scan": "float32, and other bf16 widths: one block per (b*h, p "
                "tile) walking the chunks, float32 FMAs on the CUDA cores",
}
# exact launches over 3 steps of each main path (4 items a step); every
# flash launch of the bf16 models takes the tensor-core kernel
DENSE_LAUNCHES = {"rmsnorm": 60, "flash_attention": 0, "fused_adam": 6,
                  "ssd_scan": 0, "flash_attention_sm90": 24,
                  "ssd_scan_sm90": 0}
SSM_LAUNCHES = {"rmsnorm": 108, "flash_attention": 0, "fused_adam": 6,
                "ssd_scan": 0, "flash_attention_sm90": 0,
                "ssd_scan_sm90": 48}
# exact launches over the 4 steps of phase 7: after a shrink each step is 2
# items of batch 2, after the scale-out 4 items of batch 1
RECOVERY_LAUNCHES = {"rmsnorm": 108, "flash_attention": 0, "fused_adam": 8,
                     "ssd_scan": 0, "flash_attention_sm90": 0,
                     "ssd_scan_sm90": 48}
# phase 7: (name, recovery, layer_assignment, dp_ranks, per_rank_mbs after)
# The fail-stop leaves stage 1 one rank wide, so the engine's graph plan
# moves layer 2 to stage 0; the fail-slow of rank (0, 0) moves layers 1 and
# 2 back to stage 1; the drain then keeps the layout.
RECOVERIES = [
    ("fail-stop (1, 1), detected",
     lambda cl: (cl.inject_fail_stop(1, 1), cl.detect_and_recover())[1],
     [(0, 2), (3, 3)], [[0, 1], [0]], [2]),
    ("scale-out (1, 1)", lambda cl: cl.recover_scale_out(1, 1),
     [(0, 2), (3, 3)], [[0, 1], [0, 1]], [1, 1]),
    ("fail-slow (0, 0) x2.0", lambda cl: cl.recover_fail_slow(0, 0, 2.0),
     [(0, 0), (1, 3)], [[0, 1], [0, 1]], [1, 1]),
    ("drain (0, 0)", lambda cl: cl.drain_rank(0, 0),
     [(0, 0), (1, 3)], [[1], [0, 1]], [2]),
]
# the tiny twins' recovery sequence (tests/test_torch_recovery.py SEQUENCE)
TWIN_SEQUENCE = [
    ("train",), ("corrupt", 1, 1), ("detect_fail_stop", 1, 1), ("train",),
    ("scale_out", 1, 1), ("train",),
    ("fail_slow", 0, 0, 2.0), ("train",),
    ("corrupt", 0, 0), ("drain", 0, 0), ("train",),
    ("burst_fail_stop", (5, 6)), ("train",),
    ("event", "dvfs_set", (2,)), ("event", "oom_risk", (3,)),
]
# the tensor-core SSD scan's kernels: name -> HMMA and LDGSTS expected
SSD_SM90_KERNELS = {"ssd_chunk_state_kernel": True,
                    "ssd_state_pass_kernel": False,
                    "ssd_chunk_out_kernel": True}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_medians(fns: dict, rounds: int, iters: int) -> dict:
    """Median over ``rounds`` of each function's mean time, the functions
    timed in turn within each round (``time_ms`` over ``iters``)."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, iters))
    return {name: float(np.median(t)) for name, t in times.items()}


def device_us_by_kernel(fn, iters: int) -> dict:
    """Device microseconds per call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+)\(", e.key)
            out[name.group(1) if name else e.key] = \
                e.device_time_total / iters
    return out


def bound(nbytes: float, ops_: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(a: torch.Tensor, b: torch.Tensor, tier: dict) -> tuple:
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= tier["atol"] + tier["rtol"] * b.abs()).all())
    return ok, float(err.max())


# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.last_build_seconds:.1f} s)")
    for line in _build.last_build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "arning")):
            log("  " + line.strip())
    sass_check()


def sass_check() -> None:
    """The tensor-core kernels' machine code (``cuobjdump -sass`` of the
    built library).  Flash must hold HGMMA for both products (shared-memory
    A for Q.K^T, register A for P.V) and UTMALDG (TMA loads).  The SSD
    scan's chunk_state and chunk_out must hold HMMA.16816.F32.BF16
    (mma.sync, bf16 in, float32 accumulators) and LDGSTS (cp.async), and
    none of its three kernels may touch local memory (LDL/STL: spills)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "HGMMA register A": 0, "UTMALDG": 0,
                          "HMMA bf16": 0, "LDGSTS": 0, "LDL/STL": 0}
            continue
        if fn is None:
            continue
        hgmma = re.search(r"HGMMA\.\S+\s+[^,]+,\s*([^,\s]+)", line)
        if hgmma:
            counts[fn]["HGMMA"] += 1
            counts[fn]["HGMMA register A"] += hgmma.group(1).startswith("R")
        counts[fn]["UTMALDG"] += "UTMALDG" in line
        counts[fn]["HMMA bf16"] += bool(
            re.search(r"\bHMMA\.16816\.F32\.BF16\b", line))
        counts[fn]["LDGSTS"] += bool(re.search(r"\bLDGSTS\b", line))
        counts[fn]["LDL/STL"] += bool(re.search(r"\b(LDL|STL)\b", line))
    sm90 = {f: c for f, c in counts.items() if "flash_fwd_sm90_kernel" in f}
    check(len(sm90) == 2, f"expected 2 tensor-core flash kernels in the "
                          f"SASS, found {len(sm90)}")
    for f, c in sm90.items():
        log(f"  SASS {f[:90]}: {c}")
        check(c["HGMMA"] > c["HGMMA register A"] > 0 and c["UTMALDG"] > 0,
              f"{f}: HGMMA for both products and UTMALDG expected: {c}")
    for kernel, products in SSD_SM90_KERNELS.items():
        found = [(f, c) for f, c in counts.items() if kernel in f]
        check(len(found) == 1, f"expected one {kernel} in the SASS, found "
                               f"{len(found)}")
        f, c = found[0]
        log(f"  SASS {kernel}: HMMA bf16 {c['HMMA bf16']}, LDGSTS "
            f"{c['LDGSTS']}, LDL/STL {c['LDL/STL']}")
        check(c["LDL/STL"] == 0, f"{kernel}: local-memory traffic: {c}")
        if products:
            check(c["HMMA bf16"] > 0 and c["LDGSTS"] > 0,
                  f"{kernel}: HMMA.16816.F32.BF16 and LDGSTS expected: {c}")


def kernel_rmsnorm(gen) -> dict:
    rows, d, eps = 4096, 4096, 1e-5
    rec = {}
    for dtype, tier in ((torch.float32, "rmsnorm"),
                        (torch.bfloat16, "rmsnorm_bf16")):
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        y = rmsnorm_cuda(x, scale, eps)
        ok, err = within(y, ref.rmsnorm_reference(x, scale, eps),
                         ops.TOLERANCE_TIERS[tier])
        log(f"rmsnorm {dtype}: max_abs_err {err:.3e} tier {tier} ok={ok}")
        check(ok, f"rmsnorm {dtype} outside {tier}")
        if dtype == torch.bfloat16:     # the main path's dtype
            nbytes = 2 * rows * d * x.element_size() + 4 * d
            b, by = bound(nbytes, 4 * rows * d, dtype)
            sc = scale.to(dtype)
            # kernel and library call in turn, 5 rounds of 50 launches
            med = interleaved_medians(
                {"kernel": lambda: rmsnorm_cuda(x, scale, eps),
                 "library": lambda: F.rms_norm(x, (d,), sc, eps)}, 5, 50)
            log(f"  rmsnorm bf16 medians of 5 interleaved rounds of 50: "
                f"kernel {med['kernel']:.5f} ms, F.rms_norm "
                f"{med['library']:.5f} ms")
            rec = dict(max_abs_err=err, ms=med["kernel"],
                       plain_ms=time_ms(lambda: ref.rmsnorm_reference(
                           x, scale, eps), 20),
                       bound_ms=b, bound_by=by, library_ms=med["library"])
    return rec


def kernel_flash(gen) -> dict:
    """Flash attention at codeqwen's widths against the plain version under
    the unchanged tiers: the CUDA-core route (float32, and bf16 at head_dim
    32) and the tensor-core route (bf16: MHA as on the main path, GQA,
    head_dim 64, ragged S, bidirectional, a peaked softmax, and q/k/v as
    strided views of one fused projection).  Returns the records of both
    kernels."""
    B, S, H, hd = 1, 4096, 32, 128
    recs = {}
    cases = (  # dtype, S, Hkv, hd, causal, q scale, layout
        (torch.float32, S, H, hd, True, 1.0, "dense"),
        (torch.bfloat16, S, H, 32, True, 1.0, "dense"),
        (torch.bfloat16, S, H, hd, True, 1.0, "dense"),
        (torch.bfloat16, S, 8, hd, True, 1.0, "dense"),
        (torch.bfloat16, S, H, 64, True, 1.0, "dense"),
        (torch.bfloat16, 4000, H, hd, True, 1.0, "dense"),
        (torch.bfloat16, S, H, hd, False, 1.0, "dense"),
        (torch.bfloat16, S, H, hd, True, 4.0, "dense"),
        (torch.bfloat16, S, 8, hd, True, 1.0, "projection"),
    )
    for dtype, s, Hkv, d, causal, qscale, layout in cases:
        tier = "flash_attention" if dtype == torch.float32 \
            else "flash_attention_bf16"
        if layout == "projection":   # one [B, S, (H + 2 Hkv) hd] activation
            x = torch.randn(B, s, (H + 2 * Hkv) * d, generator=gen,
                            device="cuda").to(dtype)
            q = x[..., :H * d].unflatten(-1, (H, d))
            k = x[..., H * d:(H + Hkv) * d].unflatten(-1, (Hkv, d))
            v = x[..., (H + Hkv) * d:].unflatten(-1, (Hkv, d))
        else:
            q = (qscale * torch.randn(B, s, H, d, generator=gen,
                                      device="cuda")).to(dtype)
            k, v = (torch.randn(B, s, Hkv, d, generator=gen,
                                device="cuda").to(dtype) for _ in "kv")
        route = "sm90" if uses_sm90(dtype, d) else "cuda-cores"
        name = (f"flash {route} {dtype} S={s} H={H} Hkv={Hkv} hd={d} "
                f"causal={causal} q*{qscale:g} {layout}")
        want = ref.gqa_attention_reference(q, k, v, causal=causal)
        o = flash_attention_cuda(q, k, v, causal)
        ok, err = within(o, want, ops.TOLERANCE_TIERS[tier])
        log(f"{name}: max_abs_err {err:.3e} tier {tier} ok={ok}")
        check(ok, f"{name} outside {tier}")
        if layout != "dense" or s != S or d != hd or not causal \
                or qscale != 1.0:
            del q, k, v, o, want
            continue
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, True), 50)
        plain = time_ms(lambda: ref.gqa_attention_reference(
            q, k, v, causal=True), 3)
        rep = H // Hkv
        qt, kt, vt = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50)
        pairs = B * H * S * (S + 1) // 2
        nbytes = (2 * B * S * H * hd + 2 * B * S * Hkv * hd) * q.element_size()
        b, by = bound(nbytes, 4 * hd * pairs, dtype)
        log(f"  ms {ms:.4f} plain_ms {plain:.3f} library_ms {lib:.4f} "
            f"bound_ms {b:.4f} ({by})")
        if Hkv == H:    # the main path's case of each route: MHA
            recs["flash_attention_sm90" if route == "sm90"
                 else "flash_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)
        del q, k, v, o, want, qt, kt, vt
    return recs


def kernel_adam(gen, stage_elems: int) -> dict:
    cfg = AdamConfig()
    hp = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, lr=cfg.lr,
              weight_decay=cfg.weight_decay)
    # bitwise against the numpy oracle, 3 steps on 64 M elements
    n = 64 * 2 ** 20
    rs = np.random.default_rng(0)
    host = {"master": rs.standard_normal(n, dtype=np.float32),
            "mu": np.zeros(n, np.float32), "nu": np.zeros(n, np.float32)}
    dev = {c: torch.from_numpy(v).cuda() for c, v in host.items()}
    for step in (1, 2, 3):
        g = (rs.standard_normal(n, dtype=np.float32)
             * np.float32(10.0 ** rs.integers(-6, 2)))
        fused_adam_cuda_(torch.from_numpy(g).cuda(), dev["master"],
                         dev["mu"], dev["nu"], ops.adam_scalars(step, **hp))
        host = adam_update_flat_np(g, host, step, cfg)
        for c in host:
            same = np.array_equal(dev[c].cpu().numpy(), host[c])
            check(same, f"fused AdamW {c} not bitwise equal to "
                        f"adam_update_flat_np at step {step}")
    log(f"fused_adam: bitwise equal to adam_update_flat_np over 3 steps, "
        f"n={n}")
    del dev, host
    # the float4 body's scalar head and tail: n % 4 != 0, views whose base
    # sits 4 bytes past a 16-byte boundary (t[1:]), and a master alone off
    # the others' alignment (the scalar loop); nothing outside a view moves
    n = 10_000_019
    for offs in ((0, 0, 0, 0), (1, 1, 1, 1), (0, 1, 0, 0)):
        g = rs.standard_normal(n, dtype=np.float32) * np.float32(1e-2)
        host = {"master": rs.standard_normal(n, dtype=np.float32),
                "mu": rs.standard_normal(n, dtype=np.float32) * 1e-3,
                "nu": np.abs(rs.standard_normal(n, dtype=np.float32)) * 1e-6}
        bufs = [torch.zeros(n + 1, device="cuda") for _ in range(4)]
        views = [b[o:o + n] for b, o in zip(bufs, offs)]
        for t, x in zip(views, (g, host["master"], host["mu"], host["nu"])):
            t.copy_(torch.from_numpy(x))
        fused_adam_cuda_(*views, ops.adam_scalars(2, **hp))
        want = adam_update_flat_np(g, host, 2, cfg)
        for c, t in zip(("master", "mu", "nu"), views[1:]):
            check(np.array_equal(t.cpu().numpy(), want[c]),
                  f"fused AdamW {c} not bitwise equal at n={n}, view "
                  f"offsets {offs}")
        for b, o in zip(bufs, offs):
            check(not bool(b[:o].any()) and not bool(b[o + n:].any()),
                  f"fused AdamW wrote outside its views, offsets {offs}")
        log(f"fused_adam: bitwise equal at n={n}, view offsets {offs} "
            f"(data_ptr % 16 = {[t.data_ptr() % 16 for t in views]})")
    del bufs, views, host, want
    # timing at the main path's stage size, kernel vs plain version on card
    n = stage_elems
    g = torch.randn(n, generator=gen, device="cuda") * 1e-3
    st = {"master": torch.randn(n, generator=gen, device="cuda"),
          "mu": torch.randn(n, generator=gen, device="cuda") * 1e-3,
          "nu": torch.rand(n, generator=gen, device="cuda") * 1e-6}
    sc = ops.adam_scalars(3, **hp)
    want = ref.adam_flat_reference(g, st["master"], st["mu"], st["nu"], sc)
    got = {c: v.clone() for c, v in st.items()}
    fused_adam_cuda_(g, got["master"], got["mu"], got["nu"], sc)
    err = max(float((got[c] - want[c]).abs().max()) for c in st)
    check(err == 0.0, f"fused AdamW differs from its plain version: {err}")
    del want
    ms = time_ms(lambda: fused_adam_cuda_(g, got["master"], got["mu"],
                                          got["nu"], sc), 10)
    plain = time_ms(lambda: ref.adam_flat_reference(
        g, st["master"], st["mu"], st["nu"], sc), 3)
    steps = [torch.tensor(3.0, device="cuda")]
    lib = time_ms(lambda: torch._fused_adamw_(
        [got["master"]], [g], [got["mu"]], [got["nu"]], [], steps,
        lr=cfg.lr, beta1=cfg.b1, beta2=cfg.b2, weight_decay=cfg.weight_decay,
        eps=cfg.eps, amsgrad=False, maximize=False), 10)
    b, by = bound(28 * n, 12 * n, torch.float32)
    log(f"fused_adam n={n}: ms {ms:.3f} plain_ms {plain:.3f} "
        f"library_ms {lib:.3f} bound_ms {b:.3f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def kernel_ssd(gen) -> dict:
    """The SSD scan at mamba2-2.7b's widths, x, B and C as views of one
    activation as in the model.  Two step-size regimes: dt of order 1 with
    the init's A (the state decays within a chunk), and dt in [1e-3, 1e-1]
    with |A| <= 1 (the state carries across all 16 chunks).  bf16 goes
    through ``ssd_scan_cuda`` to the tensor-core route; on the same inputs
    the CUDA-core kernel is launched too (``ssd_scan_cuda_cores``), so both
    are held to the tier and timed.  Returns the records of both kernels.

    The gate is the tier against the float32 oracle on silu-activated x, B
    and C, the main path's inputs (``apply_mamba`` applies silu to xBC
    before the scan).  Every float32 case also meets a float64 witness:
    the oracle in float64 on the same inputs, with the error held to the
    ``ssd_scan`` tier scaled by the sum of the magnitudes of y's terms (the
    oracle on |x|, |B|, |C|), which is what float32 rounding scales with.
    Signed normal inputs, as the reference's kernel corpus uses, cancel to
    y ~ 0 where those terms reach hundreds; there no float32 summation
    meets the elementwise tier, so they are held to the witness alone and
    their elementwise misses are printed."""
    b, s, h, p, n, chunk = 1, 4096, 80, 64, 128, 256
    recs = {}
    for dtype, g, regime, act in ((torch.bfloat16, 1, "typical", "silu"),
                                  (torch.bfloat16, 1, "carried", "silu"),
                                  (torch.bfloat16, 8, "typical", "silu"),
                                  (torch.float32, 1, "typical", "silu"),
                                  (torch.float32, 1, "carried", "silu"),
                                  (torch.float32, 8, "carried", "silu"),
                                  (torch.float32, 1, "typical", "signed"),
                                  (torch.float32, 8, "carried", "signed")):
        tier_name = "ssd_scan" if dtype == torch.float32 else "ssd_scan_bf16"
        tier = ops.TOLERANCE_TIERS[tier_name]
        xBC = torch.randn(b, s, h * p + 2 * g * n, generator=gen,
                          device="cuda")
        xBC = (F.silu(xBC) if act == "silu" else xBC).to(dtype)
        x = xBC[..., :h * p].reshape(b, s, h, p)
        B = xBC[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xBC[..., h * p + g * n:].reshape(b, s, g, n)
        if regime == "typical":
            dt = F.softplus(torch.randn(b, s, h, generator=gen,
                                        device="cuda"))
            A = -torch.linspace(1.0, 16.0, h, device="cuda")
        else:
            dt = 1e-3 + (1e-1 - 1e-3) * torch.rand(b, s, h, generator=gen,
                                                   device="cuda")
            A = -(0.05 + 0.95 * torch.rand(h, generator=gen, device="cuda"))
        sm90 = ssd_uses_sm90(dtype, p, n, chunk)
        check(sm90 == (dtype == torch.bfloat16),
              f"ssd_scan_cuda routes {dtype} to the wrong kernel")
        y = ssd_scan_cuda(x, dt, A, B, C, chunk)
        Bh, Ch = (t.repeat_interleave(h // g, dim=2) for t in (B, C))
        want = ref.ssd_reference(x, dt, A, Bh, Ch)[0]
        name = f"ssd_scan {dtype} g={g} {regime} {act}"
        outs = {"tensor cores" if sm90 else "CUDA cores": y}
        if sm90:
            outs["CUDA cores"] = ssd_scan_cuda_cores(x, dt, A, B, C, chunk)
        errs = {}
        for route, got in outs.items():
            ok, errs[route] = within(got, want, tier)
            log(f"{name} on the {route}: max_abs_err {errs[route]:.3e} (max "
                f"|y| {float(want.float().abs().max()):.2f}) tier "
                f"{tier_name} ok={ok}")
            if act == "silu":
                check(ok, f"{name} on the {route} outside {tier_name}")
        if sm90:
            diff = (y.float() - outs["CUDA cores"].float()).abs().max()
            log(f"  tensor cores vs CUDA cores: max_abs_diff "
                f"{float(diff):.3e}")
        if dtype == torch.float32:
            d = [t.double() for t in (x, dt, A, Bh, Ch)]
            y64 = ref.ssd_reference(*d)[0]
            terms = ref.ssd_reference(d[0].abs(), d[1], d[2], d[3].abs(),
                                      d[4].abs())[0]
            worst = {}
            for who, got in (("kernel", y), ("oracle", want)):
                e = (got.double() - y64).abs()
                worst[who] = float((e / terms.clamp_min(1e-300)).max())
                miss = int((e > tier["atol"] + tier["rtol"] * y64.abs())
                           .sum())
                log(f"  {who} vs float64: max_abs_err {float(e.max()):.3e}, "
                    f"{miss} elements outside {tier_name}, max err / "
                    f"sum|terms| {worst[who]:.3e}")
                if who == "kernel":
                    check(bool((e <= tier["atol"] + tier["rtol"] * terms)
                               .all()),
                          f"{name}: beyond {tier_name} of sum|terms| "
                          f"against float64")
            del d, y64, terms, e
        if dtype == torch.bfloat16 and g == 1 and regime == "typical":
            # the main path's case.  Bound: x, B, C, dt, A read once, y
            # written once; the causal pairs i >= j of each chunk for C B^T
            # and M x, plus the entering-state term and the state update
            nc, es = s // chunk, x.element_size()
            nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * es \
                + 4 * (b * s * h + h)
            flops = b * h * nc * (chunk * (chunk + 1) * (n + p)
                                  + 4 * chunk * p * n)
            bnd, by = bound(nbytes, flops, dtype)
            med = interleaved_medians(
                {"tensor cores": lambda: ssd_scan_cuda(x, dt, A, B, C,
                                                       chunk),
                 "CUDA cores": lambda: ssd_scan_cuda_cores(x, dt, A, B, C,
                                                           chunk)}, 3, 10)
            phases = device_us_by_kernel(
                lambda: ssd_scan_cuda(x, dt, A, B, C, chunk), 10)
            # the composed yardstick: the chunked form in bf16, its
            # products cuBLAS batched matmuls; no single PyTorch call
            composed = time_ms(lambda: ref.ssd_chunked(x, dt, A, B, C,
                                                       chunk), 5)
            _, composed_err = within(ref.ssd_chunked(x, dt, A, B, C,
                                                     chunk)[0], want, tier)
            plain = time_ms(lambda: ref.ssd_reference(x, dt, A, Bh, Ch), 1)
            log(f"  ms: tensor cores {med['tensor cores']:.4f}, CUDA cores "
                f"{med['CUDA cores']:.4f} (medians of 3 interleaved rounds "
                f"of 10); composed ref.ssd_chunked bf16 {composed:.4f} "
                f"(max_abs_err {composed_err:.3e}); plain_ms {plain:.3f}; "
                f"bound_ms {bnd:.4f} ({by})")
            log("  tensor-core route by kernel, us a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in phases.items()
                if k.startswith("ssd_")))
            common = dict(plain_ms=plain, bound_ms=bnd, bound_by=by,
                          library_ms=None, composed_ms=composed)
            recs["ssd_scan_sm90"] = dict(
                max_abs_err=errs["tensor cores"], ms=med["tensor cores"],
                phases_us={k: v for k, v in phases.items()
                           if k.startswith("ssd_")}, **common)
            recs["ssd_scan"] = dict(max_abs_err=errs["CUDA cores"],
                                    ms=med["CUDA cores"], **common)
        del xBC, x, B, C, Bh, Ch, y, want, outs
    return recs


def kernel_recovery_shapes(gen) -> dict:
    """The main-path kernels at the shapes phase 7 gives them after a shrink
    (each item two sequences): rmsnorm on 8192 rows of mamba2's 2560 and
    5120, and the tensor-core SSD scan at [2, 4096, 80, 64], n 128, chunk
    256, x, B and C views of one silu-activated activation; each against its
    plain version under the tier of phase 3.  Returns max_abs_err by name."""
    errs = {}
    for d in (2560, 5120):
        x = torch.randn(2 * 4096, d, generator=gen,
                        device="cuda").to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        ok, err = within(rmsnorm_cuda(x, scale, 1e-5),
                         ref.rmsnorm_reference(x, scale, 1e-5),
                         ops.TOLERANCE_TIERS["rmsnorm_bf16"])
        log(f"rmsnorm bf16 [8192, {d}]: max_abs_err {err:.3e} ok={ok}")
        check(ok, f"rmsnorm bf16 [8192, {d}] outside rmsnorm_bf16")
        errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), err)
    b, s, h, p, n, chunk = 2, 4096, 80, 64, 128, 256
    xBC = F.silu(torch.randn(b, s, h * p + 2 * n, generator=gen,
                             device="cuda")).to(torch.bfloat16)
    x = xBC[..., :h * p].reshape(b, s, h, p)
    B = xBC[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = xBC[..., h * p + n:].reshape(b, s, 1, n)
    dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    check(ssd_uses_sm90(torch.bfloat16, p, n, chunk),
          "the batch-2 SSD scan must take the tensor-core route")
    Bh, Ch = (t.repeat_interleave(h, dim=2) for t in (B, C))
    ok, err = within(ssd_scan_cuda(x, dt, A, B, C, chunk),
                     ref.ssd_reference(x, dt, A, Bh, Ch)[0],
                     ops.TOLERANCE_TIERS["ssd_scan_bf16"])
    log(f"ssd_scan bf16 [2, 4096, 80, 64] on the tensor cores: max_abs_err "
        f"{err:.3e} ok={ok}")
    check(ok, "ssd_scan bf16 at batch 2 outside ssd_scan_bf16")
    errs["ssd_scan_sm90"] = err
    return errs


def phase_tiny_twin(family: str) -> dict:
    """3 steps of a tiny float32 cluster on the card and on the CPU; returns
    the card's launch counts."""
    cfg = tiny_config(family)
    kw = dict(global_batch=8, num_micro=2, seq_len=16)
    cpu = VirtualCluster(cfg, 2, 2, device="cpu", **kw)
    init = params_to_numpy(cpu.stem, cpu.layer_params, cpu.head)
    gpu = VirtualCluster(cfg, 2, 2, device="cuda", init_params=init, **kw)
    _build.reset_launch_counts()
    for step in range(3):
        a, b = gpu.train_step(), cpu.train_step()
        check(abs(a - b) <= LOSS_ATOL + LOSS_RTOL * abs(b),
              f"tiny {family} twin step {step}: loss {a!r} vs cpu {b!r}")
        atol = PARAM_ATOL0 + 2.0 * gpu.adam.lr * gpu.opt_step
        worst = 0.0
        for sg, sc in zip(gpu.stages, cpu.stages):
            check(sg.sizes == sc.sizes and sg.entries == sc.entries,
                  f"tiny {family} twin stage structure differs")
            for c in ("master", "mu", "nu"):
                x, y = sg.full(c).cpu(), sc.full(c)
                check(torch.allclose(x, y, rtol=PARAM_RTOL, atol=atol),
                      f"tiny {family} twin step {step}: stage {c} beyond "
                      f"bounds")
                worst = max(worst, float((x - y).abs().max()))
        log(f"tiny {family} twin step {step}: loss card {a:.7f} cpu {b:.7f} "
            f"state max_abs_diff {worst:.3e} (atol {atol:.1e})")
    counts = dict(_build.LAUNCHES)
    log(f"tiny {family} twin launches on the card: {counts}")
    return counts


def _pin_planner_clock(cl: VirtualCluster, remaps: list) -> None:
    """Twin bookkeeping: the planner's measured wall clock is pinned to 0
    (so records compare exactly) and every live-remap plan is logged."""
    plan, compute = cl.engine.plan, cl.remapper.compute_plan
    cl.engine.plan = lambda *a, **k: dataclasses.replace(
        plan(*a, **k), plan_seconds=0.0)

    def logged(*a, **k):
        out = compute(*a, **k)
        remaps.append((out.moves, out.total_bytes, out.d2d_bytes,
                       out.h2d_bytes, out.est_seconds))
        return out
    cl.remapper.compute_plan = logged


def _twin_op(cl: VirtualCluster, op: tuple):
    name, *args = op
    if name == "train":
        return cl.train_step()
    if name == "corrupt":
        d, p = args
        return cl.snapshots[p].corrupt_shard(cl.stages[p].dp_ranks.index(d))
    if name == "detect_fail_stop":
        cl.inject_fail_stop(*args)
        return cl.detect_and_recover()
    if name in ("scale_out", "fail_slow", "drain"):
        return getattr(cl, {"scale_out": "recover_scale_out",
                            "fail_slow": "recover_fail_slow",
                            "drain": "drain_rank"}[name])(*args)
    if name == "burst_fail_stop":
        return cl.apply_event(ElasticEvent(EventKind.FAIL_STOP,
                                           cl.step_count, args[0]))
    kind, ranks = args
    return cl.apply_event(ElasticEvent(EventKind(kind), cl.step_count, ranks,
                                       freq=1.1))


def phase_tiny_recovery_twin(family: str) -> None:
    """The tiny float32 cluster (dp=4, pp=2, global batch 16) on the card
    and on the CPU through ``TWIN_SEQUENCE``: records, remap plans,
    integrity tiers and layouts equal exactly, losses and state within the
    kernel-consistency bounds after every step."""
    cfg = tiny_config(family, num_layers=8 if family == "dense" else 4)
    kw = dict(global_batch=16, num_micro=2, seq_len=16)
    cpu = VirtualCluster(cfg, 4, 2, device="cpu", **kw)
    init = params_to_numpy(cpu.stem, cpu.layer_params, cpu.head)
    gpu = VirtualCluster(cfg, 4, 2, device="cuda", init_params=init, **kw)
    logs = {"cpu": [], "cuda": []}
    tiers = {"cpu": [], "cuda": []}
    for dev, cl in (("cpu", cpu), ("cuda", gpu)):
        _pin_planner_clock(cl, logs[dev])
    orig = SnapshotPool.verify_and_repair
    try:
        for k, op in enumerate(TWIN_SEQUENCE):
            where = f"tiny {family} recovery twin op {k} {op}"
            out = {}
            for dev, cl in (("cpu", cpu), ("cuda", gpu)):
                def logged(self, *a, _t=tiers[dev], **kk):
                    res = orig(self, *a, **kk)
                    _t.append(res[0])
                    return res
                SnapshotPool.verify_and_repair = logged
                out[dev] = _twin_op(cl, op)
            if op[0] == "train":
                a, b = out["cuda"], out["cpu"]
                check(abs(a - b) <= LOSS_ATOL + LOSS_RTOL * abs(b),
                      f"{where}: loss {a!r} vs cpu {b!r}")
                atol = PARAM_ATOL0 + 2.0 * gpu.adam.lr * gpu.opt_step
                for sg, sc in zip(gpu.stages, cpu.stages):
                    for c in ("master", "mu", "nu"):
                        check(torch.allclose(sg.full(c).cpu(), sc.full(c),
                                             rtol=PARAM_RTOL, atol=atol),
                              f"{where}: stage {c} beyond bounds")
            else:
                check(out["cuda"] == out["cpu"],
                      f"{where}: records {out['cuda']} vs {out['cpu']}")
            check(gpu.layer_assignment == cpu.layer_assignment
                  and [s.dp_ranks for s in gpu.stages]
                  == [s.dp_ranks for s in cpu.stages]
                  and [s.entries for s in gpu.stages]
                  == [s.entries for s in cpu.stages]
                  and gpu.per_rank_mbs == cpu.per_rank_mbs
                  and gpu.grad_weights == cpu.grad_weights,
                  f"{where}: layouts differ")
            check(logs["cuda"] == logs["cpu"], f"{where}: remap plans differ")
            check(tiers["cuda"] == tiers["cpu"], f"{where}: tiers differ")
            check(op[0] == "corrupt" or snapshot_matches_device(gpu),
                  f"{where}: ring snapshot != device shards")
            check(all(t.device.type == "cuda" for st in gpu.stages
                      for t in st.flat.values()),
                  f"{where}: stage state left the card")
    finally:
        SnapshotPool.verify_and_repair = orig
    check("rebuilt" in tiers["cuda"] and "rederived" in tiers["cuda"],
          f"tiny {family} recovery twin: tiers {tiers['cuda']}")
    log(f"tiny {family} recovery twin: {len(gpu.recoveries)} recoveries, "
        f"{len(logs['cuda'])} remap plans, tiers {tiers['cuda']}, layout "
        f"{gpu.layer_assignment}, dp_ranks "
        f"{[s.dp_ranks for s in gpu.stages]}: card == cpu")


def snapshot_matches_device(cl: VirtualCluster) -> bool:
    for st, pool in zip(cl.stages, cl.snapshots):
        for c in ("master", "mu", "nu"):
            shards = st.table.split(st.flat[c].cpu().numpy())
            for i in range(pool.n):
                if not np.array_equal(pool.host[i][c],
                                      shards[pool.backup_rank(i)]):
                    return False
    return True


def phase_train(cfg, want: dict, **cluster_kw) -> tuple:
    """3 steps of ``VirtualCluster.train_step`` at dp=2, pp=2, global batch
    4 in 2 micro-batches, seq 4096, random weights from seed 1.  Returns
    the launch counts and the cluster."""
    t0 = time.perf_counter()
    cl = VirtualCluster(cfg, 2, 2, global_batch=4, num_micro=2, seq_len=4096,
                        device="cuda", **cluster_kw)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in cl._leaves)
    log(f"{cfg.name} ({cfg.num_layers} layers, dp=2, pp=2, seq 4096, "
        f"{cfg.dtype}): {n_params} params, stage sizes "
        f"{[s.total for s in cl.stages]}, "
        f"set-up {time.perf_counter() - t0:.1f} s")
    check(snapshot_matches_device(cl), "bootstrap snapshot != device state")
    _build.reset_launch_counts()
    for step in range(3):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = cl.train_step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        snap = cl.snapshot_seconds[-1]
        log(f"step {step}: loss {loss:.6f} ({loss!r}) step_s {dt:.3f} "
            f"snapshot_s {snap:.3f} (share {snap / dt:.3f}) "
            f"peak_mem_GB {torch.cuda.max_memory_allocated() / 1e9:.2f}")
        check(math.isfinite(loss), f"step {step}: loss not finite")
        check(snapshot_matches_device(cl),
              f"step {step}: host ring snapshot != device shards")
    launches = dict(_build.LAUNCHES)
    log(f"launches over 3 steps: {launches}")
    check(launches == want, f"launch counts {launches} != {want}")
    return launches, cl


def phase_recovery(cl: VirtualCluster) -> tuple:
    """Phase 7: ``RECOVERIES`` on the mamba2 cluster of phase 6, each
    followed by one train step.  Each phase of a recovery is timed by
    wrapping the instance's own method between ``torch.cuda.synchronize``
    calls.  Returns the launch counts over the 4 steps and one record per
    recovery."""
    timers: dict = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                timers[name] = timers.get(name, 0.0) \
                    + time.perf_counter() - t0
        return wrapper

    for attr, name in (("_verify_snapshot_sources", "verify"),
                       ("_live_remap_stage", "remap"),
                       ("_widen_stage", "remap"),
                       ("_apply_migrations", "migration"),
                       ("_apply_dataflow", "dataflow"),
                       ("_rebootstrap", "ring_bootstrap")):
        setattr(cl, attr, timed(name, getattr(cl, attr)))
    cl.comm.apply = timed("communicator", cl.comm.apply)
    plans = []
    plan = cl.engine.plan
    cl.engine.plan = lambda *a, **k: plans.append(plan(*a, **k)) or plans[-1]
    log(f"cost model: {H100_HW} (peak_flops, hbm_bw, hbm_bytes from the "
        f"H100 data sheet; link_bw, mfu, base_freq, max_freq are the "
        f"reference's model defaults)")
    out = []
    _build.reset_launch_counts()
    for name, recover, want_la, want_ranks, want_mbs in RECOVERIES:
        timers.clear()
        n_plans = len(plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = recover(cl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        ranks = [s.dp_ranks for s in cl.stages]
        check(rec is not None, f"{name}: no recovery ran")
        check(snapshot_matches_device(cl),
              f"{name}: host ring snapshot != device shards")
        check([tuple(r) for r in cl.layer_assignment] == want_la
              and ranks == want_ranks and cl.per_rank_mbs == want_mbs,
              f"{name}: layout {cl.layer_assignment} {ranks} "
              f"{cl.per_rank_mbs}, want {want_la} {want_ranks} {want_mbs}")
        if len(plans) > n_plans:                # a shrink: the engine's plan
            check(list(plans[-1].graph.stage_ranges) == want_la,
                  f"{name}: layout differs from the plan's "
                  f"{plans[-1].graph.stage_ranges}")
        check(all(t.device.type == "cuda" for st in cl.stages
                  for t in st.flat.values()),
              f"{name}: stage state left the card")
        sizes = [s.total for s in cl.stages]
        measured = {k: timers.get(k, 0.0) for k in (
            "verify", "communicator", "remap", "migration", "dataflow",
            "ring_bootstrap")}
        log(f"{name}: wall {wall:.3f} s, peak_mem_GB {peak:.2f}, measured "
            f"s: " + ", ".join(f"{k} {v:.4f}" for k, v in measured.items())
            + f", planner {rec['plan']:.4f}; layout {cl.layer_assignment} "
            f"dp_ranks {ranks} stage sizes {sizes}")
        log(f"  record (modeled seconds, except plan): {rec}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = cl.train_step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        snap = cl.snapshot_seconds[-1]
        step_peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  next step: loss {loss:.6f} ({loss!r}) step_s {dt:.3f} "
            f"snapshot_s {snap:.3f} (share {snap / dt:.3f}) peak_mem_GB "
            f"{step_peak:.2f}")
        check(math.isfinite(loss), f"{name}: next loss not finite")
        check(snapshot_matches_device(cl),
              f"{name}: next step's ring snapshot != device shards")
        out.append(dict(
            name=name, wall_s=wall, measured_s=measured,
            plan_s=rec["plan"], peak_mem_GB=peak,
            modeled_s={k: rec[k] for k in ("detect", "communicator", "remap",
                                           "migration", "verify",
                                           "overlap_saved")},
            rng_moves=rec["rng_moves"], degraded=rec["degraded"],
            layer_assignment=cl.layer_assignment, dp_ranks=ranks,
            stage_sizes=sizes, next_step_s=dt, next_snapshot_s=snap,
            next_snapshot_share=snap / dt, next_step_peak_mem_GB=step_peak,
            next_loss=loss))
    launches = dict(_build.LAUNCHES)
    log(f"launches over the 4 steps after recoveries: {launches}")
    check(launches == RECOVERY_LAUNCHES,
          f"launch counts {launches} != {RECOVERY_LAUNCHES}")
    return launches, out


def main() -> None:
    card = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = {"rmsnorm": kernel_rmsnorm(gen), **kernel_flash(gen)}
    cfg = codeqwen1p5_7b.config()
    # the larger stage of the dense phase: one layer + the head
    stage = cfg._block_params("attn") + cfg.d_model * cfg.vocab_size \
        + cfg.d_model
    recs["fused_adam"] = kernel_adam(gen, stage)
    recs.update(kernel_ssd(gen))
    torch.cuda.empty_cache()
    tiny = phase_tiny_twin("dense")
    check(tiny["flash_attention_sm90"] == 0 and tiny["flash_attention"] > 0,
          f"tiny dense twin (float32, head_dim 16) must take the CUDA-core "
          f"flash route only: {tiny}")
    tiny_ssm = phase_tiny_twin("ssm")
    check(tiny_ssm["ssd_scan_sm90"] == 0 and tiny_ssm["ssd_scan"] > 0,
          f"tiny ssm twin (float32) must take the CUDA-core SSD route only: "
          f"{tiny_ssm}")
    phase_tiny_recovery_twin("dense")
    phase_tiny_recovery_twin("ssm")
    shape_errs = kernel_recovery_shapes(gen)
    for name, err in shape_errs.items():
        recs[name]["recovery_shapes_max_abs_err"] = err
    torch.cuda.empty_cache()
    paths = {"codeqwen1.5-7b": phase_train(
        dataclasses.replace(cfg, num_layers=2), DENSE_LAUNCHES)[0]}
    gc.collect()                 # free the dense cluster's host and card state
    torch.cuda.empty_cache()
    paths["mamba2-2.7b"], ssm = phase_train(
        dataclasses.replace(mamba2_2p7b.config(), num_layers=4), SSM_LAUNCHES,
        hw=H100_HW)
    paths["mamba2-2.7b recovery"], recoveries = phase_recovery(ssm)
    del ssm
    kernels = [dict(name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1],
                    launches=sum(p[name] for p in paths.values()),
                    launches_by_path={k: p[name] for k, p in paths.items()},
                    **({"design": DESIGNS[name]} if name in DESIGNS else {}),
                    **recs[name]) for name in SOURCES]
    # the CUDA-core flash and SSD kernels are off the main paths (they
    # train in bf16); the tiny float32 twins are where they run
    by_name = {k["name"]: k for k in kernels}
    by_name["flash_attention"]["launches_by_path"][
        "tiny-dense twin (float32)"] = tiny["flash_attention"]
    by_name["ssd_scan"]["launches_by_path"][
        "tiny-ssm twin (float32)"] = tiny_ssm["ssd_scan"]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"recoveries": recoveries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
