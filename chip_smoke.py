#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device: the card's name and power limit (``nvidia-smi``); no card, exit 1;
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc),
   and the tensor-core kernels' SASS (``cuobjdump``) checked: bf16 flash
   at head_dim 64/128 for HGMMA in both forms and UTMALDG, float32 flash for
   HMMA.1688.F32.TF32 (mma.sync, TF32 in) with its instruction mix
   printed, bf16 flash at head_dim 16/32 and both SSD routes' three kernels
   (bf16 and float32) for HMMA.16816.F32.BF16 (bf16 in, float32
   accumulators) and LDGSTS (cp.async), the head_dim-32 flash kernel's and
   the float32 SSD route's instruction mixes printed, and every mma.sync
   flash and SSD kernel and the four dropout kernels (float32, bf16; 32-
   and 64-bit counters) for no local-memory traffic (spills), the dropout
   kernels also for 16-byte loads and stores (LDG.E.128, STG.E.128), the
   32-bit-counter ones' static ALU-pipe and multiply-add-pipe instructions
   an element and instruction mixes printed, and the CUDA-core SSD scan's
   16 builds (``ssd_scan.cu``) for no local-memory traffic and cp.async
   (LDGSTS) in their float32 builds;
3. every kernel against its plain PyTorch version on the card at the main
   paths' shapes (rmsnorm [4096, 4096]; flash attention [1, 4096, 32, 128]
   causal on all four routes: float32 on the 3xTF32 tensor-core route MHA
   and GQA, plus head_dim 16 and 64, ragged S 4000, bidirectional and a
   peaked softmax, each also against a float64 evaluation, with the
   CUDA-core kernel on the main case's inputs; bf16 at head_dim 16 and 32
   on the bf16 mma.sync route, each MHA and GQA, ragged S 4000,
   bidirectional, a peaked softmax and strided projection views, with the
   CUDA-core kernel on the MHA case's inputs; bf16 on the wgmma route MHA
   and GQA, plus head_dim 64, ragged S 4000, bidirectional, a peaked
   softmax and strided projection views; fused AdamW bitwise against the numpy
   oracle over 3 steps, at n % 4 != 0 and on views off a 16-byte boundary;
   the SSD scan at [1, 4096, 80, 64] with n 128, chunk 256, against the
   sequential oracle: bf16 on the bf16 tensor-core route, fp32 on the
   float32 tensor-core route, each with the CUDA-core kernel on the same
   inputs, with order-1 and small step sizes, and with 8 groups, the fp32
   cases also against the oracle in float64, with silu and signed
   inputs; the float32 route also at four narrower widths, p 16/32/48 and
   n 32/48/80/112, so that each of its builds is checked); the CUDA-core
   SSD kernel at the 20 widths of ``SSD_CC_WIDTHS`` (each of its builds,
   short last groups, element loads, bf16), then at the widths it serves,
   through ``ssd_scan_cuda``: narrow
   [1, 4096, 320, 16] with n 16, chunk 8 (mamba2's d_inner at the tiny
   configurations' SSD widths) and wide [1, 4096, 40, 128] with n 128,
   chunk 256, float32 silu, against the oracle and the float64 witness,
   the narrow widths also on signed inputs (witness only) and in bf16,
   each yardstick timed beside its bound and the composed
   ``ref.ssd_chunked`` with its kernels' device time a call), with kernel,
   plain-version and library-call times (rmsnorm and ``F.rms_norm``, each
   flash route and ``F.scaled_dot_product_attention`` interleaved, the
   bf16 mma.sync route with the CUDA-core kernel too; each SSD
   route beside
   the CUDA-core kernel and ``ref.ssd_chunked`` in the same dtype,
   composed of cuBLAS products); the content-addressed dropout kernel:
   threefry2x32's known answers on the host and on the card, then bit for
   bit against its plain version, output, gradient and mask, in float32
   and bf16 at rates 0.1 and 0.5, at [1, 4096, 4096] (codeqwen's
   activations), [2, 4096, 2560] (mamba2's at batch 2), an odd numel,
   four samples, three samples of n % 8 = 7 elements, and mamba2's shape
   3 elements off a 16-byte boundary, and past index 2**32 (the counter's
   high word), timed beside ``F.dropout`` (Philox bits: timed only) and
   the plain version;
4. a tiny dense and a tiny ssm cluster on the card against the same
   clusters on the CPU, for 3 steps each, within the reference's
   kernel-consistency bounds (the dense twin, float32 at head_dim 16,
   must take the 3xTF32 flash route only; the ssm twin, float32 at chunk
   8, the CUDA-core SSD kernel only); the float32 ssm twin at the smallest
   widths of the tensor-core SSD routes (headdim 64, state 64, chunk 64;
   seq 128) within the same bounds, every SSD launch on the float32
   tensor-core route; the same widths in bf16 (dense head_dim 64),
   within the bf16 twins' bound, every flash or SSD launch on the bf16
   tensor-core routes; the tiny dense config in bf16 at d_model 64 and 128
   (head_dim 16 and 32), within the same bound, every flash launch on the
   bf16 mma.sync route; then both float32 twins through the
   recovery sequence of ``tests/test_torch_recovery.py`` (fail-stop found
   by the probes with a corrupted snapshot, scale-out, fail-slow with a
   layer migration, drain with a corrupted snapshot, a two-rank burst,
   DVFS and OOM-risk events): records, remap plans, integrity tiers and
   layouts equal exactly, losses and state within the same bounds; the
   float32 tiny twins at dropout 0.1 (dense under both ``rng_mode``s, ssm,
   and the dense recovery sequence), within the same bounds, with the
   dropout-free twins' launches and exactly 192 / 192 / 96 / 1280 of the
   dropout kernel; and the
   main-path kernels at the shapes recovery gives them (batch-2 items:
   rmsnorm on 8192 rows of 2560 and 5120, the SSD scan at
   [2, 4096, 80, 64]) and rmsnorm in float32 at phase 8's [4096, 2560]
   and [4096, 5120], against their plain versions;
5. the dense main path: ``VirtualCluster.train_step`` on codeqwen1.5-7b at
   its published widths and dtype, depth cut to 2 layers, dp=2, pp=2, seq
   4096, for 2 steps, with exact kernel launch counts (every flash launch
   on the tensor-core route) and the host ring snapshot bitwise equal to
   the device shards after every step; then the same model at dropout 0.1
   (``rng_mode="reshard"``) for 2 steps, every dropout forward and backward
   on the dropout kernel (64 launches), its second step under
   ``torch.profiler``: device time by kind (each hand-written kernel,
   cuBLAS products, other ATen kernels, memcpy by direction) and the
   device-busy share from the step's start to the snapshot's;
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
8. the float32 ssm path: mamba2-2.7b at its widths in float32, depth cut
   to 2 layers, for 2 steps as phase 5 runs them, every SSD launch on the
   float32 tensor-core route;
9. the scenario engine on the card (``repro_torch.scenarios``): the
   kernel corpus of ``kernels/check.py`` (flash GQA causal and
   bidirectional at head_dim 32 on the 3xTF32 route, rmsnorm, the SSD scan
   at chunk 8 on the CUDA-core route, AdamW), every row within its tier;
   each of the library's six scenarios (tiny dense, 8 layers, dp 4, pp 2)
   through ``run_scenario`` with ``default_cluster_checkers(device="cuda")``:
   the card cluster held to its CPU twin under the kernel-consistency bounds
   after every event and step, dataflow, RNG and MTTR checked at every
   event and step, launch counts exact (derived from each step's items;
   every flash launch on the 3xTF32 route, dropout launches exactly where
   the rate is 0.1), printing losses, recoveries, modeled MTTR, the final
   DP width and the wall time; then shrink_regrow's trace shape (scale-in of
   rank (1, 1) at step 1, rejoin at step 2, horizon 4) on mamba2-2.7b at
   its widths in bf16, depth cut to 2 layers, through
   ``ClusterScenarioRunner`` with the dataflow, RNG and MTTR checkers and
   the ring snapshot equal to the device shards after every event and
   step, every SSD launch on ``ssd_scan_sm90``, printing step seconds,
   host-snapshot shares and recovery wall clocks; and the phase's wall
   time;
10. the trace fuzzer on the card (``repro_torch.scenarios.fuzz``): kernel
   seeds 0-11 (tiny dense or ssm: every flash launch on the 3xTF32 route,
   every SSD launch on the CUDA-core route at p 16, n 16, chunk 8) and
   cluster seeds 0-7 through ``run_case`` with the default card checkers
   (the card cluster held to its CPU twin under the kernel-consistency
   bounds, dataflow, RNG, MTTR), and chaos seeds 0, 1 and 3 through
   ``run_chaos_case`` (perturbed probes feed the controller; the
   ``corrupt`` class without the kernel-consistency twin), launch counts
   exact (``LaunchTally``), the kernel corpus spot check in the first case
   of each mode only; kernel seed 6's trace (a fail-stop of rank 0, then a
   fail-slow x1.5 of rank 1; dp 2, pp 1, dropout 0.1) on mamba2-2.7b at
   its widths in bf16, depth cut to 2 layers, with the dataflow, RNG and
   MTTR checkers and the ring snapshot equal to the device shards after
   every event and step, every SSD launch on ``ssd_scan_sm90``, printing
   step seconds, snapshot shares and recovery wall clocks; the two
   examples' functions on the card (``examples/torch_quickstart.py`` at its
   defaults, gated on its loss deviation below 1e-4;
   ``examples/torch_elastic_train.py`` at its default model for 30 steps,
   gated on finite losses and two recoveries), launches exact; the
   detector-only chaos sweep over 150 seeds; and the phase's wall time;
11. a JSON line with every kernel's numbers (each record's ``shape`` names
   the inputs its times were taken on), one with every recovery's, one
   with every scenario's, one with every fuzz run's, then the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
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
from repro_torch.core.invariants import (  # noqa: E402
    DataflowConsistencyChecker, InvariantChecker, KernelConsistencyChecker,
    MttrBoundChecker, RngConsistencyChecker, default_cluster_checkers)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.check import check_kernels  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_cuda_cores, uses_bf16_mma,
    uses_sm90, uses_tf32)
from repro_torch.kernels.fused_adam import fused_adam_cuda_  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan_cuda, ssd_scan_cuda_cores, uses_sm90 as ssd_uses_sm90,
    uses_sm90_f32 as ssd_uses_sm90_f32)
from repro_torch.kernels import threefry  # noqa: E402
from repro_torch.kernels.threefry import threefry_dropout_cuda  # noqa: E402
from repro_torch.models.registry import tiny_config  # noqa: E402
from repro_torch.optim.adam import AdamConfig, adam_update_flat_np  # noqa: E402
from repro_torch.scenarios import (SCENARIOS, ClusterScenarioRunner,  # noqa: E402
                                   ClusterWorkload, Scenario, get_scenario,
                                   make_case, make_kernel_case, run_case,
                                   run_chaos_case, run_detector_chaos,
                                   run_scenario)
from repro_torch.scenarios.fuzz import default_chaos_checkers  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# TF32 on the tensor cores, dense: float32-accurate products there take
# three TF32 products each (the float32 flash bound)
PEAK_TF32_OPS_PER_S = 494.7e12
# 32-bit integer operations on the CUDA cores: an SM issues one warp
# instruction a clock in each of its 4 schedulers, 128 lanes, and integer
# work fills them all, the ALU pipe's 64 lanes (logic, shifts, IADD3) and
# the multiply-add pipe's 64 (IMAD, which also adds and shifts left): the
# float32 rate's 128 lanes at one operation each, half of 67 TFLOP/s (132
# SMs, ~1.98 GHz)
PEAK_INT32_OPS_PER_S = 67e12 / 2
# the dropout mask's integer work an element: one threefry2x32 (20 rounds
# of add, rotate, xor and 12 key additions: 72) and the uniform's bits
# (xor of the two words, shift, or: 3); the sample-id fold (one hash a
# sample) is left out
THREEFRY_INT_OPS_PER_ELEMENT = 75
# SASS opcodes the ALU pipe issues (logic, shifts, three-input adds,
# compares, selects, permutes); every IMAD form goes to the multiply-add
# pipe
ALU_PIPE_OPS = ("LOP3", "SHF", "IADD3", "ISETP", "FSEL", "SEL", "PRMT",
                "LEA", "IMNMX", "FSETP", "PLOP3")
# 16-byte vectors a thread of the dropout kernel (kVectors)
DROPOUT_VECTORS = 4
# the kernels of csrc/, by the names the profiler gives them
HAND_WRITTEN_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_tf32_kernel",
                        "flash_fwd_bf16_mma_kernel", "flash_fwd_kernel",
                        "rmsnorm_kernel", "fused_adam_kernel",
                        "ssd_f32_chunk_state_kernel",
                        "ssd_f32_chunk_out_kernel", "ssd_chunk_state_kernel",
                        "ssd_chunk_out_kernel", "ssd_state_pass_kernel",
                        "ssd_cc_chunk_state_kernel", "ssd_cc_chunk_cb_kernel",
                        "ssd_cc_chunk_out_small_kernel",
                        "ssd_cc_chunk_out_large_kernel",
                        "threefry_dropout_kernel")
# the cost model of the ssm phases: the data sheet's figures; link_bw, mfu
# and the frequencies keep the reference's model defaults
H100_HW = HardwareSpec(peak_flops=PEAK_OPS_PER_S[torch.bfloat16],
                       hbm_bw=HBM_BYTES_PER_S, hbm_bytes=80e9)
# the float32 twins' bounds: KernelConsistencyChecker's (the reference's),
# losses by its loss_within, state vectors by its PARAM_RTOL and param_atol
KCC = KernelConsistencyChecker
# the bf16 twins' bound (tests/test_torch_bf16_twin.py): both sides round
# activations and gradients to bf16, at different places, so the float32
# bounds above do not apply.  Losses within one bf16 spacing (2**-7
# relative); master/mu/nu within 2**-7 relative on top of the step-sign
# allowance KCC.param_atol
BF16_LOSS_RTOL, BF16_PARAM_RTOL = 2.0 ** -7, 2.0 ** -7
# the bf16 tiny configurations on the tensor-core routes: flash_attention_sm90
# (head_dim 64) and ssd_scan_sm90 (headdim 64, state 64, chunk 64)
BF16_TWINS = {
    "dense": dict(dtype="bfloat16", d_model=256),
    "ssm": dict(dtype="bfloat16", ssm_headdim=64, ssm_state=64,
                ssm_chunk=64, num_layers=2),
}
# the bf16 tiny dense configurations at the mma.sync route's head_dims: the
# tiny config's 4 heads and 2 kv heads at d_model 64 and 128
# (tests/test_torch_bf16_twin.py "dense-hd16", "dense-hd32")
BF16_MMA_TWINS = {"bf16 hd16": dict(dtype="bfloat16"),
                  "bf16 hd32": dict(dtype="bfloat16", d_model=128)}
# the float32 tiny ssm twin on the float32 tensor-core SSD route
# (ssd_scan_sm90_f32): the bf16 ssm twin's widths in float32
F32_SM90_SSM_TWIN = dict(BF16_TWINS["ssm"], dtype="float32")

SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:22"),
    "flash_attention_sm90": (
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:78"),
    "flash_attention_tf32": (
        "src/repro_torch/kernels/csrc/flash_attention_tf32.cu",
        "src/repro/kernels/flash_attention.py:78"),
    "flash_attention_bf16_mma": (
        "src/repro_torch/kernels/csrc/flash_attention_bf16_mma.cu",
        "src/repro/kernels/flash_attention.py:78"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "fused_adam": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                   "src/repro/kernels/fused_adam.py:52"),
    "ssd_scan_sm90": ("src/repro_torch/kernels/csrc/ssd_scan_sm90.cu",
                      "src/repro/kernels/ssd_scan.py:78"),
    "ssd_scan_sm90_f32": ("src/repro_torch/kernels/csrc/ssd_scan_sm90_f32.cu",
                          "src/repro/kernels/ssd_scan.py:78"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:78"),
    # no Pallas counterpart: the reference's dropout is XLA's fused
    # threefry (repro.models.layers.dropout)
    "threefry_dropout": ("src/repro_torch/kernels/csrc/threefry_dropout.cu",
                         "src/repro/models/layers.py:50"),
}
DESIGNS = {
    "flash_attention_sm90": "bf16, head_dim 64/128: wgmma m64n128k16 for "
                            "Q.K^T and register-A wgmma for P.V (P as bf16 "
                            "hi + lo), K/V by TMA in a 2-stage mbarrier ring",
    "flash_attention_tf32": "float32, head_dim 16-128: mma.sync m16n8k8 as "
                            "3xTF32 (hi/lo split at fragment load), P.V "
                            "from the score accumulators, short fresh "
                            "accumulator chains, K/V by cp.async in two "
                            "stages",
    "flash_attention_bf16_mma": "bf16, head_dim 16/32: mma.sync m16n8k16 for "
                                "both products, P.V from the score "
                                "accumulators as bf16 hi + lo, K/V by "
                                "cp.async, ldmatrix (.trans for V)",
    "flash_attention": "only when launched explicitly (bf16 at head_dim "
                       "16/32, float32 at any): float32 FMAs on the CUDA "
                       "cores",
    "ssd_scan_sm90": "bf16, p <= 64, n <= 128, chunk % 64 == 0: "
                     "chunk-parallel (chunk_state, state_pass, chunk_out), "
                     "mma.sync m16n8k16 with float32 operands as three bf16 "
                     "pieces, x/B/C tiles through cp.async",
    "ssd_scan_sm90_f32": "float32, p <= 64, n <= 128, chunk % 64 == 0: "
                         "ssd_scan_sm90's chunk-parallel form, every product "
                         "as six bf16 mma.sync m16n8k16 cross terms of three "
                         "pieces a side, split at fragment load from float32 "
                         "tiles (cp.async), short accumulator chains",
    "ssd_scan": "the widths the tensor-core routes do not take (the tiny "
                "configurations' chunk 8, p > 64, p or n not a multiple of "
                "16): chunk-parallel on the CUDA cores, rows in groups of "
                "max(1, 64 / chunk) chunks (chunk_state, state pass over "
                "groups, chunk_out); chunk <= 64: a block walks its group's "
                "chunks with the state in registers, heads of one B/C group "
                "sharing a block; chunk > 64: C B^T once per (group, chunk) "
                "for all heads, then 64-row tiles, x by cp.async",
    "threefry_dropout": "no Pallas counterpart (the reference's dropout is "
                        "XLA's fused threefry): jax.random.bernoulli's masks "
                        "bit for bit, one threefry2x32 an element (funnel-"
                        "shift rotations, adds on the multiply-add pipe, a "
                        "32-bit counter where n <= 2**32) after one "
                        "sample-id fold a block, 4 vectors of 16 bytes a "
                        "thread with a scalar head and tail, one integer "
                        "keep test, scale by the jitted reference's "
                        "float32 reciprocal; forward and backward alike",
}
# exact launches over the steps of each main path (4 items a step): 2 of
# the dense path (cut from 3 when the dropout path joined, for time), 3
# of the ssm path; every flash launch of the bf16 models takes the
# tensor-core kernel
DENSE_LAUNCHES = {"rmsnorm": 40, "flash_attention": 0, "fused_adam": 4,
                  "ssd_scan": 0, "flash_attention_sm90": 16,
                  "ssd_scan_sm90": 0, "flash_attention_tf32": 0,
                  "ssd_scan_sm90_f32": 0, "flash_attention_bf16_mma": 0,
                  "threefry_dropout": 0}
# the same at dropout 0.1: per item and layer two dropouts (attention,
# MLP), each launched forward and backward: 2 layers x 2 ops x 2 x 4 items
# x 2 steps = 64
DENSE_DROPOUT_LAUNCHES = {**DENSE_LAUNCHES, "threefry_dropout": 64}
SSM_LAUNCHES = {"rmsnorm": 108, "flash_attention": 0, "fused_adam": 6,
                "ssd_scan": 0, "flash_attention_sm90": 0,
                "ssd_scan_sm90": 48, "flash_attention_tf32": 0,
                "ssd_scan_sm90_f32": 0, "flash_attention_bf16_mma": 0,
                "threefry_dropout": 0}
# exact launches over the 2 steps of the float32 mamba2 path (2 layers, 4
# items a step): per item one SSD scan a layer, two rmsnorms a layer (the
# block's norm and the gated out_norm) and the final norm; one fused AdamW
# per stage a step.  Every SSD launch takes the float32 tensor-core kernel.
SSM_F32_LAUNCHES = {"rmsnorm": 40, "flash_attention": 0, "fused_adam": 4,
                    "ssd_scan": 0, "flash_attention_sm90": 0,
                    "ssd_scan_sm90": 0, "flash_attention_tf32": 0,
                    "ssd_scan_sm90_f32": 16, "flash_attention_bf16_mma": 0,
                    "threefry_dropout": 0}
# exact launches over the 4 steps of phase 7: after a shrink each step is 2
# items of batch 2, after the scale-out 4 items of batch 1
RECOVERY_LAUNCHES = {"rmsnorm": 108, "flash_attention": 0, "fused_adam": 8,
                     "ssd_scan": 0, "flash_attention_sm90": 0,
                     "ssd_scan_sm90": 48, "flash_attention_tf32": 0,
                     "ssd_scan_sm90_f32": 0, "flash_attention_bf16_mma": 0,
                     "threefry_dropout": 0}
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
DROPOUT_RATE = 0.1
# exact dropout launches of the float32 twins at dropout 0.1, forward and
# backward: the tiny dense (4 layers x 2 ops) and ssm (4 layers x 1 op)
# twins take 4 items a step for 3 steps; the dense recovery twin (8 layers x
# 2 ops) 8, 6, 8, 8, 6 and 4 items over the sequence's 6 steps
DROPOUT_TWIN_LAUNCHES = {"dense": 2 * 4 * 2 * 4 * 3, "ssm": 2 * 4 * 1 * 4 * 3,
                         "dense recovery": 2 * 8 * 2 * 40}
# the dropout kernel's checks: (x shape, sample ids, the element offset of
# x and the cotangent into their buffers): codeqwen1.5-7b's activations,
# mamba2-2.7b's at batch 2, an odd numel, four samples, a sample of 93,391
# elements (n % 8 = 7: each sample's own head and tail, 12 bf16 tiles a
# sample) and mamba2's shape 3 elements off a 16-byte boundary (the scalar
# head in every sample)
DROPOUT_CASES = [((1, 4096, 4096), (12345,), 0),
                 ((2, 4096, 2560), (8, 9), 0),
                 ((3, 7, 33), (0, 1, 2 ** 31 - 1), 0),
                 ((4, 1000, 37), (5, 100003, 7, 300007), 0),
                 ((3, 1531, 61), (3, 2 ** 20, 65537), 0),
                 ((2, 4096, 2560), (8, 9), 3)]
# threefry2x32 known answers: (key, counter, output)
THREEFRY_KNOWN_ANSWERS = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0))]
# the tensor-core SSD scans' kernels: name -> (instances in the SASS,
# HMMA and LDGSTS expected); the state pass comes from the header both
# routes include (one copy each, and one in the CUDA-core ssd_scan.cu), the
# float32 route's chunk_out is built for each p / 16 (1-4)
SSD_SM90_KERNELS = {"ssd_chunk_state_kernel": (1, True),
                    "ssd_state_pass_kernel": (3, False),
                    "ssd_chunk_out_kernel": (1, True),
                    "ssd_f32_chunk_state_kernel": (1, True),
                    "ssd_f32_chunk_out_kernel": (4, True)}
# the CUDA-core SSD scan's kernels (ssd_scan.cu): name -> instances in the
# SASS (float32 and bf16 each; chunk_state for two thread tiles,
# chunk_out_small for TN 2/4/8/16, chunk_out_large once)
SSD_CC_KERNELS = {"ssd_cc_chunk_state_kernel": 4, "ssd_cc_chunk_cb_kernel": 2,
                  "ssd_cc_chunk_out_small_kernel": 8,
                  "ssd_cc_chunk_out_large_kernel": 2}
# the CUDA-core SSD route's yardsticks in phase 3 (float32, g 1, s 4096):
# name -> (h, p, n, chunk); main is mamba2-2.7b's widths, narrow its d_inner
# at the tiny configurations' SSD widths, wide head_dim 128 at its d_inner
SSD_CC_YARDSTICKS = {"main": (80, 64, 128, 256), "narrow": (320, 16, 16, 8),
                     "wide": (40, 128, 128, 256)}
# more widths the CUDA-core SSD kernel is held to in phase 3, so that each of
# its SSD_CC_KERNELS builds runs, with short last groups (chunks that do not
# divide 64), p and n off every multiple of 4 and 16, p tiles past 64, two
# and more B/C groups, batch 2, and element loads: (b, h, p, n, g, chunk,
# s, dtype, layout); layout "xbc": views of one activation, "sep":
# contiguous tensors, "off1": views one element off a 16-byte boundary.
# chunk_out_small's TN (threads a (head, p) pair) is 2 at n <= 16, 4 at
# n <= 32, 8 at n <= 64 and 16 above, in each dtype
F32, BF16 = torch.float32, torch.bfloat16
SSD_CC_WIDTHS = [
    (1, 8, 16, 16, 1, 8, 512, F32, "xbc"),
    (1, 8, 16, 16, 1, 8, 512, BF16, "xbc"),
    (1, 4, 8, 6, 2, 8, 256, F32, "xbc"),
    (1, 4, 24, 20, 1, 24, 240, F32, "xbc"),
    (1, 4, 24, 20, 1, 24, 264, F32, "sep"),
    (1, 2, 40, 24, 1, 96, 384, F32, "xbc"),
    (1, 2, 128, 32, 1, 32, 320, F32, "xbc"),
    (1, 3, 17, 5, 1, 7, 140, F32, "xbc"),
    (1, 2, 64, 128, 1, 256, 1024, F32, "xbc"),
    (1, 2, 130, 128, 2, 200, 800, F32, "sep"),
    (1, 4, 16, 128, 1, 1, 64, F32, "xbc"),
    (1, 4, 32, 64, 2, 64, 256, F32, "xbc"),
    (1, 1, 12, 16, 1, 256, 512, F32, "xbc"),
    (2, 4, 16, 16, 1, 8, 256, F32, "xbc"),
    (2, 4, 16, 16, 1, 8, 256, F32, "off1"),
    (1, 4, 64, 128, 1, 256, 512, BF16, "xbc"),
    (1, 4, 24, 20, 2, 24, 240, BF16, "off1"),
    (1, 2, 40, 24, 1, 96, 384, BF16, "off1"),
    (1, 4, 32, 64, 2, 64, 256, BF16, "xbc"),
    (1, 4, 16, 128, 1, 16, 128, BF16, "sep"),
]


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
    """Device microseconds a launch by kernel name, from ``torch.profiler``
    over ``iters`` calls of ``fn`` (each kernel's total over the launches the
    trace recorded, whose count is logged: a trace that drops events still
    gives each kernel's mean)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out, counts = {}, {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+)(?:<[^<>()]*>)?\(", e.key)
            name = name.group(1) if name else e.key
            out[name] = e.device_time_total / e.count
            counts[name] = e.count
    log(f"  profiler: launches recorded over {iters} calls: {counts}")
    return out


def bound(nbytes: float, ops_: float, dtype, peak: float = None) -> tuple:
    """The larger of the bytes' time at the HBM rate and the operations'
    at ``peak`` (default: the dtype's peak), in ms, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / (peak or PEAK_OPS_PER_S[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bound(b: int, s: int, h: int, g: int, p: int, n: int, chunk: int,
              elem: int) -> tuple:
    """Bytes and flops the SSD scan needs at least: x, B and C (``elem``
    bytes an element), dt and A read once, y written once; C B^T over the
    causal pairs i >= j of each chunk once per B/C group (every head of the
    group shares it), and per head M x over those pairs, the entering-state
    term and the state update."""
    pairs = chunk * (chunk + 1)
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * elem \
        + 4 * (b * s * h + h)
    flops = b * (s // chunk) * (g * pairs * n
                                + h * (pairs * p + 4 * chunk * p * n))
    return nbytes, flops


def within(a: torch.Tensor, b: torch.Tensor, tier: dict) -> tuple:
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= tier["atol"] + tier["rtol"] * b.abs()).all())
    return ok, float(err.max())


def tier_misses(a: torch.Tensor, b: torch.Tensor, tier: dict) -> tuple:
    """Elements of ``a`` outside ``tier`` of ``b`` (compared in float64),
    and the largest error as a share of its element's tolerance."""
    err = (a.double() - b.double()).abs()
    ratio = err / (tier["atol"] + tier["rtol"] * b.double().abs())
    return int((ratio > 1).sum()), float(ratio.max())


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


def phase_build() -> dict:
    """Builds the kernels, prints ptxas's registers and spills, checks the
    SASS; returns ``sass_check``'s dropout pipe counts."""
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.last_build_seconds:.1f} s)")
    for line in _build.last_build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "arning")):
            log("  " + line.strip())
    return sass_check()


def sass_of(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def parse_sass(sass: str) -> tuple:
    """Per kernel (mangled name): counts of the instructions the checks
    look for, and the static count of every opcode (with its modifiers)."""
    counts, mix, fn = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "HGMMA register A": 0, "UTMALDG": 0,
                          "HMMA bf16": 0, "HMMA tf32": 0, "LDGSTS": 0,
                          "LDL/STL": 0, "LDG.128": 0, "STG.128": 0}
            mix[fn] = {}
            continue
        if fn is None:
            continue
        op = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op:
            mix[fn][op.group(1)] = mix[fn].get(op.group(1), 0) + 1
        hgmma = re.search(r"HGMMA\.\S+\s+[^,]+,\s*([^,\s]+)", line)
        if hgmma:
            counts[fn]["HGMMA"] += 1
            counts[fn]["HGMMA register A"] += hgmma.group(1).startswith("R")
        counts[fn]["UTMALDG"] += "UTMALDG" in line
        counts[fn]["HMMA bf16"] += bool(
            re.search(r"\bHMMA\.16816\.F32\.BF16\b", line))
        counts[fn]["HMMA tf32"] += bool(
            re.search(r"\bHMMA\.1688\.F32\.TF32\b", line))
        counts[fn]["LDGSTS"] += bool(re.search(r"\bLDGSTS\b", line))
        counts[fn]["LDL/STL"] += bool(re.search(r"\b(LDL|STL)\b", line))
        counts[fn]["LDG.128"] += bool(re.search(r"\bLDG\.E\.128\b", line))
        counts[fn]["STG.128"] += bool(re.search(r"\bSTG\.E\.128\b", line))
    return counts, mix


def pipe_counts(mix: dict) -> tuple:
    """Static instructions of one kernel on the ALU pipe (ALU_PIPE_OPS)
    and on the multiply-add pipe (every IMAD form)."""
    alu = sum(v for op, v in mix.items() if op.split(".")[0] in ALU_PIPE_OPS)
    mad = sum(v for op, v in mix.items() if op.split(".")[0] == "IMAD")
    return alu, mad


def sass_check() -> dict:
    """The tensor-core kernels' machine code (``cuobjdump -sass`` of the
    built library).  bf16 flash must hold HGMMA for both products
    (shared-memory A for Q.K^T, register A for P.V) and UTMALDG (TMA
    loads).  float32 flash (one kernel per head_dim) must hold
    HMMA.1688.F32.TF32 (mma.sync, TF32 in, float32 accumulators) and
    LDGSTS, and its head_dim-128 kernel's instruction mix is printed.  bf16
    flash at head_dim 16/32 (one kernel per head_dim), and the SSD scan's
    chunk_state and chunk_out on both tensor-core routes (bf16 and
    float32), must hold HMMA.16816.F32.BF16 (mma.sync, bf16 in, float32
    accumulators) and LDGSTS (cp.async); the head_dim-32 flash kernel's and
    the float32 SSD route's instruction mixes are printed.  None of the
    mma.sync flash and SSD kernels may touch local memory (LDL/STL:
    spills).  The dropout kernel (float32 and bf16, each with a 32- and a
    64-bit counter) must not either, and must load and store 16-byte
    vectors (LDG.E.128, STG.E.128); the 32-bit-counter kernels' static
    ALU-pipe and multiply-add-pipe instructions an element are printed and
    returned, by dtype name, beside their instruction mixes."""
    counts, mix = parse_sass(sass_of(_build.build()))
    sm90 = {f: c for f, c in counts.items() if "flash_fwd_sm90_kernel" in f}
    check(len(sm90) == 2, f"expected 2 tensor-core flash kernels in the "
                          f"SASS, found {len(sm90)}")
    for f, c in sm90.items():
        log(f"  SASS {f[:90]}: {c}")
        check(c["HGMMA"] > c["HGMMA register A"] > 0 and c["UTMALDG"] > 0,
              f"{f}: HGMMA for both products and UTMALDG expected: {c}")
    tf32 = {f: c for f, c in counts.items() if "flash_fwd_tf32_kernel" in f}
    check(len(tf32) == 4, f"expected 4 float32 tensor-core flash kernels "
                          f"(head_dim 16-128) in the SASS, found {len(tf32)}")
    for f, c in tf32.items():
        hd = re.search(r"flash_fwd_tf32_kernelILi(\d+)E", f)
        log(f"  SASS flash_fwd_tf32_kernel<{hd.group(1) if hd else f}>: "
            f"HMMA.1688.F32.TF32 {c['HMMA tf32']}, LDGSTS {c['LDGSTS']}, "
            f"LDL/STL {c['LDL/STL']}")
        check(c["HMMA tf32"] > 0 and c["LDGSTS"] > 0 and c["LDL/STL"] == 0,
              f"{f}: HMMA.1688.F32.TF32 and LDGSTS and no LDL/STL expected: "
              f"{c}")
        if hd and hd.group(1) == "128":
            top = sorted(mix[f].items(), key=lambda kv: -kv[1])[:14]
            log("  flash_fwd_tf32_kernel<128> instruction mix (static "
                "count): " + ", ".join(f"{k} {v}" for k, v in top))
    mma = {f: c for f, c in counts.items()
           if "flash_fwd_bf16_mma_kernel" in f}
    check(len(mma) == 2, f"expected 2 bf16 mma.sync flash kernels (head_dim "
                         f"16, 32) in the SASS, found {len(mma)}")
    for f, c in mma.items():
        hd = re.search(r"flash_fwd_bf16_mma_kernelILi(\d+)E", f)
        log(f"  SASS flash_fwd_bf16_mma_kernel<{hd.group(1) if hd else f}>: "
            f"HMMA.16816.F32.BF16 {c['HMMA bf16']}, LDGSTS {c['LDGSTS']}, "
            f"LDL/STL {c['LDL/STL']}")
        check(c["HMMA bf16"] > 0 and c["LDGSTS"] > 0 and c["LDL/STL"] == 0,
              f"{f}: HMMA.16816.F32.BF16 and LDGSTS and no LDL/STL expected: "
              f"{c}")
        if hd and hd.group(1) == "32":
            top = sorted(mix[f].items(), key=lambda kv: -kv[1])[:14]
            log("  flash_fwd_bf16_mma_kernel<32> instruction mix (static "
                "count): " + ", ".join(f"{k} {v}" for k, v in top))
    for kernel, (instances, products) in SSD_SM90_KERNELS.items():
        found = sorted((f, c) for f, c in counts.items() if kernel in f)
        check(len(found) == instances, f"expected {instances} {kernel} in "
                                       f"the SASS, found {len(found)}")
        for f, c in found:
            # the float32 route's chunk_out is templated on p / 16: <4>
            # runs at mamba2's widths
            width = re.search(r"ILi(\d+)E", f)
            name = f"{kernel}<{width.group(1)}>" if width else kernel
            log(f"  SASS {name}: HMMA bf16 {c['HMMA bf16']}, LDGSTS "
                f"{c['LDGSTS']}, LDL/STL {c['LDL/STL']}")
            check(c["LDL/STL"] == 0, f"{name}: local-memory traffic: {c}")
            if products:
                check(c["HMMA bf16"] > 0 and c["LDGSTS"] > 0,
                      f"{name}: HMMA.16816.F32.BF16 and LDGSTS expected: "
                      f"{c}")
            if name in ("ssd_f32_chunk_state_kernel",
                        "ssd_f32_chunk_out_kernel<4>"):
                top = sorted(mix[f].items(), key=lambda kv: -kv[1])[:14]
                log(f"  {name} instruction mix (static count): "
                    + ", ".join(f"{k} {v}" for k, v in top))
    for kernel, instances in SSD_CC_KERNELS.items():
        found = sorted((f, c) for f, c in counts.items() if kernel in f)
        check(len(found) == instances, f"expected {instances} {kernel} in "
                                       f"the SASS, found {len(found)}")
        f32 = [c for f, c in found if "nv_bfloat16" not in f]
        log(f"  SASS {kernel} ({len(found)} builds): LDL/STL "
            f"{sum(c['LDL/STL'] for _, c in found)}, LDGSTS in the float32 "
            f"builds {[c['LDGSTS'] for c in f32]}")
        check(all(c["LDL/STL"] == 0 for _, c in found),
              f"{kernel}: local-memory traffic")
        check(all(c["LDGSTS"] > 0 for c in f32),
              f"{kernel}: float32 builds without cp.async (LDGSTS)")
    drop = sorted((f, c) for f, c in counts.items()
                  if "threefry_dropout_kernel" in f)
    check(len(drop) == 4, f"expected 4 threefry_dropout_kernel (float32, "
                          f"bf16; 32- and 64-bit counters) in the SASS, "
                          f"found {len(drop)}")
    pipes = {}
    for f, c in drop:
        bf16 = "nv_bfloat16" in f
        narrow = re.search(r"Lb1E", f) is not None
        name = (f"threefry_dropout_kernel<{'bf16' if bf16 else 'float32'}, "
                f"{'32' if narrow else '64'}-bit counter>")
        log(f"  SASS {name}: LDL/STL {c['LDL/STL']}, LDG.E.128 "
            f"{c['LDG.128']}, STG.E.128 {c['STG.128']}, "
            f"{sum(mix[f].values())} instructions")
        check(c["LDL/STL"] == 0, f"{name}: local-memory traffic: {c}")
        check(c["LDG.128"] > 0 and c["STG.128"] > 0,
              f"{name}: 128-bit global loads and stores expected: {c}")
        if narrow:
            per = DROPOUT_VECTORS * (8 if bf16 else 4)
            alu, mad = pipe_counts(mix[f])
            pipes["bf16" if bf16 else "float32"] = (alu / per, mad / per)
            top = sorted(mix[f].items(), key=lambda kv: -kv[1])[:16]
            log(f"  {name}: static ALU pipe {alu} ({alu / per:.2f} an "
                f"element), multiply-add pipe {mad} ({mad / per:.2f} an "
                f"element) over {per} elements a thread, with the sample "
                f"fold and the scalar head and tail (one rolled hash "
                f"each); mix: " + ", ".join(f"{k} {v}" for k, v in top))
    return pipes


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
            rec = dict(shape=f"bfloat16 [{rows}, {d}]",
                       max_abs_err=err, ms=med["kernel"],
                       plain_ms=time_ms(lambda: ref.rmsnorm_reference(
                           x, scale, eps), 20),
                       bound_ms=b, bound_by=by, library_ms=med["library"])
    return rec


def kernel_flash(gen) -> dict:
    """Flash attention at codeqwen's widths against the plain version under
    the unchanged tiers, on all four routes: float32 on the 3xTF32
    tensor-core route (MHA as on a float32 run of the model, GQA, head_dim
    16 and 64, ragged S, bidirectional, a peaked softmax), bf16 at head_dim
    32 and 16 on the bf16 mma.sync route (MHA, GQA, ragged S,
    bidirectional, a peaked softmax, and q/k/v as strided views of one
    fused projection), and bf16 on the wgmma route (MHA as on the main
    path, GQA, head_dim 64, ragged S, bidirectional, a peaked softmax, and
    the projection views).  Every call must launch its route's kernel once
    and nothing else.

    Every float32 case is also held to the ``flash_attention`` tier against
    the plain version evaluated in float64 on the same inputs.  At q x 4
    the float32 plain version is itself as far from that evaluation as the
    tier (its scores carry float32 rounding of dot products up to ~200), so
    that case is gated against float64 alone and its misses against the
    float32 plain version are printed beside the plain version's own.  On
    the main float32 case and on the MHA bf16 cases at head_dim 16/32 the
    CUDA-core kernel runs on the same inputs.  Each route is timed at its
    own main case beside SDPA: the wgmma and 3xTF32 routes at head_dim 128,
    the bf16 mma.sync route at head_dim 32 and 16 (with the CUDA-core
    kernel interleaved).  Returns the records of the float32 route, the
    bf16 mma.sync route, the CUDA-core kernel and the wgmma route."""
    B, S, H, hd = 1, 4096, 32, 128
    recs = {}
    cores_fp32 = {}     # the CUDA-core kernel on the float32 main case
    small = {}          # head_dim -> the bf16 mma.sync route's numbers
    cases = (  # dtype, S, Hkv, hd, causal, q scale, layout
        (torch.float32, S, H, hd, True, 1.0, "dense"),
        (torch.float32, S, 8, hd, True, 1.0, "dense"),
        (torch.float32, S, H, 16, True, 1.0, "dense"),
        (torch.float32, S, H, 64, True, 1.0, "dense"),
        (torch.float32, 4000, H, hd, True, 1.0, "dense"),
        (torch.float32, S, H, hd, False, 1.0, "dense"),
        (torch.float32, S, H, hd, True, 4.0, "dense"),
        *((torch.bfloat16, s_, kv_, d_, c_, qs_, lay_) for d_ in (32, 16)
          for s_, kv_, c_, qs_, lay_ in (
              (S, H, True, 1.0, "dense"), (S, 8, True, 1.0, "dense"),
              (4000, H, True, 1.0, "dense"), (S, H, False, 1.0, "dense"),
              (S, H, True, 4.0, "dense"), (S, 8, True, 1.0, "projection"))),
        (torch.bfloat16, S, H, hd, True, 1.0, "dense"),
        (torch.bfloat16, S, 8, hd, True, 1.0, "dense"),
        (torch.bfloat16, S, H, 64, True, 1.0, "dense"),
        (torch.bfloat16, 4000, H, hd, True, 1.0, "dense"),
        (torch.bfloat16, S, H, hd, False, 1.0, "dense"),
        (torch.bfloat16, S, H, hd, True, 4.0, "dense"),
        (torch.bfloat16, S, 8, hd, True, 1.0, "projection"),
    )
    for dtype, s, Hkv, d, causal, qscale, layout in cases:
        tier_name = "flash_attention" if dtype == torch.float32 \
            else "flash_attention_bf16"
        tier = ops.TOLERANCE_TIERS[tier_name]
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
        route = next(r for r, uses in (("sm90", uses_sm90),
                                       ("tf32", uses_tf32),
                                       ("bf16_mma", uses_bf16_mma))
                     if uses(dtype, d))
        name = (f"flash {route} {dtype} S={s} H={H} Hkv={Hkv} hd={d} "
                f"causal={causal} q*{qscale:g} {layout}")
        want = ref.gqa_attention_reference(q, k, v, causal=causal)
        before = dict(_build.LAUNCHES)
        o = flash_attention_cuda(q, k, v, causal)
        moved = {n: c - before[n] for n, c in _build.LAUNCHES.items()
                 if c != before[n]}
        check(moved == {f"flash_attention_{route}": 1},
              f"{name}: launched {moved}")
        ok, err = within(o, want, tier)
        if dtype == torch.float32:
            want64 = ref.gqa_attention_reference(
                q.double(), k.double(), v.double(), causal=causal)
            ok64, err64 = within(o, want64, tier)
            miss, worst = tier_misses(o, want, tier)
            miss64, worst64 = tier_misses(o, want64, tier)
            pmiss64, pworst64 = tier_misses(want, want64, tier)
            log(f"{name}: max_abs_err {err:.3e} ({miss} outside {tier_name},"
                f" worst {worst:.3f} of it); vs float64 {err64:.3e} "
                f"({miss64}, worst {worst64:.3f}); the plain version vs "
                f"float64: {pmiss64} outside, worst {pworst64:.3f}")
            check(ok64, f"{name} outside {tier_name} of float64")
            if qscale == 1.0:
                check(ok, f"{name} outside {tier_name}")
            del want64
        else:
            log(f"{name}: max_abs_err {err:.3e} tier {tier_name} ok={ok}")
            check(ok, f"{name} outside {tier_name}")
        # time the main case of each route: MHA, causal, head_dim 128 on
        # the wgmma and 3xTF32 routes, head_dim 32 and 16 on the bf16
        # mma.sync route
        if layout != "dense" or s != S or not causal or qscale != 1.0 \
                or Hkv != H or (d != hd and route != "bf16_mma"):
            del q, k, v, o, want
            continue
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        shape = f"{str(dtype)[6:]} q, k, v [{B}, {s}, {H}, {d}] causal"
        fns = {"kernel": lambda: flash_attention_cuda(q, k, v, True),
               "library": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True)}
        if route == "bf16_mma":
            fns["cuda cores"] = lambda: flash_attention_cuda_cores(
                q, k, v, True)
        # kernel and library call (and the CUDA-core kernel on the bf16
        # mma.sync route's inputs) in turn, 5 rounds of 10 launches
        med = interleaved_medians(fns, 5, 10)
        plain = time_ms(lambda: ref.gqa_attention_reference(
            q, k, v, causal=True), 3)
        pairs = B * H * S * (S + 1) // 2
        nbytes = (2 * B * S * H * d + 2 * B * S * Hkv * d) * q.element_size()
        if route == "tf32":
            # float32 accuracy on the tensor cores: three TF32 products
            # per multiply-add; the CUDA cores' float32 bound beside it
            b, by = bound(nbytes, 3 * 4 * hd * pairs, dtype,
                          PEAK_TF32_OPS_PER_S)
            b_cores, _ = bound(nbytes, 4 * hd * pairs, dtype)
            cores = flash_attention_cuda_cores(q, k, v, True)
            ok_c, err_c = within(cores, want, tier)
            log(f"  CUDA-core kernel on the same inputs: max_abs_err "
                f"{err_c:.3e} ok={ok_c}")
            check(ok_c, "the CUDA-core float32 flash kernel outside "
                        "flash_attention")
            cores_ms = time_ms(lambda: flash_attention_cuda_cores(
                q, k, v, True), 10)
            by_kernel = device_us_by_kernel(
                lambda: flash_attention_cuda(q, k, v, True), 10)
            log(f"  ms (medians of 5 interleaved rounds of 10): 3xTF32 "
                f"{med['kernel']:.4f}, F.scaled_dot_product_attention "
                f"{med['library']:.4f}; CUDA-core kernel {cores_ms:.4f}; "
                f"plain_ms {plain:.3f}; bound_ms {b:.4f} ({by}, three TF32 "
                f"products at {PEAK_TF32_OPS_PER_S / 1e12:g} TFLOP/s; "
                f"{b_cores:.4f} at the CUDA cores' "
                f"{PEAK_OPS_PER_S[dtype] / 1e12:g})")
            log("  3xTF32 route by kernel, us a call: " + ", ".join(
                f"{k_} {v_:.1f}" for k_, v_ in by_kernel.items()))
            common = dict(plain_ms=plain, bound_ms=b, bound_by=by,
                          library_ms=med["library"],
                          cuda_core_bound_ms=b_cores)
            recs["flash_attention_tf32"] = dict(
                shape=shape, max_abs_err=err, ms=med["kernel"],
                max_abs_err_float64=err64, device_us_by_kernel=by_kernel,
                by_kernel_per="launch the profiler recorded", **common)
            cores_fp32 = dict(fp32_hd128_shape=shape, fp32_hd128_ms=cores_ms,
                              fp32_hd128_max_abs_err=err_c)
            del cores
        else:
            b, by = bound(nbytes, 4 * d * pairs, dtype)
            rec = dict(shape=shape, max_abs_err=err, ms=med["kernel"],
                       plain_ms=plain, bound_ms=b, bound_by=by,
                       library_ms=med["library"])
            cores_note = ""
            if route == "bf16_mma":
                cores = flash_attention_cuda_cores(q, k, v, True)
                ok_c, err_c = within(cores, want, tier)
                check(ok_c, f"the CUDA-core bf16 flash kernel at head_dim "
                            f"{d} outside flash_attention_bf16")
                rec.update(cuda_core_ms=med["cuda cores"],
                           cuda_core_max_abs_err=err_c)
                cores_note = (f" CUDA-core kernel {med['cuda cores']:.4f} "
                              f"(max_abs_err {err_c:.3e})")
                small[d] = rec
                del cores
            else:
                recs["flash_attention_sm90"] = rec
            log(f"  {route} hd {d}: ms {med['kernel']:.4f} (median of 5 "
                f"interleaved rounds of 10){cores_note} plain_ms "
                f"{plain:.3f} library_ms {med['library']:.4f} "
                f"(F.scaled_dot_product_attention) bound_ms {b:.4f} ({by})")
        del q, k, v, o, want, qt, kt, vt
    # the bf16 mma.sync route's record: head_dim 32, head_dim 16 beside it;
    # the CUDA-core kernel's: its own times on the same bf16 inputs, and on
    # the float32 main case's
    recs["flash_attention_bf16_mma"] = dict(small[32], head_dim_16=small[16])
    main32 = small[32]
    recs["flash_attention"] = dict(
        shape=main32["shape"], max_abs_err=main32["cuda_core_max_abs_err"],
        ms=main32["cuda_core_ms"], plain_ms=main32["plain_ms"],
        bound_ms=main32["bound_ms"], bound_by=main32["bound_by"],
        library_ms=main32["library_ms"],
        bf16_hd16_ms=small[16]["cuda_core_ms"], **cores_fp32)
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
    return dict(shape=f"float32 flat [{n}]", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)


def kernel_ssd(gen) -> dict:
    """The SSD scan at mamba2-2.7b's widths, x, B and C as views of one
    activation as in the model.  Two step-size regimes: dt of order 1 with
    the init's A (the state decays within a chunk), and dt in [1e-3, 1e-1]
    with |A| <= 1 (the state carries across all 16 chunks).  bf16 goes
    through ``ssd_scan_cuda`` to the bf16 tensor-core route, float32 to the
    float32 one; on the same inputs the CUDA-core kernel is launched too
    (``ssd_scan_cuda_cores``), so both routes are held to the tier, and in
    each dtype the g 1 "typical" silu case is timed.  Returns the records of
    the three kernels.

    The gate is the tier against the float32 oracle on silu-activated x, B
    and C, the main path's inputs (``apply_mamba`` applies silu to xBC
    before the scan).  Every float32 case also meets a float64 witness, on
    both routes: the oracle in float64 on the same inputs, with the error
    held to the ``ssd_scan`` tier scaled by the sum of the magnitudes of y's
    terms (the oracle on |x|, |B|, |C|), which is what float32 rounding
    scales with.  Signed normal inputs, as the reference's kernel corpus
    uses, cancel to y ~ 0 where those terms reach hundreds; there no float32
    summation meets the elementwise tier, so they are held to the witness
    alone and their elementwise misses are printed.

    Four more silu cases run the float32 route at narrower widths no model
    of the repo has, so that each build of its chunk_out (p / 16 = 1, 2, 3)
    and chunk_state's partial n tiles (n not a multiple of 64) are held to
    the same oracle and witness: (h, p, n, chunk) = (24, 16, 32, 64),
    (24, 32, 48, 128), (24, 48, 80, 192), (24, 48, 112, 256), each over
    the most rows up to 4096 that whole chunks hold."""
    b = 1
    main = (80, 64, 128, 256)        # h, p, n, chunk: mamba2-2.7b's
    recs = {"ssd_scan": {}}
    for dtype, g, regime, act, widths in (
            (torch.bfloat16, 1, "typical", "silu", main),
            (torch.bfloat16, 1, "carried", "silu", main),
            (torch.bfloat16, 8, "typical", "silu", main),
            (torch.float32, 1, "typical", "silu", main),
            (torch.float32, 1, "carried", "silu", main),
            (torch.float32, 8, "carried", "silu", main),
            (torch.float32, 1, "typical", "signed", main),
            (torch.float32, 8, "carried", "signed", main),
            (torch.float32, 1, "typical", "silu", (24, 16, 32, 64)),
            (torch.float32, 4, "carried", "silu", (24, 32, 48, 128)),
            (torch.float32, 2, "typical", "silu", (24, 48, 80, 192)),
            (torch.float32, 1, "carried", "silu", (24, 48, 112, 256))):
        h, p, n, chunk = widths
        s = 4096 // chunk * chunk
        f32 = dtype == torch.float32
        tier_name = "ssd_scan" if f32 else "ssd_scan_bf16"
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
        route = "ssd_scan_sm90_f32" if f32 else "ssd_scan_sm90"
        check(ssd_uses_sm90_f32(dtype, p, n, chunk) == f32
              and ssd_uses_sm90(dtype, p, n, chunk) == (not f32),
              f"ssd_scan_cuda routes {dtype} to the wrong kernel")
        before = _build.LAUNCHES[route]
        y = ssd_scan_cuda(x, dt, A, B, C, chunk)
        check(_build.LAUNCHES[route] == before + 1,
              f"ssd_scan_cuda did not launch {route} for {dtype}")
        Bh, Ch = (t.repeat_interleave(h // g, dim=2) for t in (B, C))
        want = ref.ssd_reference(x, dt, A, Bh, Ch)[0]
        name = f"ssd_scan {dtype} g={g} {regime} {act}" + (
            "" if widths == main
            else f" s={s} h={h} p={p} n={n} chunk={chunk}")
        outs = {"tensor cores": y,
                "CUDA cores": ssd_scan_cuda_cores(x, dt, A, B, C, chunk)}
        errs = {}
        for where, got in outs.items():
            ok, errs[where] = within(got, want, tier)
            log(f"{name} on the {where}: max_abs_err {errs[where]:.3e} (max "
                f"|y| {float(want.float().abs().max()):.2f}) tier "
                f"{tier_name} ok={ok}")
            if act == "silu":
                check(ok, f"{name} on the {where} outside {tier_name}")
        diff = (y.float() - outs["CUDA cores"].float()).abs().max()
        log(f"  tensor cores vs CUDA cores: max_abs_diff {float(diff):.3e}")
        if f32:
            d = [t.double() for t in (x, dt, A, Bh, Ch)]
            y64 = ref.ssd_reference(*d)[0]
            terms = ref.ssd_reference(d[0].abs(), d[1], d[2], d[3].abs(),
                                      d[4].abs())[0]
            for who, got in (("tensor cores", y),
                             ("CUDA cores", outs["CUDA cores"]),
                             ("oracle", want)):
                e = (got.double() - y64).abs()
                worst = float((e / terms.clamp_min(1e-300)).max())
                miss = int((e > tier["atol"] + tier["rtol"] * y64.abs())
                           .sum())
                log(f"  {who} vs float64: max_abs_err {float(e.max()):.3e}, "
                    f"{miss} elements outside {tier_name}, max err / "
                    f"sum|terms| {worst:.3e}")
                if who != "oracle":
                    check(bool((e <= tier["atol"] + tier["rtol"] * terms)
                               .all()),
                          f"{name} on the {who}: beyond {tier_name} of "
                          f"sum|terms| against float64")
            del d, y64, terms, e
        if widths == main and g == 1 and regime == "typical" \
                and act == "silu":
            # Bound: ssd_bound's work.  float32 accuracy on the tensor
            # cores takes six bf16 products per multiply-add (the route's
            # design), so its bound is that work at the bf16 peak; the CUDA
            # cores' float32 bound is printed beside it
            nbytes, flops = ssd_bound(b, s, h, g, p, n, chunk,
                                      x.element_size())
            if f32:
                bnd, by = bound(nbytes, 6 * flops, dtype,
                                PEAK_OPS_PER_S[torch.bfloat16])
                b_cores, _ = bound(nbytes, flops, dtype)
            else:
                bnd, by = bound(nbytes, flops, dtype)
            med = interleaved_medians(
                {"tensor cores": lambda: ssd_scan_cuda(x, dt, A, B, C,
                                                       chunk),
                 "CUDA cores": lambda: ssd_scan_cuda_cores(x, dt, A, B, C,
                                                           chunk)}, 3, 10)
            phases = {k: v for k, v in device_us_by_kernel(
                lambda: ssd_scan_cuda(x, dt, A, B, C, chunk), 10).items()
                if k.startswith("ssd_")}
            # the composed yardstick: the chunked form in x's dtype, its
            # products cuBLAS batched matmuls (float32 ones in full float32:
            # main sets allow_tf32 False); no single PyTorch call
            composed = time_ms(lambda: ref.ssd_chunked(x, dt, A, B, C,
                                                       chunk), 5)
            _, composed_err = within(ref.ssd_chunked(x, dt, A, B, C,
                                                     chunk)[0], want, tier)
            plain = time_ms(lambda: ref.ssd_reference(x, dt, A, Bh, Ch), 1)
            cores_note = (f"; {b_cores:.4f} at the CUDA cores' "
                          f"{PEAK_OPS_PER_S[dtype] / 1e12:g} TFLOP/s"
                          if f32 else "")
            log(f"  {dtype} ms: tensor cores {med['tensor cores']:.4f}, CUDA "
                f"cores {med['CUDA cores']:.4f} (medians of 3 interleaved "
                f"rounds of 10); composed ref.ssd_chunked {composed:.4f} "
                f"(max_abs_err {composed_err:.3e}); plain_ms {plain:.3f}; "
                f"bound_ms {bnd:.4f} ({by}){cores_note}")
            log("  tensor-core route by kernel, us a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in phases.items()))
            shape = (f"{str(dtype)[6:]} x [{b}, {s}, {h}, {p}], B, C "
                     f"[{b}, {s}, {g}, {n}], chunk {chunk}")
            common = dict(plain_ms=plain, bound_ms=bnd, bound_by=by,
                          library_ms=None, composed_ms=composed)
            recs[route] = dict(shape=shape, max_abs_err=errs["tensor cores"],
                               ms=med["tensor cores"], phases_us=phases,
                               by_kernel_per="launch the profiler recorded",
                               **common)
            if f32:
                # the CUDA-core kernel's record: its own dtype's inputs,
                # its bound at the CUDA cores' float32 peak
                recs[route]["cuda_core_bound_ms"] = b_cores
                cc_phases = {k: v for k, v in device_us_by_kernel(
                    lambda: ssd_scan_cuda_cores(x, dt, A, B, C, chunk),
                    10).items() if k.startswith("ssd_")}
                log("  CUDA-core kernel by kernel, us a call: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in cc_phases.items()))
                recs["ssd_scan"].update(
                    shape=shape, max_abs_err=errs["CUDA cores"],
                    ms=med["CUDA cores"], plain_ms=plain, bound_ms=b_cores,
                    bound_by="operations", library_ms=None,
                    composed_ms=composed, phases_us=cc_phases,
                    by_kernel_per="launch the profiler recorded")
                recs["ssd_scan"].setdefault("yardsticks", {})["main"] = dict(
                    shape=shape, ms=med["CUDA cores"], bound_ms=b_cores,
                    bound_by="operations", composed_ms=composed,
                    phases_us=cc_phases, max_abs_err=errs["CUDA cores"],
                    share_of_bound=b_cores / med["CUDA cores"])
            else:
                recs["ssd_scan"].update(bf16_inputs_shape=shape,
                                        bf16_inputs_ms=med["CUDA cores"],
                                        bf16_inputs_max_abs_err=errs[
                                            "CUDA cores"])
        del xBC, x, B, C, Bh, Ch, y, want, outs
    recs["ssd_scan"].setdefault("yardsticks", {}).update(
        kernel_ssd_cuda_cores(gen))
    return recs


def ssd_cc_widths(gen) -> dict:
    """The CUDA-core SSD kernel against the float32 sequential oracle at
    each of ``SSD_CC_WIDTHS`` (silu inputs, dt of order 1), within its
    dtype's tier.  Returns each width's worst error over its tolerance."""
    out = {}
    for b, h, p, n, g, chunk, s, dtype, layout in SSD_CC_WIDTHS:
        width = h * p + 2 * g * n
        off = 1 if layout == "off1" else 0
        flat = F.silu(torch.randn(b * s * width + off, generator=gen,
                                  device="cuda")).to(dtype)
        xBC = flat[off:].view(b, s, width)
        x = xBC[..., :h * p].reshape(b, s, h, p)
        B = xBC[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xBC[..., h * p + g * n:].reshape(b, s, g, n)
        if layout == "sep":
            x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
        dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        y = ssd_scan_cuda_cores(x, dt, A, B, C, chunk)
        Bh, Ch = (t.repeat_interleave(h // g, dim=2) for t in (B, C))
        want = ref.ssd_reference(x, dt, A, Bh, Ch)[0]
        tier = ops.TOLERANCE_TIERS["ssd_scan" if dtype == torch.float32
                                   else "ssd_scan_bf16"]
        ok, err = within(y, want, tier)
        _, worst = tier_misses(y, want, tier)
        label = (f"b {b} h {h} p {p} n {n} g {g} chunk {chunk} s {s} "
                 f"{str(dtype)[6:]} {layout}")
        log(f"ssd_scan CUDA cores at {label}: max_abs_err {err:.3e}, worst "
            f"error / tolerance {worst:.3f}, ok={ok}")
        check(ok, f"ssd_scan CUDA cores at {label} outside its tier")
        out[label] = worst
    return out


def kernel_ssd_cuda_cores(gen) -> dict:
    """The CUDA-core SSD kernel at the widths it serves, through
    ``ssd_scan_cuda`` (which must route them to it), x, B and C as views of
    one activation, dt of order 1 with A = -linspace(1, 16, h): the narrow
    and wide yardsticks of ``SSD_CC_YARDSTICKS`` on silu inputs, each held
    to the ``ssd_scan`` tier against the float32 oracle and to the float64
    witness, and timed (interleaved with the composed ``ref.ssd_chunked``)
    beside its bound at the CUDA cores' float32 peak, with its kernels'
    device time a call; the narrow widths on signed inputs, held to the
    witness alone with their elementwise misses printed; and in bf16 at the
    narrow widths, held to ``ssd_scan_bf16``.  First the widths of
    ``ssd_cc_widths``.  Returns the timed yardsticks' records, the other
    cases' errors and the widths' worst errors over their tolerance."""
    b, g, s = 1, 1, 4096
    out = {"widths worst / tolerance": ssd_cc_widths(gen)}
    for name, dtype, act in (("narrow", torch.float32, "silu"),
                             ("wide", torch.float32, "silu"),
                             ("narrow", torch.float32, "signed"),
                             ("narrow", torch.bfloat16, "silu")):
        h, p, n, chunk = SSD_CC_YARDSTICKS[name]
        f32 = dtype == torch.float32
        tier_name = "ssd_scan" if f32 else "ssd_scan_bf16"
        tier = ops.TOLERANCE_TIERS[tier_name]
        xBC = torch.randn(b, s, h * p + 2 * g * n, generator=gen,
                          device="cuda")
        xBC = (F.silu(xBC) if act == "silu" else xBC).to(dtype)
        x = xBC[..., :h * p].reshape(b, s, h, p)
        B = xBC[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xBC[..., h * p + g * n:].reshape(b, s, g, n)
        dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        check(not ssd_uses_sm90(dtype, p, n, chunk)
              and not ssd_uses_sm90_f32(dtype, p, n, chunk),
              f"ssd_scan_cuda routes {name} {dtype} to a tensor-core kernel")
        before = _build.LAUNCHES["ssd_scan"]
        y = ssd_scan_cuda(x, dt, A, B, C, chunk)
        check(_build.LAUNCHES["ssd_scan"] == before + 1,
              f"ssd_scan_cuda did not launch ssd_scan at {name} {dtype}")
        Bh, Ch = (t.repeat_interleave(h // g, dim=2) for t in (B, C))
        want = ref.ssd_reference(x, dt, A, Bh, Ch)[0]
        label = (f"ssd_scan CUDA cores {name} {str(dtype)[6:]} {act} x "
                 f"[{b}, {s}, {h}, {p}] n {n} chunk {chunk}")
        ok, err = within(y, want, tier)
        misses, worst = tier_misses(y, want, tier)
        log(f"{label}: max_abs_err {err:.3e} (max |y| "
            f"{float(want.float().abs().max()):.2f}) tier {tier_name} "
            f"ok={ok}, {misses} elements outside, worst / tolerance "
            f"{worst:.3f}")
        if act == "silu":
            check(ok, f"{label} outside {tier_name}")
        rec = dict(max_abs_err=err, tier_misses=misses)
        if f32:
            d = [t.double() for t in (x, dt, A, Bh, Ch)]
            y64 = ref.ssd_reference(*d)[0]
            terms = ref.ssd_reference(d[0].abs(), d[1], d[2], d[3].abs(),
                                      d[4].abs())[0]
            for who, got in (("kernel", y), ("oracle", want)):
                e = (got.double() - y64).abs()
                miss = int((e > tier["atol"] + tier["rtol"] * y64.abs())
                           .sum())
                worst = float((e / terms.clamp_min(1e-300)).max())
                log(f"  {who} vs float64: max_abs_err {float(e.max()):.3e}, "
                    f"{miss} elements outside {tier_name}, max err / "
                    f"sum|terms| {worst:.3e}")
                if who == "kernel":
                    check(bool((e <= tier["atol"] + tier["rtol"] * terms)
                               .all()),
                          f"{label}: beyond {tier_name} of sum|terms| "
                          f"against float64")
                    rec["float64_misses"] = miss
            del d, y64, terms, e
        if f32 and act == "silu":
            nbytes, flops = ssd_bound(b, s, h, g, p, n, chunk, 4)
            bnd, by = bound(nbytes, flops, dtype)
            med = interleaved_medians(
                {"kernel": lambda: ssd_scan_cuda(x, dt, A, B, C, chunk),
                 "composed": lambda: ref.ssd_chunked(x, dt, A, B, C, chunk)},
                3, 10)
            phases = {k: v for k, v in device_us_by_kernel(
                lambda: ssd_scan_cuda(x, dt, A, B, C, chunk), 10).items()
                if k.startswith("ssd_")}
            log(f"  ms: kernel {med['kernel']:.4f}, composed ref.ssd_chunked "
                f"{med['composed']:.4f} (medians of 3 interleaved rounds of "
                f"10); bound_ms {bnd:.4f} ({by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP at "
                f"{PEAK_OPS_PER_S[dtype] / 1e12:g} TFLOP/s), "
                f"{bnd / med['kernel']:.1%} of it")
            log("  by kernel, us a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in phases.items()))
            rec.update(shape=f"float32 x [{b}, {s}, {h}, {p}], B, C "
                             f"[{b}, {s}, {g}, {n}], chunk {chunk}",
                       ms=med["kernel"], bound_ms=bnd, bound_by=by,
                       composed_ms=med["composed"], phases_us=phases,
                       share_of_bound=bnd / med["kernel"])
            out[name] = rec
        else:
            out[f"{name} {str(dtype)[6:]} {act}"] = rec
        del xBC, x, B, C, Bh, Ch, y, want
    return out


def kernel_dropout(gen) -> dict:
    """The content-addressed dropout kernel against its plain version on the
    card, bit for bit: the threefry2x32 known answers on the host and in
    the plain version on the card; then at each of ``DROPOUT_CASES``, in
    float32 and bf16, at rates 0.1 and 0.5, ``ops.dropout``'s output and
    gradient (forward and backward each launch the kernel once) equal
    ``ref.dropout_reference`` of x and of the cotangent as integers, and
    their nonzeros equal the plain bernoulli mask on the nonzero inputs;
    with several samples the masks differ between them; x and the
    cotangent start at the case's element offset, and the output keeps x's
    address modulo 16 bytes.  The counter's high
    word: a bf16 sample of 2**32 + 64 ones, its first and last 4096
    elements against the plain bits of those indices.  Times at [1, 4096,
    4096] in float32 and bf16, rate 0.1: the kernel, ``F.dropout`` (timed
    only: its Philox bits are another function) and the plain version
    interleaved."""
    for key, count, want in THREEFRY_KNOWN_ANSWERS:
        y0, y1 = threefry.threefry2x32(key, np.array([count[0]], np.uint32),
                                       np.array([count[1]], np.uint32))
        z0, z1 = ref.threefry2x32_reference(*(
            torch.tensor([v], dtype=torch.int64, device="cuda")
            for v in (*key, *count)))
        check((int(y0[0]), int(y1[0])) == want == (int(z0), int(z1)),
              f"threefry2x32{key, count}: host {(int(y0[0]), int(y1[0]))}, "
              f"card {(int(z0), int(z1))}, want {want}")
    log(f"threefry2x32: {len(THREEFRY_KNOWN_ANSWERS)} known answers on the "
        f"host and in the plain version on the card")
    # step 1, layer 0, op 0 of seed 0, as the cluster derives it
    key = threefry.fold_in(threefry.fold_in(threefry.fold_in(
        threefry.key_from_seed(0), 1), 0), 0)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    shares, worst = {}, 0.0

    def drawn(shape, dtype, offset):
        if not offset:
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        t = torch.randn(math.prod(shape) + offset, generator=gen,
                        device="cuda").to(dtype)[offset:].view(shape)
        check(t.data_ptr() % 16 != 0, "the misaligned case is aligned")
        return t

    for shape, ids, offset in DROPOUT_CASES:
        sids = torch.tensor(ids, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = drawn(shape, dtype, offset)
            g = drawn(shape, dtype, offset)
            for rate in (0.1, 0.5):
                p, r = threefry.dropout_scalars(rate, dtype)
                xr = x.detach().requires_grad_(True)
                before = _build.LAUNCHES["threefry_dropout"]
                y = ops.dropout(xr, key, sids, rate)
                y.backward(g)
                check(y.data_ptr() % 16 == x.data_ptr() % 16,
                      "the kernel's output is off x's address phase")
                check(_build.LAUNCHES["threefry_dropout"] == before + 2,
                      "ops.dropout did not launch the kernel forward and "
                      "backward")
                keep = ref.bernoulli_keep(ref.sample_keys(key, sids),
                                          shape[1:], p)
                where = f"dropout {dtype} {list(shape)} rate {rate}"
                for name, src, got in (("output", x, y.detach()),
                                       ("gradient", g, xr.grad)):
                    want = ref.dropout_reference(src, key, sids, p, r)
                    check(torch.equal(got.view(ints[dtype]),
                                      want.view(ints[dtype])),
                          f"{where}: kernel {name} != plain version's "
                          f"({int((got != want).sum())} elements)")
                    # a kept zero stays zero (randn on the card draws a
                    # few exact zeros at these sizes)
                    check(torch.equal(got != 0, keep & (src != 0)),
                          f"{where}: the kernel's {name} mask != plain mask")
                    worst = max(worst, float((got.float() - want.float())
                                             .abs().max()))
                if len(ids) > 1:
                    check(not torch.equal(keep[0], keep[1]),
                          f"{where}: two samples drew one mask")
                shares[(shape, dtype, rate)] = float(keep.float().mean())
            log(f"dropout {dtype} {list(shape)} ids {list(ids)}"
                f"{f' {offset} elements off' if offset else ''}: kernel == "
                f"plain version bitwise, forward and backward; keep share "
                f"rate 0.1 {shares[(shape, dtype, 0.1)]:.6f}, rate 0.5 "
                f"{shares[(shape, dtype, 0.5)]:.6f}")
            del x, g, xr, y, keep
    # the counter's high word: indices >= 2**32 of one sample
    n = 2 ** 32 + 64
    sids = torch.tensor([77], dtype=torch.int32, device="cuda")
    p, r = threefry.dropout_scalars(0.1, torch.bfloat16)
    ones = torch.ones(1, n, dtype=torch.bfloat16, device="cuda")
    y = threefry_dropout_cuda(ones, key, sids, p, r)
    del ones
    skeys = ref.sample_keys(key, sids)
    one_r = torch.tensor(r, device="cuda").to(torch.bfloat16)
    for lo in (0, n - 4096):
        idx = torch.arange(lo, lo + 4096, dtype=torch.int64, device="cuda")
        keep = ref.keep_from_bits(ref.threefry_bits(skeys, idx), p)
        want = torch.where(keep, one_r, torch.zeros_like(one_r))
        check(torch.equal(y[:, lo:lo + 4096], want),
              f"dropout kernel != plain bits at indices [{lo}, {lo + 4096})")
    del y
    torch.cuda.empty_cache()
    log(f"dropout bf16 [1, {n}]: indices [0, 4096) and [{n - 4096}, {n}) "
        f"(counter high word 1 past 2**32) equal the plain version's")
    # times at codeqwen's activations, bf16, rate 0.1
    shape, ids, _ = DROPOUT_CASES[0]
    sids = torch.tensor(ids, dtype=torch.int32, device="cuda")
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        p, r = threefry.dropout_scalars(DROPOUT_RATE, dtype)
        med = interleaved_medians(
            {"kernel": lambda: threefry_dropout_cuda(x, key, sids, p, r),
             "library": lambda: F.dropout(x, DROPOUT_RATE, training=True),
             "plain": lambda: ref.dropout_reference(x, key, sids, p, r)},
            5, 20)
        numel = x.numel()
        int_ops = THREEFRY_INT_OPS_PER_ELEMENT * numel
        b, by = bound(2 * numel * x.element_size() + 4 * len(ids), int_ops,
                      None, peak=PEAK_INT32_OPS_PER_S)
        t_ops = int_ops / PEAK_INT32_OPS_PER_S * 1e3
        log(f"dropout {dtype} {list(shape)} rate {DROPOUT_RATE}, medians of "
            f"5 interleaved rounds of 20: kernel {med['kernel']:.5f} ms, "
            f"F.dropout {med['library']:.5f} ms, plain {med['plain']:.3f} "
            f"ms; bound {b:.5f} ms, by {by} (operations {t_ops:.5f} ms: "
            f"{THREEFRY_INT_OPS_PER_ELEMENT} integer operations an "
            f"element at {PEAK_INT32_OPS_PER_S / 1e12:.2f} T/s; bytes "
            f"{2 * numel * x.element_size() / HBM_BYTES_PER_S * 1e3:.5f} "
            f"ms)")
        tag = "" if dtype == torch.bfloat16 else "float32_"
        rec.update({f"{tag}ms": med["kernel"],
                    f"{tag}plain_ms": med["plain"],
                    f"{tag}library_ms": med["library"],
                    f"{tag}bound_ms": b})
        if dtype == torch.bfloat16:
            rec.update(shape=f"bfloat16 {list(shape)}, rate {DROPOUT_RATE}",
                       bound_by=by, max_abs_err=worst,
                       keep_share=shares[(shape, dtype, DROPOUT_RATE)],
                       library="F.dropout (Philox bits: timed only)")
        del x
    return rec


def kernel_path_shapes(gen) -> dict:
    """The main-path kernels at the shapes the later paths give them.
    Phase 7 after a shrink (each item two sequences): rmsnorm in bf16 on
    8192 rows of mamba2's 2560 (the block norm) and 5120 (the gated
    out_norm), and the tensor-core SSD scan at [2, 4096, 80, 64], n 128,
    chunk 256, x, B and C views of one silu-activated activation.  Phase 8
    (float32 mamba2, one sequence an item): rmsnorm in float32 on 4096 rows
    of 2560 and 5120, under the float32 ``rmsnorm`` tier (its SSD scan is
    kernel_ssd's float32 main case).  Each against its plain version under
    the tier of phase 3.  Returns, by kernel, the records' max_abs_err
    entries."""
    errs = {"rmsnorm": {}, "ssd_scan_sm90": {}}
    for dtype, rows, tier, key in (
            (torch.bfloat16, 2 * 4096, "rmsnorm_bf16",
             "recovery_shapes_max_abs_err"),
            (torch.float32, 4096, "rmsnorm",
             "float32_path_shapes_max_abs_err")):
        for d in (2560, 5120):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
            before = _build.LAUNCHES["rmsnorm"]
            y = rmsnorm_cuda(x, scale, 1e-5)
            check(_build.LAUNCHES["rmsnorm"] == before + 1,
                  f"rmsnorm_cuda did not launch its kernel for {dtype}")
            ok, err = within(y, ref.rmsnorm_reference(x, scale, 1e-5),
                             ops.TOLERANCE_TIERS[tier])
            log(f"rmsnorm {dtype} [{rows}, {d}]: max_abs_err {err:.3e} tier "
                f"{tier} ok={ok}")
            check(ok, f"rmsnorm {dtype} [{rows}, {d}] outside {tier}")
            errs["rmsnorm"][key] = max(errs["rmsnorm"].get(key, 0.0), err)
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
    errs["ssd_scan_sm90"]["recovery_shapes_max_abs_err"] = err
    return errs


def phase_tiny_twin(family: str, twin: str = "float32",
                    dropout_rate: float = 0.0,
                    rng_mode: str = "reshard") -> dict:
    """3 steps of a tiny cluster on the card and on the CPU: the float32
    tiny configuration (seq 16) within the reference's kernel-consistency
    bounds; the bf16 configuration of ``BF16_TWINS`` (``twin="bf16"``, seq
    128) or of ``BF16_MMA_TWINS`` (``twin="bf16 hd16"``, ``"bf16 hd32"``,
    dense, seq 128) within the bf16 twins' bound; or ``F32_SM90_SSM_TWIN``
    (``twin="float32 sm90"``, seq 128) within the float32 bounds; at
    ``dropout_rate`` under ``rng_mode``.  Returns the card's launch
    counts."""
    name = f"tiny {family} twin ({twin}" + (
        f", dropout {dropout_rate} {rng_mode})" if dropout_rate else ")")
    bf16 = twin.startswith("bf16")
    cfg = tiny_config(family, **{"float32": {}, "bf16": BF16_TWINS[family],
                                 "float32 sm90": F32_SM90_SSM_TWIN,
                                 **BF16_MMA_TWINS}[twin],
                      dropout_rate=dropout_rate)
    if twin in BF16_MMA_TWINS:
        check(f"hd{cfg.head_dim}" == twin.split()[1]
              and (cfg.num_heads, cfg.num_kv_heads) == (4, 2),
              f"{name}: head_dim {cfg.head_dim}, heads {cfg.num_heads}/"
              f"{cfg.num_kv_heads}")
    kw = dict(global_batch=8, num_micro=2,
              seq_len=16 if twin == "float32" else 128, rng_mode=rng_mode)
    cpu = VirtualCluster(cfg, 2, 2, device="cpu", **kw)
    # the CPU cluster's own tensors: bf16 leaves stay bf16 on the card
    init = (cpu.stem, cpu.layer_params, cpu.head)
    gpu = VirtualCluster(cfg, 2, 2, device="cuda", init_params=init, **kw)
    check(all(a.dtype == b.dtype for a, b in zip(gpu._leaves, cpu._leaves)),
          f"{name}: parameter dtypes differ between card and CPU")
    loss_ok = (lambda a, b: abs(a - b) <= BF16_LOSS_RTOL * abs(b)) if bf16 \
        else KCC.loss_within
    rtol = BF16_PARAM_RTOL if bf16 else KCC.PARAM_RTOL
    _build.reset_launch_counts()
    for step in range(3):
        a, b = gpu.train_step(), cpu.train_step()
        check(math.isfinite(a) and loss_ok(a, b),
              f"{name} step {step}: loss {a!r} vs cpu {b!r}")
        atol = KCC.param_atol(gpu)
        worst = 0.0
        for sg, sc in zip(gpu.stages, cpu.stages):
            check(sg.sizes == sc.sizes and sg.entries == sc.entries,
                  f"{name} stage structure differs")
            for c in ("master", "mu", "nu"):
                x, y = sg.full(c).cpu(), sc.full(c)
                check(torch.allclose(x, y, rtol=rtol, atol=atol),
                      f"{name} step {step}: stage {c} beyond bounds")
                worst = max(worst, float((x - y).abs().max()))
        log(f"{name} step {step}: loss card {a:.7f} cpu {b:.7f} "
            f"state max_abs_diff {worst:.3e} (atol {atol:.1e}, rtol "
            f"{rtol:.2e})")
    counts = dict(_build.LAUNCHES)
    log(f"{name} launches on the card: {counts}")
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


def phase_tiny_recovery_twin(family: str, dropout_rate: float = 0.0,
                             rng_mode: str = "reshard") -> dict:
    """The tiny float32 cluster (dp=4, pp=2, global batch 16) on the card
    and on the CPU through ``TWIN_SEQUENCE``: records, remap plans,
    integrity tiers and layouts equal exactly, losses and state within the
    kernel-consistency bounds after every step; at ``dropout_rate`` under
    ``rng_mode`` (0.1 is the reference's elastic test configuration).
    Returns the card's launch counts."""
    cfg = tiny_config(family, num_layers=8 if family == "dense" else 4,
                      dropout_rate=dropout_rate)
    kw = dict(global_batch=16, num_micro=2, seq_len=16, rng_mode=rng_mode)
    cpu = VirtualCluster(cfg, 4, 2, device="cpu", **kw)
    init = params_to_numpy(cpu.stem, cpu.layer_params, cpu.head)
    gpu = VirtualCluster(cfg, 4, 2, device="cuda", init_params=init, **kw)
    logs = {"cpu": [], "cuda": []}
    tiers = {"cpu": [], "cuda": []}
    for dev, cl in (("cpu", cpu), ("cuda", gpu)):
        _pin_planner_clock(cl, logs[dev])
    orig = SnapshotPool.verify_and_repair
    _build.reset_launch_counts()
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
                check(KCC.loss_within(a, b),
                      f"{where}: loss {a!r} vs cpu {b!r}")
                atol = KCC.param_atol(gpu)
                for sg, sc in zip(gpu.stages, cpu.stages):
                    for c in ("master", "mu", "nu"):
                        check(torch.allclose(sg.full(c).cpu(), sc.full(c),
                                             rtol=KCC.PARAM_RTOL, atol=atol),
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
    counts = dict(_build.LAUNCHES)
    log(f"tiny {family} recovery twin"
        f"{f' (dropout {dropout_rate} {rng_mode})' if dropout_rate else ''}: "
        f"{len(gpu.recoveries)} recoveries, "
        f"{len(logs['cuda'])} remap plans, tiers {tiers['cuda']}, layout "
        f"{gpu.layer_assignment}, dp_ranks "
        f"{[s.dp_ranks for s in gpu.stages]}: card == cpu; launches "
        f"{counts}")
    return counts


def snapshot_matches_device(cl: VirtualCluster) -> bool:
    for st, pool in zip(cl.stages, cl.snapshots):
        for c in ("master", "mu", "nu"):
            shards = st.table.split(st.flat[c].cpu().numpy())
            for i in range(pool.n):
                if not np.array_equal(pool.host[i][c],
                                      shards[pool.backup_rank(i)]):
                    return False
    return True


def covered_share(spans: list, lo: float, hi: float) -> float:
    """Share of [lo, hi] that the union of ``spans`` (start, end) covers."""
    covered, end = 0.0, lo
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, hi)
        if b > a:
            covered += b - a
            end = b
    return covered / (hi - lo)


def device_split(trace: dict) -> dict:
    """Device time of one profiled step (``torch.profiler``'s Chrome trace,
    microseconds) by kind: each hand-written kernel by name, cuBLAS
    products, the other ATen kernels (the plain backwards, elementwise
    work), memcpy by direction, memset; and the shares of the window from
    the step's start to the snapshot's start that the device was busy with
    anything (kernels, copies, memsets) and with kernels."""
    events = trace["traceEvents"]
    marks = {e["name"]: e["ts"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in ("chip_smoke.step", "chip_smoke.snapshot")}
    split, busy, kernels = {}, [], []
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if cat == "gpu_memcpy":
            kind = "memcpy " + next((d for d in ("DtoH", "HtoD", "DtoD")
                                     if d in name), "other")
        elif cat == "gpu_memset":
            kind = "memset"
        else:
            mine = re.search("|".join(HAND_WRITTEN_KERNELS), name)
            kind = (mine.group(0) if mine else "cuBLAS products"
                    if re.search(r"gemm|nvjet|xmma|cutlass|cublas", name,
                                 re.I) else "other ATen kernels")
            kernels.append((e["ts"], e["ts"] + e["dur"]))
        split[kind] = split.get(kind, 0.0) + e["dur"]
        busy.append((e["ts"], e["ts"] + e["dur"]))
    lo, hi = marks["chip_smoke.step"], marks["chip_smoke.snapshot"]
    return {"us": split, "window_us": hi - lo,
            "busy_share": covered_share(busy, lo, hi),
            "kernel_share": covered_share(kernels, lo, hi)}


def profiled_step(cl: VirtualCluster) -> tuple:
    """One ``train_step`` under ``torch.profiler`` (CPU and CUDA), the
    snapshot's start marked; returns the loss and ``device_split``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    pools = cl.snapshots
    inner = pools[0].snapshot_step

    def marked(*a, **k):
        with record_function("chip_smoke.snapshot"):
            return inner(*a, **k)
    pools[0].snapshot_step = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("chip_smoke.step"):
                loss = cl.train_step()
            torch.cuda.synchronize()
    finally:
        del pools[0].snapshot_step
    path = _build.BUILD_ROOT.parent / "chip_smoke_step_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    path.unlink()
    return loss, device_split(trace)


def phase_train(cfg, want: dict, steps: int = 3,
                profile_step: int | None = None, **cluster_kw) -> tuple:
    """``steps`` steps of ``VirtualCluster.train_step`` at dp=2, pp=2, global
    batch 4 in 2 micro-batches, seq 4096, random weights from seed 1; step
    ``profile_step`` under ``torch.profiler`` (``profiled_step``; its step
    time carries the profiler's cost).  Returns the launch counts and the
    cluster."""
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
    for step in range(steps):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if step == profile_step:
            loss, split = profiled_step(cl)
        else:
            loss = cl.train_step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        snap = cl.snapshot_seconds[-1]
        if step == profile_step:
            us = split["us"]
            log(f"step {step} device time by kind (torch.profiler, ms): "
                + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in
                            sorted(us.items(), key=lambda kv: -kv[1]))
                + f"; total {sum(us.values()) / 1e3:.3f}; of the "
                f"{split['window_us'] / 1e3:.3f} ms from the step's start "
                f"to the snapshot's, the device was busy "
                f"{split['busy_share']:.4f}, with kernels "
                f"{split['kernel_share']:.4f}")
        log(f"step {step}: loss {loss:.6f} ({loss!r}) step_s {dt:.3f} "
            f"snapshot_s {snap:.3f} (share {snap / dt:.3f}) "
            f"peak_mem_GB {torch.cuda.max_memory_allocated() / 1e9:.2f}")
        check(math.isfinite(loss), f"step {step}: loss not finite")
        check(snapshot_matches_device(cl),
              f"step {step}: host ring snapshot != device shards")
    launches = dict(_build.LAUNCHES)
    log(f"launches over {steps} steps: {launches}")
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


class LaunchTally(InvariantChecker):
    """Exact launch counts over one scenario run.  The counts are set to 0
    at cluster start, after the kernel-consistency spot check (launches that
    compare a kernel with its plain version do not count); each step adds
    what its items launch, an item being one micro-batch of one rank: 2L + 1
    rmsnorms (two a block, the final norm) and L mixer launches on
    ``route``, at a positive dropout rate ``dropout_ops`` dropouts a layer,
    forward and backward; and one fused AdamW per stage."""
    name = "launch-tally"

    def __init__(self, route: str, dropout_ops: int):
        self.route, self.dropout_ops = route, dropout_ops
        self.want = dict.fromkeys(_build.LAUNCHES, 0)

    def on_cluster_start(self, runner, cluster):
        _build.reset_launch_counts()

    def after_cluster_step(self, step, cluster, loss):
        L = cluster.cfg.num_layers
        items = cluster.num_micro * sum(m > 0 for m in cluster.per_rank_mbs)
        self.want["rmsnorm"] += items * (2 * L + 1)
        self.want[self.route] += items * L
        if cluster.cfg.dropout_rate > 0:
            self.want["threefry_dropout"] += items * L * self.dropout_ops * 2
        self.want["fused_adam"] += sum(st.total > 0 for st in cluster.stages)

    def check_counts(self, where: str) -> dict:
        counts = dict(_build.LAUNCHES)
        check(counts == self.want,
              f"{where}: launches {counts} != {self.want}")
        return counts


class RingGate(InvariantChecker):
    """The host ring snapshot equals the device shards after every event
    and step; also times each ``train_step`` and ``apply_event`` of the
    cluster between ``torch.cuda.synchronize`` calls."""
    name = "ring-snapshot"

    def __init__(self):
        self.step_s, self.snapshot_s, self.recovery_s = [], [], []

    def on_cluster_start(self, runner, cluster):
        for attr, out in (("train_step", self.step_s),
                          ("apply_event", self.recovery_s)):
            def timed(*a, _fn=getattr(cluster, attr), _out=out, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = _fn(*a, **k)
                torch.cuda.synchronize()
                _out.append(time.perf_counter() - t0)
                return res
            setattr(cluster, attr, timed)
        self._gate("start", cluster)

    def after_cluster_event(self, step, event, cluster, record):
        self._gate(f"step {step} after {event.describe()}", cluster)

    def after_cluster_step(self, step, cluster, loss):
        self.snapshot_s.append(cluster.snapshot_seconds[-1])
        self._gate(f"step {step}", cluster)

    def _gate(self, where: str, cluster):
        if not snapshot_matches_device(cluster):
            self.fail(f"{where}: host ring snapshot != device shards")


@dataclasses.dataclass(frozen=True)
class Mamba2TraceWorkload(ClusterWorkload):
    """mamba2-2.7b at its published widths in bf16, depth cut to 2 layers,
    dp 2, pp 2, seq 4096, global batch 4 in 2 micro-batches, on the card,
    its cost model given ``H100_HW`` (phase 6's)."""
    family: str = "ssm"
    num_layers: int = 2
    dropout_rate: float = 0.0
    dp: int = 2
    pp: int = 2
    global_batch: int = 4
    num_micro: int = 2
    seq_len: int = 4096
    device: str = "cuda"

    def make_cluster(self, **overrides):
        cfg = dataclasses.replace(mamba2_2p7b.config(),
                                  num_layers=self.num_layers,
                                  dropout_rate=self.dropout_rate)
        kw = dict(global_batch=self.global_batch, num_micro=self.num_micro,
                  seq_len=self.seq_len, seed=self.seed,
                  rng_mode=self.rng_mode, device=self.device, hw=H100_HW)
        kw.update(overrides)
        return VirtualCluster(cfg, dp=self.dp, pp=self.pp, **kw)


def phase_scenarios() -> tuple:
    """Phase 9, the scenario engine on the card: the kernel corpus
    (``kernels/check.py``), each of the library's six scenarios with the
    default card checkers (the card cluster held to its CPU twin under the
    kernel-consistency bounds; dataflow, RNG and MTTR after every event and
    step), then shrink_regrow's trace shape on mamba2-2.7b at full width.
    Launch counts exact over each run.  Returns the launches by path and one
    record per run."""
    t_phase = time.perf_counter()
    for row in check_kernels(seed=0):
        log(f"corpus {row['case']}: max_abs_err {row['max_abs_err']:.3e} "
            f"(rtol {row['rtol']}, atol {row['atol']}) within "
            f"{row['within_tolerance']}")
        check(row["within_tolerance"], f"corpus {row['case']} outside tier")
    paths, records = {}, []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the CPU twins' tensors are tiny
    try:
        for name in SCENARIOS:
            scn, w = get_scenario(name)
            tally = LaunchTally("flash_attention_tf32", 2)
            t0 = time.perf_counter()
            res = run_scenario(scn, w, checkers=[
                *default_cluster_checkers(device="cuda"), tally])
            wall = time.perf_counter() - t0
            counts = tally.check_counts(f"scenario {name}")
            check((counts["threefry_dropout"] > 0) == (w.dropout_rate > 0),
                  f"scenario {name}: dropout launches {counts}")
            losses = res.summary["losses"]
            check(all(math.isfinite(x) for x in losses),
                  f"scenario {name}: losses {losses}")
            rec = dict(name=name, losses=losses,
                       n_recoveries=res.summary["n_recoveries"],
                       mttr_total_modeled_s=res.summary["mttr_total"],
                       final_dp_width=res.steps[-1]["dp_width"],
                       wall_s=wall, launches=counts)
            log(f"scenario {name} (dropout {w.dropout_rate}, horizon "
                f"{scn.horizon}): losses {[round(x, 6) for x in losses]}, "
                f"{rec['n_recoveries']} recoveries, modeled mttr_total "
                f"{rec['mttr_total_modeled_s']:.4f} s, final dp width "
                f"{rec['final_dp_width']}, wall {wall:.1f} s; card == cpu "
                f"within the kernel-consistency bounds; launches {counts}")
            paths[f"scenario {name} (tiny dense)"] = counts
            records.append(rec)
    finally:
        torch.set_num_threads(threads)
    gc.collect()
    torch.cuda.empty_cache()
    w = Mamba2TraceWorkload()
    scn = Scenario.shrink_regrow("shrink_regrow (mamba2-2.7b)",
                                 rank=w.rank(1, 1), fail_step=1,
                                 rejoin_step=2, horizon=4)
    gate, tally = RingGate(), LaunchTally("ssd_scan_sm90", 1)
    t0 = time.perf_counter()
    res = ClusterScenarioRunner(scn, w, checkers=[
        DataflowConsistencyChecker(), RngConsistencyChecker(),
        MttrBoundChecker(), gate, tally]).run()
    wall = time.perf_counter() - t0
    counts = tally.check_counts("mamba2-2.7b shrink_regrow trace")
    losses = res.summary["losses"]
    check(all(math.isfinite(x) for x in losses),
          f"mamba2-2.7b shrink_regrow trace: losses {losses}")
    check([s["dp_width"] for s in res.steps] == [2, 1, 2, 2],
          f"mamba2-2.7b shrink_regrow trace: widths {res.steps}")
    shares = [sn / st for sn, st in zip(gate.snapshot_s, gate.step_s)]
    for k, (loss, st, sh) in enumerate(zip(losses, gate.step_s, shares)):
        log(f"mamba2-2.7b trace step {k}: loss {loss:.6f} ({loss!r}) "
            f"step_s {st:.3f} snapshot share {sh:.3f}")
    for r, sec in zip(res.recoveries, gate.recovery_s):
        log(f"mamba2-2.7b trace {r['kind']} {r['ranks']} at step "
            f"{r['step']}: wall {sec:.3f} s; record (modeled, plan "
            f"measured) {r['mttr']}")
    log(f"mamba2-2.7b trace: launches {counts}; ring == device after every "
        f"event and step; wall {wall:.1f} s")
    paths["mamba2-2.7b shrink_regrow trace"] = counts
    records.append(dict(name=scn.name, losses=losses,
                        n_recoveries=len(res.recoveries),
                        mttr_total_modeled_s=res.summary["mttr_total"],
                        final_dp_width=res.steps[-1]["dp_width"],
                        wall_s=wall, launches=counts, step_s=gate.step_s,
                        snapshot_share=shares,
                        recovery_wall_s=gate.recovery_s))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"phase 9 (scenario engine on the card): {phase_s:.1f} s")
    return paths, records, phase_s


# phase 10: the fuzz seeds run on the card, by mode
FUZZ_SEEDS = {"kernel": range(12), "cluster": range(8), "chaos": (0, 1, 3)}
# the tiny fuzz configurations' mixer route and dropouts a layer: float32
# dense at head_dim 16 on the 3xTF32 flash route (attention and MLP
# dropouts), float32 ssm at p 16, n 16, chunk 8 on the CUDA-core SSD route
# (the Mamba2 block's one dropout)
FUZZ_ROUTES = {"dense": ("flash_attention_tf32", 2), "ssm": ("ssd_scan", 1)}
# the full-width fuzz trace: kernel seed 6 (ssm, dp 2, pp 1, dropout 0.1: a
# fail-stop of rank 0 at step 1, a fail-slow x1.5 of rank 1 at step 2)
FUZZ_TRACE_SEED = 6
EXAMPLES = Path(__file__).resolve().parent / "examples"


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tallied(route: str, dropout_ops: int, fn):
    """Runs ``fn()`` with every ``VirtualCluster.train_step`` feeding a
    ``LaunchTally``; the counts start at 0.  Returns ``fn``'s result and
    the launches, checked exact."""
    tally = LaunchTally(route, dropout_ops)
    step = VirtualCluster.train_step

    def counted(self):
        loss = step(self)
        tally.after_cluster_step(self.step_count - 1, self, loss)
        return loss

    _build.reset_launch_counts()
    VirtualCluster.train_step = counted
    try:
        out = fn()
    finally:
        VirtualCluster.train_step = step
    return out, tally.check_counts(f"{fn.__name__}")


def fuzz_case(mode: str, seed: int, spot_check: bool) -> tuple:
    """One fuzz case on the card with the default checkers (chaos: those of
    ``default_chaos_checkers``) and a ``LaunchTally``; the kernel corpus
    spot check only where ``spot_check``.  Returns its record and its
    launches."""
    case = make_case(mode, seed)
    w = case.workload
    check(w.device is None, f"fuzz {mode} {seed}: device {w.device!r}")
    route, drops = FUZZ_ROUTES[w.family]
    checkers = (default_chaos_checkers(case) if mode == "chaos"
                else default_cluster_checkers(device=w.device))
    for c in checkers:
        if isinstance(c, KernelConsistencyChecker):
            c.spot_check = spot_check
    names = [c.name for c in checkers]
    tally = LaunchTally(route, drops)
    t0 = time.perf_counter()
    if mode == "chaos":
        cl = run_chaos_case(case, checkers=[*checkers, tally])
        losses, n_rec = [float(x) for x in cl.losses], len(cl.recoveries)
        width = int(min(cl.alive[:, p].sum() for p in range(cl.pp)))
        events = [f"step={a.step} {a.kind} rank={a.rank}"
                  for a in case.actions]
        del cl
    else:
        res = run_case(case, checkers=[*checkers, tally])
        losses, n_rec = res.summary["losses"], len(res.recoveries)
        width = res.steps[-1]["dp_width"]
        events = [e.describe() for e in case.scenario.events]
        del res
    wall = time.perf_counter() - t0
    counts = tally.check_counts(f"fuzz {mode} {seed}")
    check(counts[route] > 0, f"fuzz {mode} {seed}: no {route} launch")
    check((counts["threefry_dropout"] > 0) == (w.dropout_rate > 0),
          f"fuzz {mode} {seed}: dropout launches {counts}")
    check(all(math.isfinite(x) for x in losses),
          f"fuzz {mode} {seed}: losses {losses}")
    check(("kernel-consistency" in names)
          == (getattr(case, "chaos_class", None) != "corrupt"),
          f"fuzz {mode} {seed}: checkers {names}")
    rec = dict(mode=mode, seed=seed, family=w.family, dp=w.dp, pp=w.pp,
               dropout=w.dropout_rate, events=events,
               chaos_class=getattr(case, "chaos_class", None),
               checkers=names, spot_check=spot_check, losses=losses,
               n_recoveries=n_rec, final_dp_width=width, wall_s=wall,
               launches={k: v for k, v in counts.items() if v})
    log(f"fuzz {mode} {seed} ({w.family}, dp {w.dp}, pp {w.pp}, dropout "
        f"{w.dropout_rate}{', ' + rec['chaos_class'] if rec['chaos_class'] else ''}"
        f"; corpus spot check {'on' if spot_check else 'off'}): events "
        f"{events}; losses {[round(x, 6) for x in losses]}; {n_rec} "
        f"recoveries, final dp width {width}; launches {rec['launches']}; "
        f"wall {wall:.1f} s; checkers {names} passed")
    return rec, counts


def fuzz_trace() -> tuple:
    """Kernel seed 6's trace on mamba2-2.7b at full width (bf16, depth cut
    to the case's 2 layers, dp 2, pp 1, dropout 0.1, seq 4096, global
    batch 4 in 2 micro-batches): dataflow, RNG, MTTR, the ring gate and the
    launch tally; no CPU twin."""
    case = make_kernel_case(FUZZ_TRACE_SEED)
    cw = case.workload
    w = Mamba2TraceWorkload(num_layers=cw.num_layers, dp=cw.dp, pp=cw.pp,
                            dropout_rate=cw.dropout_rate, seed=cw.seed,
                            rng_mode=cw.rng_mode)
    scn = Scenario(f"fuzz-kernel-{FUZZ_TRACE_SEED} (mamba2-2.7b)",
                   case.scenario.events, case.scenario.horizon)
    gate = RingGate()
    tally = LaunchTally("ssd_scan_sm90", FUZZ_ROUTES["ssm"][1])
    t0 = time.perf_counter()
    res = ClusterScenarioRunner(scn, w, checkers=[
        DataflowConsistencyChecker(), RngConsistencyChecker(),
        MttrBoundChecker(), gate, tally]).run()
    wall = time.perf_counter() - t0
    counts = tally.check_counts(scn.name)
    check(counts["threefry_dropout"] > 0 and counts["ssd_scan"] == 0,
          f"{scn.name}: launches {counts}")
    losses = res.summary["losses"]
    check(all(math.isfinite(x) for x in losses), f"{scn.name}: {losses}")
    widths = [s["dp_width"] for s in res.steps]
    check(widths == [2, 1, 1], f"{scn.name}: widths {widths}")
    shares = [sn / st for sn, st in zip(gate.snapshot_s, gate.step_s)]
    for k, (loss, st, sh) in enumerate(zip(losses, gate.step_s, shares)):
        log(f"{scn.name} step {k}: loss {loss:.6f} ({loss!r}) step_s "
            f"{st:.3f} snapshot share {sh:.3f}")
    for r, sec in zip(res.recoveries, gate.recovery_s):
        log(f"{scn.name} {r['kind']} {r['ranks']} at step {r['step']}: wall "
            f"{sec:.3f} s; record (modeled, plan measured) {r['mttr']}")
    log(f"{scn.name}: events {[e.describe() for e in scn.events]}; "
        f"launches {counts}; ring == device after every event and step; "
        f"wall {wall:.1f} s")
    rec = dict(mode="kernel trace", seed=FUZZ_TRACE_SEED, name=scn.name,
               events=[e.describe() for e in scn.events], losses=losses,
               widths=widths, wall_s=wall, step_s=gate.step_s,
               snapshot_share=shares, recovery_wall_s=gate.recovery_s,
               recoveries=[dict(kind=r["kind"], ranks=r["ranks"],
                                step=r["step"], mttr=r["mttr"])
                           for r in res.recoveries],
               launches={k: v for k, v in counts.items() if v})
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return rec, counts


def phase_fuzz() -> tuple:
    """Phase 10, the trace fuzzer on the card: ``FUZZ_SEEDS`` with the
    default card checkers, kernel seed 6's trace at full width, the two
    examples, the detector-only chaos sweep.  Returns the launches by path,
    one record per run and the phase's wall time."""
    t_phase = time.perf_counter()
    paths, records = {}, []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the CPU twins' tensors are tiny
    try:
        for mode, seeds in FUZZ_SEEDS.items():
            total = dict.fromkeys(_build.LAUNCHES, 0)
            for i, seed in enumerate(seeds):
                rec, counts = fuzz_case(mode, seed, spot_check=i == 0)
                records.append(rec)
                for k, v in counts.items():
                    total[k] += v
            log(f"fuzz {mode} seeds {list(seeds)}: corpus spot check in seed "
                f"{seeds[0]} only; launches {total}")
            paths[f"fuzz {mode} seeds {', '.join(map(str, seeds))} (tiny)"] \
                = total
    finally:
        torch.set_num_threads(threads)
    gc.collect()
    torch.cuda.empty_cache()
    rec, paths[f"fuzz kernel {FUZZ_TRACE_SEED} trace (mamba2-2.7b)"] = \
        fuzz_trace()
    records.append(rec)

    t0 = time.perf_counter()
    quick, counts = tallied(FUZZ_ROUTES["dense"][0], FUZZ_ROUTES["dense"][1],
                            load_example("torch_quickstart").quickstart)
    wall = time.perf_counter() - t0
    check(quick["deviation"] < 1e-4,
          f"torch_quickstart: deviation {quick['deviation']!r}")
    check(all(math.isfinite(x) for x in quick["losses"]),
          f"torch_quickstart: losses {quick['losses']}")
    log(f"torch_quickstart (card): deviation {quick['deviation']!r} < 1e-4; "
        f"launches {counts}; wall {wall:.1f} s")
    paths["examples/torch_quickstart.py"] = counts
    records.append(dict(mode="example", name="torch_quickstart",
                        base_losses=quick["base_losses"],
                        losses=quick["losses"],
                        deviation=quick["deviation"], wall_s=wall,
                        launches={k: v for k, v in counts.items() if v}))

    def elastic_train_30():
        return load_example("torch_elastic_train").elastic_train(steps=30)

    t0 = time.perf_counter()
    el, counts = tallied(FUZZ_ROUTES["dense"][0], FUZZ_ROUTES["dense"][1],
                         elastic_train_30)
    wall = time.perf_counter() - t0
    check(len(el["losses"]) == 30
          and all(math.isfinite(x) for x in el["losses"]),
          f"torch_elastic_train: losses {el['losses']}")
    check(len(el["recoveries"]) == 2 and all(el["recoveries"]),
          f"torch_elastic_train: recoveries {el['recoveries']}")
    log(f"torch_elastic_train (card, 30 steps): launches {counts}; wall "
        f"{wall:.1f} s")
    paths["examples/torch_elastic_train.py (30 steps)"] = counts
    records.append(dict(mode="example", name="torch_elastic_train",
                        losses=el["losses"],
                        recoveries=[{k: float(v) for k, v in r.items()}
                                    for r in el["recoveries"]],
                        wall_s=wall,
                        launches={k: v for k, v in counts.items() if v}))

    t0 = time.perf_counter()
    for seed in range(150):
        run_detector_chaos(seed)
    log(f"run_detector_chaos: seeds 0-149 passed in "
        f"{time.perf_counter() - t0:.2f} s")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 10 (trace fuzzer on the card): {phase_s:.1f} s")
    return paths, records, phase_s


def main() -> None:
    card = phase_device()
    pipes = phase_build()
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
    recs["threefry_dropout"] = kernel_dropout(gen)
    for dt, (alu, mad) in pipes.items():
        tag = "" if dt == "bf16" else "float32_"
        recs["threefry_dropout"].update({
            f"{tag}sass_alu_pipe_per_element": alu,
            f"{tag}sass_multiply_add_pipe_per_element": mad})
    torch.cuda.empty_cache()
    tiny = phase_tiny_twin("dense")
    check(tiny["flash_attention_tf32"] > 0 and tiny["flash_attention"] == 0
          and tiny["flash_attention_sm90"] == 0,
          f"tiny dense twin (float32, head_dim 16) must take the 3xTF32 "
          f"flash route only: {tiny}")
    tiny_ssm = phase_tiny_twin("ssm")
    check(tiny_ssm["ssd_scan"] > 0 and tiny_ssm["ssd_scan_sm90"] == 0
          and tiny_ssm["ssd_scan_sm90_f32"] == 0,
          f"tiny ssm twin (float32, chunk 8) must take the CUDA-core SSD "
          f"route only: {tiny_ssm}")
    tiny_ssm_f32 = phase_tiny_twin("ssm", "float32 sm90")
    check(tiny_ssm_f32["ssd_scan_sm90_f32"] > 0
          and tiny_ssm_f32["ssd_scan"] == 0
          and tiny_ssm_f32["ssd_scan_sm90"] == 0,
          f"tiny ssm twin (float32, headdim 64, state 64, chunk 64) must "
          f"take the float32 tensor-core SSD route only: {tiny_ssm_f32}")
    tiny_bf16 = phase_tiny_twin("dense", "bf16")
    check(tiny_bf16["flash_attention_sm90"] > 0
          and tiny_bf16["flash_attention"] == 0
          and tiny_bf16["flash_attention_tf32"] == 0,
          f"tiny dense twin (bf16, head_dim 64) must take the wgmma flash "
          f"route only: {tiny_bf16}")
    tiny_mma = {}
    for twin in BF16_MMA_TWINS:
        tiny_mma[twin] = phase_tiny_twin("dense", twin)
        check(tiny_mma[twin]["flash_attention_bf16_mma"] > 0
              and tiny_mma[twin]["flash_attention"] == 0
              and tiny_mma[twin]["flash_attention_sm90"] == 0
              and tiny_mma[twin]["flash_attention_tf32"] == 0,
              f"tiny dense twin ({twin}) must take the bf16 mma.sync flash "
              f"route only: {tiny_mma[twin]}")
    tiny_ssm_bf16 = phase_tiny_twin("ssm", "bf16")
    check(tiny_ssm_bf16["ssd_scan_sm90"] > 0
          and tiny_ssm_bf16["ssd_scan"] == 0
          and tiny_ssm_bf16["ssd_scan_sm90_f32"] == 0,
          f"tiny ssm twin (bf16, headdim 64, state 64, chunk 64) must take "
          f"the tensor-core SSD route only: {tiny_ssm_bf16}")
    twin_dense = phase_tiny_recovery_twin("dense")
    check(twin_dense["flash_attention_tf32"] > 0
          and twin_dense["flash_attention"] == 0
          and twin_dense["flash_attention_sm90"] == 0,
          f"tiny dense recovery twin (float32) must take the 3xTF32 flash "
          f"route only: {twin_dense}")
    twin_ssm = phase_tiny_recovery_twin("ssm")
    check(twin_ssm["ssd_scan"] > 0 and twin_ssm["ssd_scan_sm90"] == 0
          and twin_ssm["ssd_scan_sm90_f32"] == 0,
          f"tiny ssm recovery twin (float32, chunk 8) must take the "
          f"CUDA-core SSD route only: {twin_ssm}")
    # the float32 twins at dropout 0.1: the same launches as without
    # dropout, and exactly DROPOUT_TWIN_LAUNCHES of the dropout kernel
    drop_twins = {}
    for family, mode, base in (("dense", "reshard", tiny),
                               ("dense", "naive", tiny),
                               ("ssm", "reshard", tiny_ssm)):
        counts = phase_tiny_twin(family, dropout_rate=DROPOUT_RATE,
                                 rng_mode=mode)
        want = {**base, "threefry_dropout": DROPOUT_TWIN_LAUNCHES[family]}
        check(counts == want, f"tiny {family} twin (dropout {mode}): "
                              f"launches {counts} != {want}")
        drop_twins[f"{family}, {mode}"] = counts
    twin_drop = phase_tiny_recovery_twin("dense", dropout_rate=DROPOUT_RATE)
    want = {**twin_dense,
            "threefry_dropout": DROPOUT_TWIN_LAUNCHES["dense recovery"]}
    check(twin_drop == want, f"tiny dense recovery twin (dropout): launches "
                             f"{twin_drop} != {want}")
    for name, errs in kernel_path_shapes(gen).items():
        recs[name].update(errs)
    torch.cuda.empty_cache()
    paths = {"codeqwen1.5-7b": phase_train(
        dataclasses.replace(cfg, num_layers=2), DENSE_LAUNCHES, steps=2)[0]}
    gc.collect()                 # free the dense cluster's host and card state
    torch.cuda.empty_cache()
    # this slice's path: the same model at dropout 0.1, samples' streams
    # addressed by their global ids, 2 steps
    paths["codeqwen1.5-7b dropout 0.1"] = phase_train(
        dataclasses.replace(cfg, num_layers=2, dropout_rate=DROPOUT_RATE),
        DENSE_DROPOUT_LAUNCHES, steps=2, profile_step=1,
        rng_mode="reshard")[0]
    gc.collect()
    torch.cuda.empty_cache()
    paths["mamba2-2.7b"], ssm = phase_train(
        dataclasses.replace(mamba2_2p7b.config(), num_layers=4), SSM_LAUNCHES,
        hw=H100_HW)
    paths["mamba2-2.7b recovery"], recoveries = phase_recovery(ssm)
    del ssm
    gc.collect()           # free the bf16 mamba2 cluster's host and card state
    torch.cuda.empty_cache()
    # the float32 mamba2 step on the float32 tensor-core SSD route, depth
    # cut to 2 layers, 2 steps
    paths["mamba2-2.7b float32"] = phase_train(
        dataclasses.replace(mamba2_2p7b.config(), num_layers=2,
                            dtype="float32"), SSM_F32_LAUNCHES, steps=2)[0]
    gc.collect()
    torch.cuda.empty_cache()
    scenario_paths, scenarios, scenario_s = phase_scenarios()
    paths.update(scenario_paths)
    fuzz_paths, fuzz_runs, fuzz_s = phase_fuzz()
    paths.update(fuzz_paths)
    kernels = [dict(name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1],
                    launches=sum(p[name] for p in paths.values()),
                    launches_by_path={k: p[name] for k, p in paths.items()},
                    **({"design": DESIGNS[name]} if name in DESIGNS else {}),
                    **recs[name]) for name in SOURCES]
    # the float32 flash route, the bf16 mma.sync flash route and the
    # CUDA-core SSD kernel are off the main paths; the tiny twins are where
    # they run.  The bf16 twins and the float32 chunk-64 ssm twin run the
    # tensor-core routes at small widths.
    by_name = {k["name"]: k for k in kernels}
    for name, path, counts in (
            ("flash_attention_tf32", "tiny-dense twin (float32)", tiny),
            ("flash_attention_tf32", "tiny-dense recovery twin (float32)",
             twin_dense),
            ("ssd_scan", "tiny-ssm twin (float32)", tiny_ssm),
            ("ssd_scan", "tiny-ssm recovery twin (float32)", twin_ssm),
            ("ssd_scan_sm90_f32", "tiny-ssm twin (float32, chunk 64)",
             tiny_ssm_f32),
            ("flash_attention_sm90", "tiny-dense twin (bf16)", tiny_bf16),
            *(("flash_attention_bf16_mma", f"tiny-dense twin ({twin})",
               counts) for twin, counts in tiny_mma.items()),
            ("ssd_scan_sm90", "tiny-ssm twin (bf16)", tiny_ssm_bf16),
            *(("threefry_dropout", f"tiny-{k.split(',')[0]} twin (float32, "
               f"dropout {DROPOUT_RATE},{k.split(',')[1]})", counts)
              for k, counts in drop_twins.items()),
            ("threefry_dropout", f"tiny-dense recovery twin (float32, "
             f"dropout {DROPOUT_RATE})", twin_drop)):
        by_name[name]["launches_by_path"][path] = counts[name]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"recoveries": recoveries}))
    log(json.dumps({"scenarios": scenarios, "phase_s": scenario_s}))
    log(json.dumps({"fuzz": fuzz_runs, "phase_s": fuzz_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
