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
   an element and instruction mixes printed, the CUDA-core SSD scan's
   16 builds (``ssd_scan.cu``) for no local-memory traffic and cp.async
   (LDGSTS) in their float32 builds, and rmsnorm's 72 builds
   (``rmsnorm.cu``: their registers and spills summed up) for no
   local-memory traffic and, on 16-byte vectors, LDG.E.128 and STG.E.128;
3. every kernel against its plain PyTorch version on the card at the main
   paths' shapes (rmsnorm [4096, 4096] with the first port's kernel
   (``rmsnorm_rowblock_cuda``) on the same inputs, then each of its routes
   (``RMSNORM_ROUTE_CASES``: both sides of the warp route's width limit,
   ragged d 1000 and 4095, x[:, 1:], MLA's strided kv_norm input with no
   copy kernel in its profile, a bf16 scale, 1 to 8192 rows, float32 at
   2560 and 5120, past the cap), each call exactly one launch, and its
   routes timed against each other (``rmsnorm_route_sweep``); flash
   attention [1, 4096, 32, 128]
   causal on all four routes: float32 on the 3xTF32 tensor-core route MHA
   and GQA, plus head_dim 16 and 64, ragged S 4000, bidirectional and a
   peaked softmax, each also against a float64 evaluation, with the
   CUDA-core kernel on the main case's inputs; bf16 at head_dim 16 and 32
   on the bf16 mma.sync route, each MHA and GQA, ragged S 4000,
   bidirectional, a peaked softmax and strided projection views, with the
   CUDA-core kernel on the MHA case's inputs; bf16 on the wgmma route MHA
   and GQA, plus head_dim 64, ragged S 4000, bidirectional, a peaked
   softmax and strided projection views, and the published models'
   prefill attention over 8 kv heads at head_dim 128, causal
   (``FLASH_MODEL_SHAPES``: llama4-scout [1, 1024, 40, 128];
   nemotron-4-15b, deepseek-67b and llama3-405b [1, 4096, 48 / 64 / 128,
   128] and phase 11's [1, 1024, 48 / 64 / 128, 128]; whisper-base's
   encoder [1, 1500, 8, 64] bidirectional, its last key tile ragged;
   internvl2-76b's prefill of 256 prefix embeddings and 1024 tokens
   [1, 1280, 64, 128] over 8 kv heads, causal), each timed beside SDPA
   (``is_causal`` to match); fused
   AdamW bitwise against the numpy
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
   plain-version and library-call times (rmsnorm, the first port's
   kernel and ``F.rms_norm``, each
   flash route and ``F.scaled_dot_product_attention`` interleaved, the
   bf16 mma.sync route with the CUDA-core kernel too; each SSD
   route beside
   the CUDA-core kernel and ``ref.ssd_chunked`` in the same dtype,
   composed of cuBLAS products); each SSD route's final state (the
   prefill's: bf16 and float32 tensor-core routes at mamba2's widths, one
   chunk and eight; the CUDA-core kernel at the tiny widths, one chunk and
   25, and at mamba2's) against the oracle's state and a float64 witness,
   y bitwise the same with the state asked for, and each tensor-core
   route's training launch timed beside its launch with the state; the
   content-addressed dropout kernel:
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
   dropout kernel; beside the ssm recovery twin and the dense one at
   dropout 0.1, a third cluster on the card on the seed path
   (``fast_path=False``) from the same weights, held to the card's fast
   cluster with ``==`` after every op (loss or record, every stage's
   master, mu and nu and every shard, the parameters, the ring's CRCs and
   the ring against its device shards, remap plans, tiers, layouts), its
   launches the fast cluster's but fused AdamW, one a (stage, live rank)
   a step (43 against 12); the MoE family's float32 twins (moe at capacity factor
   1.25, where tokens drop, moe with row dispatch, hybrid: attention,
   Mamba2 and Mamba2-MoE blocks on the 3xTF32 flash and CUDA-core SSD
   routes) and the moe recovery sequence at capacity factor 16, the CPU
   twin replaying the card's experts where a near-tie of the router's
   float32 input fell the other way (``route_twin``); the MLA twin
   (deepseek-v3's smoke config: MLA with q_lora, MoE after a dense layer,
   capacity factor 1.25) with the same replay, launches exact
   (``MLA_TWIN_LAUNCHES``: no flash launch, 4 rmsnorms a block); the
   audio family's enc-dec loss (``make_train_loss``, 16 frames a sample)
   and the vlm family's loss with 8 prefix embeddings a sample, forward
   and backward on the card against the CPU in float32 (``phase_loss_twin``:
   the loss within the twins' bound, every gradient leaf within the state
   vectors' bounds, launches exact); and the
   main-path kernels at the shapes recovery gives them (batch-2 items:
   rmsnorm on 8192 rows of 2560 and 5120, the SSD scan at
   [2, 4096, 80, 64]), rmsnorm in float32 at phase 8's [4096, 2560]
   and [4096, 5120], and rmsnorm in bf16 at phase 11's widths
   (``SERVE_NORM_WIDTHS``: 6144, 7168, 8192, 16384, MLA's 1536 and 512,
   the last a slice of a 576-wide row) on 1024 and 4 rows, and at
   whisper-base's 512 on 1500, 128 and 4 rows, against their plain
   versions;
5. the dense main path: ``VirtualCluster.train_step`` on codeqwen1.5-7b at
   its published widths and dtype, depth cut to 2 layers, dp=2, pp=2, seq
   4096, one step without dropout (cut from 2 for phase 11's time), then
   one step at dropout 0.1 (``rng_mode="reshard"``; cut from 2 for phase
   12's time), each with exact kernel
   launch counts (every flash launch on the tensor-core route, every
   dropout forward and backward on the dropout kernel: 32 launches) and
   the host ring snapshot bitwise equal to the device shards after every
   step, the dropout path's step under
   ``torch.profiler``: device time by kind (each hand-written kernel,
   cuBLAS products, other ATen kernels, memcpy by direction) and the
   device-busy share from the step's start to the snapshot's;
6. the ssm main path: the same on mamba2-2.7b, depth cut to 4 layers, 2
   steps (cut from 3 for the MoE slice's time), its cost model given the
   H100 data-sheet figures (peak bf16 rate, HBM
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
   to 2 layers, for one step (cut from 2 for the MoE slice's time), every
   SSD launch on the float32 tensor-core route; then its seed-path twin
   (``fast_path=False``), built from the same weights before that step,
   takes the step too: loss, every shard's master, mu and nu, the
   parameters and the ring (CRCs, and against its device shards) equal
   the fast step's with ``==``, one fused AdamW a (stage, rank), its step
   and snapshot seconds printed beside the fast step's
   (``phase_float32``);
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
   rank (1, 1) at step 1, rejoin at step 2, horizon 3, cut from 4 for the
   MoE slice's time) on mamba2-2.7b at
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
11. the serving plane (``repro_torch.serving``): the tiny dense (3xTF32
   flash route), ssm (CUDA-core SSD route, ragged prefills), moe, hybrid,
   MLA, MLA with the absorbed decode, dense and MLA on the chunked
   attention path, the audio family's enc-dec (32 frames a request: the
   encoder outputs migrate with the KV, a rebuild re-encodes) and the vlm
   family's engines on the card beside CPU twins of the port from
   the same weights, greedy and
   top-k, undisturbed, a SCALE_IN after two decode ticks (migration), a
   FAIL_STOP (rebuild) and the drop policy: stats, event logs, summaries
   and streams equal, logits within the kernel-consistency bounds, SCALE_IN
   streams equal to the undisturbed run's where routing cannot depend on
   batch mates; then codeqwen1.5-7b (32 layers, 8.19 B params) at its
   published widths and depth and mamba2-2.7b (64 layers, 2.70 B) at its
   published widths, served at 16 of its layers (``SERVE_SERVED_LAYERS``),
   and llama4-scout-17b-a16e at its published widths cut to 2 layers
   (6.47 B, capacity factor 16) and deepseek-v3-671b cut to 4 (15.1 B: its
   3 dense MLA layers and an MoE one; capacity factor 32), in bf16, random
   weights, 2 replicas x 4 slots, 8
   requests of 1024 prompt and 64 new tokens (four arriving after the
   event): greedy undisturbed, greedy and top-k (temperature 0.7, top_k 40)
   with a SCALE_IN of replica 0 after two decode ticks, every in-flight
   request migrated with zero drops, the migrated slots bitwise their
   source, the streams the undisturbed run's; the engine's bf16 logits
   against a full-sequence forward (held; codeqwen at its 32 layers,
   mamba2 at its first 8 layers, whose random 64 amplify rounding past any
   bf16 bound: see ``SERVE_GATE_LAYERS``; the MoE models' at their cut
   depth, a position whose route flipped on a near-tie printed, not held),
   every block decoding from the
   forward's inputs in float32 (held; an MoE block's experts cast a group
   at a time); prefill ms,
   decode ms a batched step, tokens/s, migration wall seconds, KV bytes
   moved, peak device memory; launches exact; then the dense
   nemotron-4-15b (32 layers, 15.6 B), deepseek-67b and llama3-405b (each
   cut to 4 layers: 4.45 B, 16.95 B) at their published widths, one
   replica x 4 slots, 4 greedy requests of 1024 + 16 tokens, with the same
   two gates; then whisper-base at its published widths and depth (6 + 6
   layers, 0.11 B) in the same fleet, 8 requests of 128-token prompts and
   64 new tokens, each with its 1500 frames, the SCALE_IN runs migrating
   the encoder outputs with the KV, its logits held to
   ``serve_logit_rtol``, every decoder block in float32, and one
   ``make_train_loss`` forward and backward at batch 2 x 448 tokens (the
   bf16 loss within one bf16 spacing of the float32 loss, every gradient
   leaf finite and nonzero); internvl2-76b at its published widths cut to
   4 layers (5.52 B) with its 256 prefix embeddings and 1024 tokens: a
   prefill with the prefix into a cache and 15 greedy decode steps held
   against the full forward with the prefix, every block in float32, and
   one ``train_loss`` with the prefix, forward and backward
   (``phase_vlm_prefix``); mamba2-2.7b at its widths cut to the logits
   gate's 8 layers, in float32: one prompt of 1024 tokens prefilled whole
   and as 600 + 424, the second part resumed from the carried state (the
   plain chunked scan from ``initial_state``), the last logits and every
   layer's SSM and conv states within 1e-4 of the tensor's max |value|,
   launches exact (``resumed_prefill_gate``); then ``launch/serve.py --smoke`` (mamba2-2.7b
   and whisper-base) and ``examples/torch_serve.py``;
12. the whole-model training launcher (``repro_torch.launch.train``):
   mamba2-2.7b at its published size (64 layers, 2.70 B params, bf16)
   through the launcher's command line, seq 512 x batch 2, 3 steps, and
   codeqwen1.5-7b at its published widths cut to 8 layers (2.62 B: its 32
   layers' weights, gradients and AdamW state would take 131 GB) through
   ``train``, seq 1024 x batch 2, 2 steps: every tree on the card
   (weights, gradients, float32 master, mu and nu: 12 bytes a parameter,
   checked), the first loss within one bf16 spacing of a float32 forward's
   on the same weights and batch, launches exact a step (rmsnorm 2L + 1,
   the SSD or wgmma flash route L, fused AdamW once a distinct parameter),
   ms a step and an AdamW update, peak device memory; in mamba2's second
   step three parameters' AdamW update (the tied embedding, an in_proj, a
   norm scale) redone by the plain version on the card from copies of
   their gradients and pre-step state, held to the ``fused_adam`` tier
   (bitwise printed); ``train`` on the dense, ssm and audio smoke configs (float32)
   on the card and on the CPU from the same weights, 3 steps, losses
   within 1e-5 relative, parameters within the bf16 twins' bound; and
   ``CheckpointManager`` on the card: a save without blocking while
   training goes on in place, restored into a fresh tree bit for bit, two
   steps from it against two from the live state;
13. the dry-run cells (``launch/steps.build_cell`` on the (16, 16)
   production ``MeshShape``, ``cell.fn`` on the card): codeqwen1.5-7b at
   its published widths cut to 8 layers, its ``train_4k`` cell at seq 1024
   x batch 2 without remat and then with it (``torch.utils.checkpoint``,
   each block's kernels launched again in the recompute), one step each
   from the same seeded parameters and fresh AdamW state: the loss and
   every parameter, mu, nu and master bitwise equal, peak device memory
   of each; its ``prefill_32k`` cell at seq 1024 x batch 2 against
   ``transformer.forward``'s last position (the bf16 tier elementwise) and
   a ``decode_32k`` step at the last position after a prefill of the rest
   (the bf16 tier for each of the 2L + 1 residual branches and the head,
   a row's max error against its max logit); mamba2-2.7b at its widths cut
   to 8 layers, the same train check (the SSD kernel under recompute);
   whisper-base whole, its train cell (448 tokens, 1500 frames) with and
   without remat, and its prefill and decode cells against
   ``encdec.decode``; launches exact; on the host, each published
   config's sharded parameter leaves and the parameter bytes a rank holds
   on both production meshes;
14. the dry run (``python -m repro_torch.launch.dryrun --arch
   whisper_base --shape decode_32k --mesh single`` in a subprocess
   started before the kernels' build (phase 2) and waited for after it:
   the cell on meta DTensors over a fake process group of 256 ranks on
   this machine's torch, on the host's cores alone): its artifact's
   ``argument_size_in_bytes``, ``model_flops``, ``hlo_flops_per_device``
   and total collective bytes held to the values the CPU tests pin
   (``DRYRUN_PIN``), no launch counter moved (the dry run raises if one
   does), the child's seconds and the wait after the build logged;
15. a JSON line with every kernel's numbers (each record's ``shape`` names
   the inputs its times were taken on; rmsnorm's ``launch_cost``: the
   kernel, the first port's kernel and ``F.rms_norm`` at [1500, 512],
   [1024, 2560], [4, 4096], [4096, 4096] and MLA's kv_norm view
   [1024, 512 of 576], bf16, by events, by the profiler's device time a
   launch, by queued device time a call and by the host's time a call,
   with the route each took; its ``route_sweep``), one with every
   recovery's, one with phase 8's seed-path step, one with every
   scenario's, one with every fuzz run's, one with the serving phase's, one with the launcher's, one with the dry-run
   cells', one with the dry run's, one with each phase's wall seconds
   and, of them, the ring snapshot checks' (``PhaseClock``), then the
   result line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import (codeqwen1p5_7b,  # noqa: E402
                                 deepseek_67b, deepseek_v3_671b,
                                 internvl2_76b, llama3_405b,
                                 llama4_scout_17b_a16e, mamba2_2p7b,
                                 nemotron_4_15b, whisper_base)
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
from repro_torch.kernels import rmsnorm as rmsnorm_mod  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm_cuda, rmsnorm_rowblock_cuda)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan_cuda, ssd_scan_cuda_cores, uses_sm90 as ssd_uses_sm90,
    uses_sm90_f32 as ssd_uses_sm90_f32)
from repro_torch.kernels import threefry  # noqa: E402
from repro_torch.kernels.threefry import threefry_dropout_cuda  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import (GlobalBatchSampler,  # noqa: E402
                                       make_batch)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import (ATTN, ATTN_MOE, MAMBA,  # noqa: E402
                                       MAMBA_MOE)
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import RngCtx  # noqa: E402
from repro_torch.models.registry import ServingHooks, tiny_config  # noqa: E402
from repro_torch.optim import adam as adam_mod  # noqa: E402
from repro_torch.optim.adam import AdamConfig, adam_update_flat_np  # noqa: E402
from repro_torch.scenarios import (SCENARIOS, ClusterScenarioRunner,  # noqa: E402
                                   ClusterWorkload, Scenario, get_scenario,
                                   make_case, make_kernel_case, run_case,
                                   run_chaos_case, run_detector_chaos,
                                   run_scenario)
from repro_torch.scenarios.fuzz import default_chaos_checkers  # noqa: E402
from repro_torch.serving import (SLO, DropPolicy, Request,  # noqa: E402
                                 SamplerConfig, ServingEngine)
from repro_torch.serving.kvcache import tree_nbytes  # noqa: E402
from repro_torch.tree import at, leaves_with_paths, map_params  # noqa: E402
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
# the kernels of csrc/rmsnorm.cu's three routes (mangled or not)
RMSNORM_ROUTE_KERNELS = re.compile(r"rmsnorm_(?:warp|block|two_pass)_kernel")
# the kernels of csrc/, by the names the profiler gives them
HAND_WRITTEN_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_tf32_kernel",
                        "flash_fwd_bf16_mma_kernel", "flash_fwd_kernel",
                        "rmsnorm_warp_kernel", "rmsnorm_block_kernel",
                        "rmsnorm_two_pass_kernel", "rmsnorm_rowblock_kernel",
                        "fused_adam_kernel",
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
# the tiny moe twin with row-local dispatch (capacity per sample row)
MOE_ROW_TWIN = dict(moe_row_dispatch=True)
# the MoE family's float32 twins of phase 4: (family, twin)
MOE_TWINS = (("moe", "float32"), ("moe", "float32 row dispatch"),
             ("hybrid", "float32"))
# the MLA twin of phase 4 (twin "mla"): deepseek-v3's smoke config (MLA
# with q_lora, MoE after one dense layer, float32, capacity factor 1.25),
# whose 3 steps of 4 items launch exactly these: rmsnorm 4 a block (ln1,
# q_norm, kv_norm, ln2) and the final norm, 3 x 4 x (4 x 4 + 1); one
# fused AdamW a stage a step; no flash launch (MLA's attention is plain)
MLA_TWIN_LAUNCHES = {"rmsnorm": 204, "flash_attention": 0, "fused_adam": 6,
                     "ssd_scan": 0, "flash_attention_sm90": 0,
                     "ssd_scan_sm90": 0, "flash_attention_tf32": 0,
                     "ssd_scan_sm90_f32": 0, "flash_attention_bf16_mma": 0,
                     "threefry_dropout": 0, "rmsnorm_rowblock": 0}

SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:22"),
    "rmsnorm_rowblock": ("src/repro_torch/kernels/csrc/rmsnorm_rowblock.cu",
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
    "rmsnorm": "the row in registers as 16-byte vectors (one-element "
               "vectors where the width, base or row stride is not a "
               "multiple of 16 bytes), x read once with its row stride, the "
               "scale in its own dtype, the arguments as one packed record: "
               "a warp a row up to 4 vectors a lane, shuffles alone; wider, "
               "a block a row at 2 vectors a thread up to 384 threads (512 "
               "on fewer rows than SMs), then 4 or 8 up to 512, one "
               "shared-memory step; a two-pass block a row past 512 "
               "threads x 8 vectors",
    "rmsnorm_rowblock": "only when launched explicitly: the first port's "
                        "256-thread block a row, one-element loads, x read "
                        "twice, a float32 scale",
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
                  "threefry_dropout": 0, "rmsnorm_rowblock": 0}
# the same at dropout 0.1: per item and layer two dropouts (attention,
# MLP), each launched forward and backward: 2 layers x 2 ops x 2 x 4 items
# x 2 steps = 64
DENSE_DROPOUT_LAUNCHES = {**DENSE_LAUNCHES, "threefry_dropout": 64}
# the dropout path takes one step (cut from 2 for phase 12's time): half
DENSE_DROPOUT_STEP_LAUNCHES = {k: v // 2
                               for k, v in DENSE_DROPOUT_LAUNCHES.items()}
# the dense path without dropout takes one step (cut from 2 for phase 11's
# time): half of DENSE_LAUNCHES
DENSE_STEP_LAUNCHES = {k: v // 2 for k, v in DENSE_LAUNCHES.items()}
# the ssm path takes 2 steps (cut from 3 for the MoE slice's time): per
# item one SSD scan a layer, 2 rmsnorms a layer and the final norm
SSM_LAUNCHES = {"rmsnorm": 72, "flash_attention": 0, "fused_adam": 4,
                "ssd_scan": 0, "flash_attention_sm90": 0,
                "ssd_scan_sm90": 32, "flash_attention_tf32": 0,
                "ssd_scan_sm90_f32": 0, "flash_attention_bf16_mma": 0,
                "threefry_dropout": 0, "rmsnorm_rowblock": 0}
# exact launches over the step of the float32 mamba2 path (2 layers, 4
# items a step; 1 step, cut from 2 for the MoE slice's time): per item one
# SSD scan a layer, two rmsnorms a layer (the block's norm and the gated
# out_norm) and the final norm; one fused AdamW per stage a step.  Every
# SSD launch takes the float32 tensor-core kernel.
SSM_F32_LAUNCHES = {"rmsnorm": 20, "flash_attention": 0, "fused_adam": 2,
                    "ssd_scan": 0, "flash_attention_sm90": 0,
                    "ssd_scan_sm90": 0, "flash_attention_tf32": 0,
                    "ssd_scan_sm90_f32": 8, "flash_attention_bf16_mma": 0,
                    "threefry_dropout": 0, "rmsnorm_rowblock": 0}
# phase 8's seed-path step: one fused AdamW a (stage, rank), 2 x 2
SEED_F32_ADAM = 4
# exact launches over the 4 steps of phase 7: after a shrink each step is 2
# items of batch 2, after the scale-out 4 items of batch 1
RECOVERY_LAUNCHES = {"rmsnorm": 108, "flash_attention": 0, "fused_adam": 8,
                     "ssd_scan": 0, "flash_attention_sm90": 0,
                     "ssd_scan_sm90": 48, "flash_attention_tf32": 0,
                     "ssd_scan_sm90_f32": 0, "flash_attention_bf16_mma": 0,
                     "threefry_dropout": 0, "rmsnorm_rowblock": 0}
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
    entry, norm_regs, norm_spills = "", [], []
    for line in _build.last_build_log.splitlines():
        entry = line if "Compiling entry" in line else entry
        if RMSNORM_ROUTE_KERNELS.search(entry) and "arning" not in line:
            # rmsnorm.cu's 72 builds: summed up below
            used = re.search(r"Used (\d+) registers", line)
            norm_regs += [int(used.group(1))] if used else []
            if re.search(r"[1-9]\d* bytes spill", line):
                norm_spills.append(f"{entry.split()[-3]}: {line.strip()}")
            continue
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "arning")):
            log("  " + line.strip())
    log(f"  rmsnorm.cu: {len(norm_regs)} kernels, "
        f"{min(norm_regs, default=0)}-{max(norm_regs, default=0)} "
        f"registers, spills: {norm_spills or 'none'}")
    check(not norm_spills, "rmsnorm.cu: a build spills registers")
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
    returned, by dtype name, beside their instruction mixes.  rmsnorm's
    route kernels must not touch local memory either, and those on 16-byte
    vectors must load and store them (LDG.E.128, STG.E.128)."""
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
    norm = {f: c for f, c in counts.items()
            if RMSNORM_ROUTE_KERNELS.search(f)}
    # the first integer template argument is VEC, elements a vector
    wide = {f: c for f, c in norm.items()
            if re.search(r"_kernelI.*?Li(\d+)E", f).group(1) in ("4", "8")}
    check(len(norm) == 72 and len(wide) == 36,
          f"expected 72 rmsnorm route kernels (2 dtypes x 2 scale dtypes x "
          f"2 vector widths x 9), 36 of them on 16-byte vectors, in the "
          f"SASS; found {len(norm)} and {len(wide)}")
    check(all(c["LDL/STL"] == 0 for c in norm.values()),
          "rmsnorm.cu: local-memory traffic")
    narrow = {f: {op: n for op, n in mix[f].items()
                  if op.startswith(("LDG", "STG"))}
              for f, c in wide.items()
              if not (c["LDG.128"] > 0 and c["STG.128"] > 0)}
    check(not narrow, f"rmsnorm.cu: 16-byte loads and stores (LDG.E.128, "
                      f"STG.E.128) expected in every 16-byte-vector build; "
                      f"without them: {narrow}")
    log(f"  SASS rmsnorm.cu: {len(norm)} kernels, no LDL/STL; the "
        f"{len(wide)} 16-byte-vector builds with LDG.E.128 and STG.E.128")
    return pipes


def kernel_rmsnorm(gen) -> dict:
    """rmsnorm at [4096, 4096] in float32 and bf16 against the plain version
    under the unchanged tiers, the first port's kernel
    (``rmsnorm_rowblock_cuda``) on the same inputs; in bf16 both timed
    beside ``F.rms_norm`` and a copy of x.  Returns the records of both
    kernels."""
    rows, d, eps = 4096, 4096, 1e-5
    recs = {}
    for dtype, tier in ((torch.float32, "rmsnorm"),
                        (torch.bfloat16, "rmsnorm_bf16")):
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        want = ref.rmsnorm_reference(x, scale, eps)
        errs = {}
        for name, fn in (("rmsnorm", rmsnorm_cuda),
                         ("rmsnorm_rowblock", rmsnorm_rowblock_cuda)):
            ok, errs[name] = within(fn(x, scale, eps), want,
                                    ops.TOLERANCE_TIERS[tier])
            log(f"{name} {dtype}: max_abs_err {errs[name]:.3e} tier {tier} "
                f"ok={ok}")
            check(ok, f"{name} {dtype} outside {tier}")
        if dtype == torch.bfloat16:     # the main path's dtype
            nbytes = 2 * rows * d * x.element_size() + 4 * d
            b, by = bound(nbytes, 4 * rows * d, dtype)
            sc = scale.to(dtype)
            y = torch.empty_like(x)
            # the kernels and the library call in turn, 5 rounds of 50; a
            # copy of x, the same bytes read and written, as the yardstick
            # of what a stream reaches on this card
            med = interleaved_medians(
                {"rmsnorm": lambda: rmsnorm_cuda(x, scale, eps),
                 "rmsnorm_rowblock": lambda: rmsnorm_rowblock_cuda(
                     x, scale, eps),
                 "library": lambda: F.rms_norm(x, (d,), sc, eps),
                 "copy": lambda: y.copy_(x)}, 5, 50)
            log(f"  rmsnorm bf16 medians of 5 interleaved rounds of 50: "
                f"kernel {med['rmsnorm']:.5f} ms, first port's kernel "
                f"{med['rmsnorm_rowblock']:.5f} ms, F.rms_norm "
                f"{med['library']:.5f} ms, a copy of x "
                f"{med['copy']:.5f} ms, bound {b:.5f} ms ({by})")
            plain = time_ms(lambda: ref.rmsnorm_reference(x, scale, eps), 20)
            for name in ("rmsnorm", "rmsnorm_rowblock"):
                recs[name] = dict(shape=f"bfloat16 [{rows}, {d}]",
                                  max_abs_err=errs[name], ms=med[name],
                                  plain_ms=plain, bound_ms=b, bound_by=by,
                                  library_ms=med["library"],
                                  copy_ms=med["copy"])
    return recs


def rmsnorm_route(x: torch.Tensor, scale: torch.Tensor):
    """The plan ``rmsnorm_cuda`` takes for ``x`` and ``scale``."""
    stride = rmsnorm_mod.row_stride(x)
    if stride is None:
        x, stride = x.contiguous(), x.shape[-1]
    d = x.shape[-1]
    return rmsnorm_mod.plan(x.numel() // d, d, x.dtype, stride,
                            (x.data_ptr() | scale.data_ptr()) % 16 == 0)


def describe(p) -> str:
    return (f"{p.route} route, {p.vec}-element vectors, {p.vectors} a "
            f"thread, {p.threads} threads")


# each rmsnorm route against the plain version: (what, rows, d, width of
# the tensor the rows are a slice of, column offset, dtype, scale dtype,
# route, elements a vector)
RMSNORM_ROUTE_CASES = (
    ("the warp route at its limit", 1024, 1024, 1024, 0, BF16, F32,
     "warp", 8),
    ("the block route past the limit", 1024, 1032, 1032, 0, BF16, F32,
     "block", 8),
    ("the warp route at its limit, float32", 1024, 512, 512, 0, F32, F32,
     "warp", 4),
    ("the block route past the limit, float32", 1024, 516, 516, 0, F32,
     F32, "block", 4),
    ("ragged over the lanes (125 vectors)", 1024, 1000, 1000, 0, BF16, F32,
     "warp", 8),
    ("ragged over the threads (250 vectors)", 1024, 1000, 1000, 0, F32,
     F32, "block", 4),
    ("ragged d", 1024, 4095, 4095, 0, BF16, F32, "block", 1),
    ("ragged d, float32", 1024, 4095, 4095, 0, F32, F32, "block", 1),
    ("ragged narrow d", 64, 100, 100, 0, BF16, F32, "warp", 1),
    ("unaligned x[:, 1:]", 1024, 4095, 4096, 1, BF16, F32, "block", 1),
    ("unaligned x[:, 1:] of 513", 1024, 512, 513, 1, BF16, F32, "block",
     1),
    ("MLA's kv_norm, strided", 1024, 512, 576, 0, BF16, F32, "warp", 8),
    ("MLA's kv_norm, strided, float32", 1024, 512, 576, 0, F32, F32,
     "warp", 4),
    ("MLA's q_norm", 1024, 1536, 1536, 0, BF16, F32, "block", 8),
    ("bf16 scale", 1024, 4096, 4096, 0, BF16, BF16, "block", 8),
    ("bf16 scale", 1500, 512, 512, 0, BF16, BF16, "warp", 8),
    ("bf16 scale, float32 x", 1024, 2560, 2560, 0, F32, BF16, "block", 4),
    ("one row", 1, 512, 512, 0, BF16, F32, "warp", 8),
    ("one row", 1, 4096, 4096, 0, BF16, F32, "block", 8),
    ("a decode step", 4, 512, 512, 0, BF16, F32, "warp", 8),
    ("a decode step", 4, 4096, 4096, 0, BF16, F32, "block", 8),
    ("a decode step", 4, 8192, 8192, 0, BF16, F32, "block", 8),
    ("whisper-base's encoder", 1500, 512, 512, 0, BF16, F32, "warp", 8),
    ("1500 rows", 1500, 4096, 4096, 0, BF16, F32, "block", 8),
    ("8192 rows", 8192, 512, 512, 0, BF16, F32, "warp", 8),
    ("8192 rows", 8192, 4096, 4096, 0, BF16, F32, "block", 8),
    ("8192 rows", 8192, 7168, 7168, 0, BF16, F32, "block", 8),
    ("float32 mamba2 d_model", 1024, 2560, 2560, 0, F32, F32, "block", 4),
    ("float32 mamba2 d_inner", 1024, 5120, 5120, 0, F32, F32, "block", 4),
    ("llama3-405b's d_model", 64, 16384, 16384, 0, BF16, F32, "block", 8),
    ("llama3-405b's d_model", 1024, 16384, 16384, 0, BF16, F32, "block",
     8),
    ("llama3-405b's d_model, float32", 64, 16384, 16384, 0, F32, F32,
     "block", 4),
    ("a tiny twin's width", 64, 96, 96, 0, BF16, F32, "warp", 8),
    ("past the cap", 4, 40000, 40000, 0, BF16, F32, "two_pass", 8),
    ("past the cap, float32", 4, 20000, 20000, 0, F32, BF16, "two_pass",
     4),
    ("past the cap, ragged", 4, 40001, 40001, 0, BF16, F32, "two_pass", 1),
)


def kernel_rmsnorm_routes(gen) -> dict:
    """Each route of ``csrc/rmsnorm.cu`` (``RMSNORM_ROUTE_CASES``) against
    the plain version under the unchanged tiers, each call exactly one
    ``rmsnorm`` launch and nothing else; MLA's strided kv_norm input also
    under the profiler, which must show the one kernel and no copy.
    Returns the largest error by dtype."""
    worst = {}
    for what, rows, d, wide, off, dtype, sdtype, route, vec in \
            RMSNORM_ROUTE_CASES:
        xw = torch.randn(rows, wide, generator=gen, device="cuda").to(dtype)
        x = xw[:, off:off + d]
        scale = (1 + 0.1 * torch.randn(d, generator=gen,
                                       device="cuda")).to(sdtype)
        p = rmsnorm_route(x, scale)
        before = dict(_build.LAUNCHES)
        y = rmsnorm_cuda(x, scale, 1e-5)
        after = dict(_build.LAUNCHES)
        tier = "rmsnorm" if dtype == F32 else "rmsnorm_bf16"
        ok, err = within(y, ref.rmsnorm_reference(x, scale, 1e-5),
                         ops.TOLERANCE_TIERS[tier])
        label = (f"rmsnorm {what}: {dtype} [{rows}, {d}]"
                 f"{f' of {wide}' if wide != d else ''}, {sdtype} scale")
        log(f"{label}: {describe(p)}; max_abs_err {err:.3e} tier {tier} "
            f"ok={ok}")
        check((p.route, p.vec) == (route, vec),
              f"{label}: took {p}, expected the {route} route with "
              f"{vec}-element vectors")
        check({k: after[k] - before[k] for k in after if after[k] != before[k]}
              == {"rmsnorm": 1}, f"{label}: launches {before} -> {after}")
        check(ok, f"{label} outside {tier}")
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    kv = torch.randn(1024, 576, generator=gen, device="cuda").to(BF16)
    scale = 1 + 0.1 * torch.randn(512, generator=gen, device="cuda")
    for _ in range(3):       # a trace that recorded no launch is taken again
        kernels = device_us_by_kernel(
            lambda: rmsnorm_cuda(kv[:, :512], scale, 1e-5), 20)
        if kernels:
            break
    log(f"  rmsnorm on MLA's kv_norm view [1024, 512 of 576]: profile "
        f"{ {k: round(v, 2) for k, v in kernels.items()} }")
    check(set(kernels) == {"rmsnorm_warp_kernel"},
          f"MLA's kv_norm view: expected the warp route's kernel alone in "
          f"the profile, found {sorted(kernels)}")
    return worst


# A spin kernel's cycles a queued call in queued_us: ~150 us at the
# card's ~1.98 GHz, several times a wrapper's host time a call
SPIN_CYCLES_A_CALL = 300_000


def queued_us(fn, iters: int = 100) -> tuple:
    """Device microseconds a call of ``fn`` with the calls back to back:
    a spin kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues all ``iters`` calls, so CUDA events time the device (the gaps
    between launches included), not the host's launch rate.  Returns the
    time and whether the host still outlasted the spin (host-paced)."""
    fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES_A_CALL * iters)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) * 1e3 / iters,
            host_ms > spin.elapsed_time(start))


# the width limit between the warp and the block route, timed both ways
# (bf16 and float32 widths a warp can take, at a decode's 4 rows,
# whisper-base's 1500 and a batch-2 item's 8192); the warp route's rows a
# block; and the block route's vectors a thread (1, 2, 4, 8, threads
# following) at the published widths it takes, on 4, 1024 and 8192 rows
ROUTE_SWEEP_WIDTHS = ((BF16, (512, 1024, 1536, 2048)), (F32, (512, 1024)))
ROUTE_SWEEP_ROWS = (4, 1500, 8192)
WARP_SWEEP_WARPS = (2, 4, 8)
BLOCK_SWEEP_WIDTHS = (2560, 4096, 5120, 6144, 7168, 8192, 16384)


def rmsnorm_route_sweep(gen) -> dict:
    """Times the routes of ``csrc/rmsnorm.cu`` against each other on the
    same inputs (``queued_us``, 100 calls a point), each variant first held
    to the plain version: the warp and the block route at the widths both
    take (``WARP_ROUTE_MAX_VECTORS`` in ``kernels/rmsnorm.py`` is set from
    this), the warp route at 2, 4 and 8 rows a block, and the block route
    at 1, 2, 4 and 8 vectors a thread at ``BLOCK_SWEEP_WIDTHS`` (its rule
    in ``block_plan`` is set from this).  Returns the times by point."""
    out = {}

    def point(key, x, scale, p):
        tier = "rmsnorm" if x.dtype == F32 else "rmsnorm_bf16"
        ok, err = within(rmsnorm_cuda(x, scale, 1e-5, route=p),
                         ref.rmsnorm_reference(x, scale, 1e-5),
                         ops.TOLERANCE_TIERS[tier])
        check(ok, f"rmsnorm sweep {key} ({p}): outside {tier}, {err:.3e}")
        us, paced = queued_us(lambda: rmsnorm_cuda(x, scale, 1e-5, route=p))
        out[key] = dict(us=us, plan=p._asdict(), host_paced=paced)
        return us, paced

    for dtype, widths in ROUTE_SWEEP_WIDTHS:
        vec = 16 // (4 if dtype == F32 else 2)
        for d in widths:
            for rows in ROUTE_SWEEP_ROWS:
                x = torch.randn(rows, d, generator=gen,
                                device="cuda").to(dtype)
                scale = 1 + 0.1 * torch.randn(d, generator=gen,
                                              device="cuda")
                w, wp = point(f"{dtype} [{rows}, {d}] warp", x, scale,
                              rmsnorm_mod.warp_plan(vec, d // vec))
                b, bp = point(f"{dtype} [{rows}, {d}] block", x, scale,
                              rmsnorm_mod.block_plan(
                                  vec, d // vec,
                                  few_rows=rows < rmsnorm_mod.FEW_ROWS))
                log(f"  rmsnorm sweep {dtype} [{rows}, {d}]: warp route "
                    f"{w:.3f} us, block route {b:.3f} us a call (queued"
                    f"{', host-paced' if wp or bp else ''})")
    for rows in (1500, 8192):
        x = torch.randn(rows, 512, generator=gen, device="cuda").to(BF16)
        scale = 1 + 0.1 * torch.randn(512, generator=gen, device="cuda")
        times = {w: point(f"bf16 [{rows}, 512] warp, {w} rows a block", x,
                          scale, rmsnorm_mod.warp_plan(8, 64, w))
                 for w in WARP_SWEEP_WARPS}
        log(f"  rmsnorm sweep bf16 [{rows}, 512], warp route by rows a "
            f"block: " + ", ".join(f"{w}: {t[0]:.3f} us" for w, t in
                                   times.items()))
    for d in BLOCK_SWEEP_WIDTHS:
        for rows in (4, 1024, 8192):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(BF16)
            scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
            times = {}
            for v in (1, 2, 4, 8):
                p = rmsnorm_mod.block_plan(8, d // 8, v)
                if p.route == "block" and p.threads >= 64:
                    what = f"{p.threads} x {p.vectors}"
                    times[what] = point(f"bf16 [{rows}, {d}] block, "
                                        f"{what}", x, scale, p)
            log(f"  rmsnorm sweep bf16 [{rows}, {d}], block route by "
                f"threads x vectors: " + ", ".join(
                    f"{k}: {v[0]:.3f} us" for k, v in times.items()))
            del x
    return out


# the rmsnorm kernel, the first port's kernel and F.rms_norm, bf16, by
# (rows, d, width of the tensor the rows are a slice of): where the first
# kernel lost by events (run 82: whisper-base's encoder norm [1500, 512]),
# the launcher's mamba2 norm [1024, 2560] (seq 512 x batch 2), a decode's
# [4, 4096], phase 3's [4096, 4096] and MLA's kv_norm input, a view
RMSNORM_COST_SHAPES = ((1500, 512, 512), (1024, 2560, 2560),
                       (4, 4096, 4096), (4096, 4096, 4096),
                       (1024, 512, 576))


def host_call_us(fn, iters: int) -> float:
    """Host microseconds a call of ``fn`` (the enqueue: no synchronize
    inside the timed loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def host_call_medians(fns: dict, rounds: int, iters: int) -> dict:
    """Median over ``rounds`` of each function's ``host_call_us``, the
    functions taken in turn within each round."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(host_call_us(fn, iters))
    return {name: float(np.median(t)) for name, t in times.items()}


def rmsnorm_launch_cost(gen) -> dict:
    """At each of ``RMSNORM_COST_SHAPES``: the kernel's wrapper with the
    scale in float32 (the models' norms) and in bf16 (read as it is), the
    first port's kernel (``rmsnorm_rowblock_cuda``: a strided x copied
    first, a bf16 scale cast), and ``F.rms_norm``, each four ways: CUDA
    events (medians of 5 interleaved rounds of 50 calls; host-paced where a
    call's host time exceeds its device time), the profiler's device
    microseconds a launch by kernel, the device's microseconds a call with
    the calls queued (``queued_us``), and the host's microseconds a call
    (medians of 5 interleaved rounds of 200).  Logs the route each shape
    takes."""
    eps, out = 1e-5, {}
    for rows, d, wide in RMSNORM_COST_SHAPES:
        x = torch.randn(rows, wide, generator=gen, device="cuda").to(
            torch.bfloat16)[:, :d]
        s32 = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        s16 = s32.to(torch.bfloat16)
        fns = {"kernel": lambda: rmsnorm_cuda(x, s32, eps),
               "kernel, bf16 scale": lambda: rmsnorm_cuda(x, s16, eps),
               "first port's kernel": lambda: rmsnorm_rowblock_cuda(
                   x, s32, eps),
               "F.rms_norm": lambda: F.rms_norm(x, (d,), s16, eps)}
        events = interleaved_medians(fns, 5, 50)
        device = {k: device_us_by_kernel(fn, 50) for k, fn in fns.items()}
        queued = {k: queued_us(fn)[0] for k, fn in fns.items()}
        host = host_call_medians(fns, 5, 200)
        b, by = bound(2 * rows * d * 2 + 4 * d, 4 * rows * d, torch.bfloat16)
        key = f"[{rows}, {d}]" + (f" of {wide}" if wide != d else "")
        route = describe(rmsnorm_route(x, s32))
        out[key] = dict(route=route, events_ms=events,
                        device_us_by_kernel=device,
                        device_us_a_call={k: sum(v.values())
                                          for k, v in device.items()},
                        queued_us_a_call=queued, host_us_a_call=host,
                        bound_ms=b, bound_by=by)
        rounded = {k: {n: round(u, 2) for n, u in v.items()}
                   for k, v in device.items()}
        log(f"rmsnorm launch cost bf16 {key} ({route}): events ms "
            f"{ {k: round(v, 5) for k, v in events.items()} }; device us "
            f"by kernel {rounded}; queued device us a call "
            f"{ {k: round(v, 3) for k, v in queued.items()} }; host us a "
            f"call { {k: round(v, 2) for k, v in host.items()} }; bound "
            f"{b:.5f} ms ({by})")
    return out

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
    for model in FLASH_MODEL_SHAPES:
        recs["flash_attention_sm90"][model] = flash_model_shape(gen, model)
        torch.cuda.empty_cache()
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


# the wgmma flash route at the published models' attention shapes: name ->
# (S, H, Hkv, head_dim, causal); llama4-scout's 1024-token prefill at its
# group of 5, and the dense configs' at groups of 6, 8 and 16: 4096
# tokens, and the 1024 of phase 11's served prefills; whisper-base's
# encoder over its 1500 frames (bidirectional, head_dim 64, a ragged last
# tile: 1500 = 11 x 128 + 92) and internvl2-76b's prefill of 256 prefix
# embeddings and 1024 tokens; codeqwen1.5-7b's training step in phase 12,
# two sequences of 1024 (the sixth entry: the batch, else 1)
FLASH_MODEL_SHAPES = {"llama4_scout": (1024, 40, 8, 128, True),
                      "nemotron_4_15b": (4096, 48, 8, 128, True),
                      "deepseek_67b": (4096, 64, 8, 128, True),
                      "llama3_405b": (4096, 128, 8, 128, True),
                      "nemotron_4_15b_s1024": (1024, 48, 8, 128, True),
                      "deepseek_67b_s1024": (1024, 64, 8, 128, True),
                      "llama3_405b_s1024": (1024, 128, 8, 128, True),
                      "whisper_base_encoder": (1500, 8, 8, 64, False),
                      "internvl2_76b": (1280, 64, 8, 128, True),
                      "codeqwen1p5_7b_train": (1024, 32, 32, 128, True, 2)}


def flash_model_shape(gen, model: str) -> dict:
    """The bf16 wgmma route at a published model's attention
    (``FLASH_MODEL_SHAPES``: its query heads over its kv heads, a prefill
    or encoder pass of S tokens) against the plain version under the bf16
    tier, timed beside ``F.scaled_dot_product_attention`` (``enable_gqa``,
    ``is_causal`` to match) in 5 interleaved rounds of 10.  Returns its
    record."""
    S, H, Hkv, d, causal, *batch = FLASH_MODEL_SHAPES[model]
    B = batch[0] if batch else 1
    q = torch.randn(B, S, H, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, Hkv, d, generator=gen, device="cuda")
            .bfloat16() for _ in "kv")
    check(uses_sm90(q.dtype, d), f"{model}'s attention must take the "
                                 f"wgmma flash route")
    before = _build.LAUNCHES["flash_attention_sm90"]
    o = flash_attention_cuda(q, k, v, causal)
    check(_build.LAUNCHES["flash_attention_sm90"] == before + 1,
          "flash_attention_cuda did not launch flash_attention_sm90 once")
    tier = ops.TOLERANCE_TIERS["flash_attention_bf16"]
    ok, err = within(o, ref.gqa_attention_reference(q, k, v, causal=causal),
                     tier)
    mask = "causal" if causal else "bidirectional"
    name = f"flash sm90 bf16 B={B} S={S} H={H} Hkv={Hkv} hd={d} {mask} " \
        f"({model})"
    log(f"{name}: max_abs_err {err:.3e} tier flash_attention_bf16 ok={ok}")
    check(ok, f"{name} outside flash_attention_bf16")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    med = interleaved_medians(
        {"kernel": lambda: flash_attention_cuda(q, k, v, causal),
         "library": lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=causal, enable_gqa=True)}, 5, 10)
    plain = time_ms(lambda: ref.gqa_attention_reference(q, k, v,
                                                        causal=causal), 3)
    # q-k pairs the mask keeps: all of them bidirectional
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    nbytes = (2 * B * S * H * d + 2 * B * S * Hkv * d) * q.element_size()
    b, by = bound(nbytes, 4 * d * pairs, q.dtype)
    # a launch as short as llama4-scout's is near the host's dispatch
    # time, so the profiler's device time a launch stands beside the
    # events' times
    dev = {which: device_us_by_kernel(fn, 10) for which, fn in (
        ("kernel", lambda: flash_attention_cuda(q, k, v, causal)),
        ("library", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)))}
    log(f"  {name}: ms {med['kernel']:.4f} (median of 5 interleaved rounds "
        f"of 10) plain_ms {plain:.3f} library_ms {med['library']:.4f} "
        f"(F.scaled_dot_product_attention, enable_gqa) bound_ms {b:.4f} "
        f"({by}); device us a launch (torch.profiler): kernel "
        f"{dev['kernel']}, library {dev['library']}")
    return dict(shape=f"bfloat16 q [{B}, {S}, {H}, {d}], k, v [{B}, {S}, "
                      f"{Hkv}, {d}] {mask}", max_abs_err=err,
                ms=med["kernel"], plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=med["library"], device_us_by_kernel=dev)


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


# phase 11's rmsnorm widths (d, width of the tensor its input is a slice
# of): the block norm at nemotron-4-15b's, deepseek-v3's, deepseek-67b's
# and llama3-405b's d_model; deepseek-v3's q_norm (q_lora_rank 1536) and
# kv_norm (kv_lora_rank 512, the first 512 of wkv_a's 512 + 64 outputs)
SERVE_NORM_WIDTHS = ((6144, 6144), (7168, 7168), (8192, 8192),
                     (16384, 16384), (1536, 1536), (512, 576))
# whisper-base's norms (d_model 512, contiguous): the encoder's over 1500
# frames, a decoder prefill's over a 128-token prompt, and a decode step's
# over 4 slots
WHISPER_NORM_ROWS = (1500, 128, 4)
# phase 12's rmsnorm shapes (rows, d): mamba2-2.7b's block norm and gated
# out_norm at seq 512 x batch 2, codeqwen1.5-7b's norms at seq 1024 x 2
LAUNCHER_NORM_SHAPES = ((1024, 2560), (1024, 5120), (2048, 4096))


def kernel_path_shapes(gen) -> dict:
    """The main-path kernels at the shapes the later paths give them.
    Phase 7 after a shrink (each item two sequences): rmsnorm in bf16 on
    8192 rows of mamba2's 2560 (the block norm) and 5120 (the gated
    out_norm), and the tensor-core SSD scan at [2, 4096, 80, 64], n 128,
    chunk 256, x, B and C views of one silu-activated activation.  Phase 8
    (float32 mamba2, one sequence an item): rmsnorm in float32 on 4096 rows
    of 2560 and 5120, under the float32 ``rmsnorm`` tier (its SSD scan is
    kernel_ssd's float32 main case).  Phase 11's served models in bf16, a
    1024-token prefill and a decode step of 4 slots: rmsnorm on 1024 and 4
    rows of ``SERVE_NORM_WIDTHS``, MLA's kv_norm input as the path gives
    it, a slice of wkv_a's wider output; whisper-base's 512 on
    ``WHISPER_NORM_ROWS``.  Each against its plain version under the tier
    of phase 3; whisper-base's encoder norm [1500, 512] also timed beside
    ``F.rms_norm`` and the plain version.  Phase 12's launcher in bf16:
    rmsnorm on 1024 rows of mamba2's 2560 and 5120 (seq 512 x batch 2)
    and on 2048 rows of codeqwen's 4096 (seq 1024 x batch 2), and the
    tensor-core SSD scan at [2, 512, 80, 64], n 128, chunk 256 (two chunks
    a sequence).  Returns, by kernel, the records' max_abs_err entries and
    that timing."""
    errs = {"rmsnorm": {}, "ssd_scan_sm90": {}}

    def held(x, tier, key):
        rows, d = x.shape
        scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        before = _build.LAUNCHES["rmsnorm"]
        y = rmsnorm_cuda(x, scale, 1e-5)
        check(_build.LAUNCHES["rmsnorm"] == before + 1,
              f"rmsnorm_cuda did not launch its kernel for {x.dtype}")
        ok, err = within(y, ref.rmsnorm_reference(x, scale, 1e-5),
                         ops.TOLERANCE_TIERS[tier])
        what = f"rmsnorm {x.dtype} [{rows}, {d}]" + (
            "" if x.is_contiguous() else f" (row stride {x.stride(0)})")
        log(f"{what}: max_abs_err {err:.3e} tier {tier} ok={ok}")
        check(ok, f"{what} outside {tier}")
        errs["rmsnorm"][key] = max(errs["rmsnorm"].get(key, 0.0), err)

    for dtype, rows, tier, key in (
            (torch.bfloat16, 2 * 4096, "rmsnorm_bf16",
             "recovery_shapes_max_abs_err"),
            (torch.float32, 4096, "rmsnorm",
             "float32_path_shapes_max_abs_err")):
        for d in (2560, 5120):
            held(torch.randn(rows, d, generator=gen, device="cuda").to(dtype),
                 tier, key)
    for rows in (1024, 4):
        for d, wide in SERVE_NORM_WIDTHS:
            x = torch.randn(rows, wide, generator=gen, device="cuda")
            held(x.bfloat16()[:, :d], "rmsnorm_bf16",
                 "serving_shapes_max_abs_err")
    for rows in WHISPER_NORM_ROWS:
        held(torch.randn(rows, 512, generator=gen, device="cuda").bfloat16(),
             "rmsnorm_bf16", "serving_shapes_max_abs_err")
    for rows, d in LAUNCHER_NORM_SHAPES:
        held(torch.randn(rows, d, generator=gen, device="cuda").bfloat16(),
             "rmsnorm_bf16", "launcher_shapes_max_abs_err")
    x = torch.randn(WHISPER_NORM_ROWS[0], 512, generator=gen,
                    device="cuda").bfloat16()
    scale = 1 + 0.1 * torch.randn(512, generator=gen, device="cuda")
    sc = scale.to(x.dtype)
    med = interleaved_medians(
        {"kernel": lambda: rmsnorm_cuda(x, scale, 1e-5),
         "library": lambda: F.rms_norm(x, (512,), sc, 1e-5)}, 5, 50)
    b, by = bound(2 * x.numel() * x.element_size() + 4 * 512, 4 * x.numel(),
                  x.dtype)
    errs["rmsnorm"]["whisper_encoder_norm"] = dict(
        shape=f"bfloat16 [{WHISPER_NORM_ROWS[0]}, 512]", ms=med["kernel"],
        library_ms=med["library"], bound_ms=b, bound_by=by,
        plain_ms=time_ms(lambda: ref.rmsnorm_reference(x, scale, 1e-5), 20))
    log(f"rmsnorm bf16 [{WHISPER_NORM_ROWS[0]}, 512] (whisper-base's encoder "
        f"norm): kernel {med['kernel']:.5f} ms, F.rms_norm "
        f"{med['library']:.5f} ms (medians of 5 interleaved rounds of 50), "
        f"bound {b:.5f} ms ({by})")
    b, h, p, n, chunk = 2, 80, 64, 128, 256
    for s, key in ((4096, "recovery_shapes_max_abs_err"),
                   (512, "launcher_shapes_max_abs_err")):
        xBC = F.silu(torch.randn(b, s, h * p + 2 * n, generator=gen,
                                 device="cuda")).to(torch.bfloat16)
        x = xBC[..., :h * p].reshape(b, s, h, p)
        B = xBC[..., h * p:h * p + n].reshape(b, s, 1, n)
        C = xBC[..., h * p + n:].reshape(b, s, 1, n)
        dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        check(ssd_uses_sm90(torch.bfloat16, p, n, chunk),
              "the batch-2 SSD scan must take the tensor-core route")
        before = _build.LAUNCHES["ssd_scan_sm90"]
        y = ssd_scan_cuda(x, dt, A, B, C, chunk)
        check(_build.LAUNCHES["ssd_scan_sm90"] == before + 1,
              "ssd_scan_cuda did not launch ssd_scan_sm90 once")
        Bh, Ch = (t.repeat_interleave(h, dim=2) for t in (B, C))
        ok, err = within(y, ref.ssd_reference(x, dt, A, Bh, Ch)[0],
                         ops.TOLERANCE_TIERS["ssd_scan_bf16"])
        what = f"ssd_scan bf16 [{b}, {s}, {h}, {p}] on the tensor cores"
        log(f"{what}: max_abs_err {err:.3e} ok={ok}")
        check(ok, f"{what} outside ssd_scan_bf16")
        errs["ssd_scan_sm90"][key] = err
    return errs


def phase_tiny_twin(family: str, twin: str = "float32",
                    dropout_rate: float = 0.0,
                    rng_mode: str = "reshard") -> dict:
    """3 steps of a tiny cluster on the card and on the CPU: the float32
    tiny configuration (seq 16) within the reference's kernel-consistency
    bounds; the bf16 configuration of ``BF16_TWINS`` (``twin="bf16"``, seq
    128) or of ``BF16_MMA_TWINS`` (``twin="bf16 hd16"``, ``"bf16 hd32"``,
    dense, seq 128) within the bf16 twins' bound; or ``F32_SM90_SSM_TWIN``
    (``twin="float32 sm90"``, seq 128), ``MOE_ROW_TWIN`` (``twin="float32
    row dispatch"``, seq 16) or deepseek-v3's smoke config (``twin="mla"``,
    seq 16) within the float32 bounds; at ``dropout_rate`` under
    ``rng_mode``.  An MoE config's twin replays the card's experts
    on the CPU where a near-tie flipped (``route_twin``) and counts the
    pairs the card kept: some drop exactly when the capacity factor gives
    an expert fewer places than tokens.  Returns the card's launch
    counts."""
    name = f"tiny {family} twin ({twin}" + (
        f", dropout {dropout_rate} {rng_mode})" if dropout_rate else ")")
    bf16 = twin.startswith("bf16")
    if twin == "mla":
        cfg = dataclasses.replace(deepseek_v3_671b.smoke_config(),
                                  dropout_rate=dropout_rate)
    else:
        over = BF16_TWINS[family] if twin == "bf16" else {
            "float32": {}, "float32 row dispatch": MOE_ROW_TWIN,
            "float32 sm90": F32_SM90_SSM_TWIN, **BF16_MMA_TWINS}[twin]
        cfg = tiny_config(family, **over, dropout_rate=dropout_rate)
    if twin in BF16_MMA_TWINS:
        check(f"hd{cfg.head_dim}" == twin.split()[1]
              and (cfg.num_heads, cfg.num_kv_heads) == (4, 2),
              f"{name}: head_dim {cfg.head_dim}, heads {cfg.num_heads}/"
              f"{cfg.num_kv_heads}")
    kw = dict(global_batch=8, num_micro=2,
              seq_len=16 if twin in ("float32", "mla") else 128,
              rng_mode=rng_mode)
    cpu = VirtualCluster(cfg, 2, 2, device="cpu", **kw)
    # the CPU cluster's own tensors: bf16 leaves stay bf16 on the card
    init = (cpu.stem, cpu.layer_params, cpu.head)
    gpu = VirtualCluster(cfg, 2, 2, device="cuda", init_params=init, **kw)
    check(all(a.dtype == b.dtype for a, b in zip(gpu._leaves, cpu._leaves)),
          f"{name}: parameter dtypes differ between card and CPU")
    loss_ok = (lambda a, b: abs(a - b) <= BF16_LOSS_RTOL * abs(b)) if bf16 \
        else KCC.loss_within
    rtol = BF16_PARAM_RTOL if bf16 else KCC.PARAM_RTOL
    kept, flips = [], []
    _build.reset_launch_counts()
    with route_twin(flips), counting_kept(kept):
        for step in range(3):
            twin_step(name, step, gpu, cpu, loss_ok, rtol)
    counts = dict(_build.LAUNCHES)
    log_flips(name, flips)
    if cfg.num_experts:
        k, n = map(sum, zip(*kept))
        log(f"{name}: the card's MoE layers kept {k} of {n} routed (token, "
            f"expert) pairs (capacity factor {cfg.capacity_factor})")
        check((k < n) == (cfg.capacity_factor * cfg.top_k < cfg.num_experts),
              f"{name}: kept {k} of {n} pairs")
    log(f"{name} launches on the card: {counts}")
    return counts


# the whole-model loss twins of phase 4 (float32, tiny configs, batch 2 of
# 12 tokens): the audio family's enc-dec loss over 16 frames a sample, the
# vlm family's decoder loss after its 8 prefix embeddings a sample
LOSS_TWIN_BATCH, LOSS_TWIN_TOKENS, LOSS_TWIN_FRAMES = 2, 12, 16


def loss_backward(params, loss_fn, batch) -> tuple:
    """``loss_fn(params, batch)`` forward and backward, every tensor of
    ``params`` requiring its gradient for the call only: (the loss, the
    gradients in ``leaves_with_paths`` order, the launches, wall
    seconds)."""
    leaves = [t for _, t in leaves_with_paths(params)]
    for t in leaves:
        t.requires_grad_(True)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn(params, batch)
    loss.backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grads = [t.grad for t in leaves]
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return float(loss.detach()), grads, dict(_build.LAUNCHES), wall


def grads_ok(grads: list) -> bool:
    """Every gradient finite and nonzero."""
    return all(bool(torch.isfinite(g).all()) and bool(g.count_nonzero())
               for g in grads)


def forward_launches(cfg, frames: int = 0, tokens: int = 0) -> dict:
    """The launches of one whole-model forward without caches (a backward
    launches nothing: it differentiates the plain versions): the decoder's
    rmsnorm a norm (ln1, ln2 and, in an enc-dec decoder block, lnx; the
    final norm) and its route's flash launch a block; an enc-dec config's
    encoder adds 2 a block and ``enc_norm``, and a flash launch a block
    (its ``frames`` != ``tokens``: the cross-attention stays plain)."""
    want = {k: 0 for k in _build.LAUNCHES}
    route = serve_route(cfg, ATTN)
    if cfg.is_encdec:
        check(frames != tokens, "a cross-attention of as many tokens as "
                                "frames would launch the flash kernel too")
        n_enc = cfg.encoder_layers or cfg.num_layers
        n_dec = cfg.decoder_layers or cfg.num_layers
        want["rmsnorm"] = 2 * n_enc + 1 + 3 * n_dec + 1
        want[route] = n_enc + n_dec
    else:
        want["rmsnorm"] = 2 * cfg.num_layers + 1
        want[route] = cfg.num_layers
    return want


def phase_loss_twin(family: str) -> dict:
    """The tiny ``family`` config's whole-model loss (``make_train_loss``:
    the audio family's enc-dec loss, the vlm family's with prefix
    embeddings), forward and backward on the card and on the CPU from the
    same float32 weights and inputs: the loss within
    ``KCC.loss_within``, every gradient leaf nonzero and within
    ``KCC.PARAM_RTOL`` / ``KCC.PARAM_ATOL0`` of the CPU's (the state
    vectors' bounds before any step), launches exact
    (``forward_launches``).  Returns the card's launch counts."""
    cfg = tiny_config(family, dropout_rate=0.0)
    name = f"tiny {family} loss twin (float32)"
    cpu = R.init_model(torch.Generator().manual_seed(0), cfg)
    card = map_params(lambda t: t.to("cuda"), cpu)
    rng = np.random.default_rng(0)
    B, S = LOSS_TWIN_BATCH, LOSS_TWIN_TOKENS
    tok = rng.integers(0, cfg.vocab_size, size=(B, S))
    batch = {"tokens": tok, "labels": tok}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, LOSS_TWIN_FRAMES, cfg.d_model)).astype(np.float32)
    else:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_embeds, cfg.d_model)).astype(np.float32)
    (a, ga, counts, _), (b, gb, _, _) = (
        loss_backward(params, R.make_train_loss(cfg),
                      {k: torch.as_tensor(v, device=dev)
                       for k, v in batch.items()})
        for dev, params in (("cuda", card), ("cpu", cpu)))
    ga, gb = ([g.cpu().numpy() for g in gs] for gs in (ga, gb))
    check(KCC.loss_within(a, b), f"{name}: loss {a!r} (card) vs {b!r} (cpu)")
    worst = max(float(np.abs(x - y).max()) for x, y in zip(ga, gb))
    check(all(np.count_nonzero(x) for x in ga)
          and all(np.allclose(x, y, rtol=KCC.PARAM_RTOL, atol=KCC.PARAM_ATOL0)
                  for x, y in zip(ga, gb)),
          f"{name}: gradients zero or beyond the kernel-consistency bounds "
          f"(max |diff| {worst:.3e})")
    want = forward_launches(cfg, LOSS_TWIN_FRAMES if cfg.is_encdec else 0,
                            S)
    check(counts == want, f"{name}: launches {counts} != {want}")
    log(f"{name}: loss {a:.6f} (card) vs {b:.6f} (cpu); {len(ga)} gradient "
        f"leaves, max |diff| {worst:.3e}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def counting_kept(out: list):
    """While open, every MoE routing on the card appends (kept pairs,
    routed pairs)."""
    def count(logits, r):
        if r["keep"].is_cuda:
            out.append((int(r["keep"].sum()), r["keep"].numel()))
    return watching_routes(count)


# the largest card-vs-CPU difference of a token's router logits, as a share
# of its largest |logit|, at which a twin accepts that the two devices chose
# other experts: the bf16 tier's rtol (one bf16 rounding).  Rounding and the
# twins' state drift move them ~1e-6 apart; a routing fault (another
# token's row, a wrong expert) moves them by O(1)
ROUTE_FLIP_RTOL = ops.TOLERANCE_TIERS["flash_attention_bf16"]["rtol"]


@contextlib.contextmanager
def route_twin(flips: list):
    """While open, every MoE routing on the card queues its experts and
    router logits, and the CPU twin's next routing (the same call of the
    same sequence: the card's run goes first) compares its own top-k with
    them.  The two devices round the router's float32 input differently,
    so a token whose top-k boundary lies that close may take other experts
    on each (the reference's semantics, not a fault): the CPU then routes
    to the card's experts (``moe.route``'s ``experts``), and the token is
    appended to ``flips`` with the CPU's smallest gap among its top k + 1
    logits and the devices' largest logit difference, which must be within
    ``ROUTE_FLIP_RTOL`` of its largest |logit|.  Every queued routing must
    be replayed."""
    queue = collections.deque()
    orig = moe.route

    def twin(cfg, logits, cap, layout_cap, experts=None):
        if logits.is_cuda:
            r = orig(cfg, logits, cap, layout_cap, experts)
            queue.append((r["gate_idx"].cpu(), logits.detach().cpu()))
            return r
        check(bool(queue), "the CPU twin routed a call the card did not")
        idx, card = queue.popleft()
        r = orig(cfg, logits, cap, layout_cap, experts)
        if torch.equal(r["gate_idx"], idx):
            return r
        own = logits.detach()
        for g, t in (r["gate_idx"] != idx).any(-1).nonzero().tolist():
            top = own[g, t].topk(cfg.top_k + 1).values
            diff = float((own[g, t] - card[g, t]).abs().max())
            scale = float(own[g, t].abs().max())
            flips.append(dict(gap=float((top[:-1] - top[1:]).min()),
                              logit_rel_diff=diff / scale,
                              card=idx[g, t].tolist(),
                              cpu=r["gate_idx"][g, t].tolist()))
            check(diff <= ROUTE_FLIP_RTOL * scale,
                  f"card and CPU router logits {diff / scale:.3e} of max "
                  f"|logit| apart at a token they route differently: not a "
                  f"near-tie")
        return orig(cfg, logits, cap, layout_cap, idx)
    moe.route = twin
    try:
        yield
    finally:
        moe.route = orig
    check(not queue, f"{len(queue)} card routings the CPU twin never made")


def log_flips(name: str, flips: list) -> None:
    if flips:
        log(f"{name}: {len(flips)} token(s) routed on a near-tie, the CPU "
            f"twin replaying the card's experts: " + "; ".join(
                f"card {f['card']} cpu {f['cpu']}, gap {f['gap']:.3e}, "
                f"logits {f['logit_rel_diff']:.3e} apart" for f in flips))


def twin_step(name: str, step: int, gpu, cpu, loss_ok, rtol) -> None:
    """One train step of the card cluster and its CPU twin, the loss and
    every stage's master/mu/nu held to the twins' bounds."""
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


# seconds spent building and driving phase 4's seed-path twins so far
# (building the cluster and ``seed_twin_op``, its checks included)
seed_twin_s = [0.0]


def phase_tiny_recovery_twin(family: str, dropout_rate: float = 0.0,
                             rng_mode: str = "reshard", seed_twin=False,
                             **cfg_kw) -> dict:
    """The tiny float32 cluster (dp=4, pp=2, global batch 16) on the card
    and on the CPU through ``TWIN_SEQUENCE``: records, remap plans,
    integrity tiers and layouts equal exactly, losses and state within the
    kernel-consistency bounds after every step; at ``dropout_rate`` under
    ``rng_mode`` (0.1 is the reference's elastic test configuration), the
    config's other fields from ``cfg_kw``.  ``seed_twin``: a third cluster
    on the card on the seed path (``fast_path=False``) from the same
    weights, held to the card's fast cluster bit for bit after every op
    (``seed_twin_op``).  Returns the card fast cluster's launch counts."""
    cfg = tiny_config(family, num_layers=8 if family == "dense" else 4,
                      dropout_rate=dropout_rate, **cfg_kw)
    kw = dict(global_batch=16, num_micro=2, seq_len=16, rng_mode=rng_mode)
    cpu = VirtualCluster(cfg, 4, 2, device="cpu", **kw)
    init = params_to_numpy(cpu.stem, cpu.layer_params, cpu.head)
    gpu = VirtualCluster(cfg, 4, 2, device="cuda", init_params=init, **kw)
    t0 = time.perf_counter()
    seed = VirtualCluster(cfg, 4, 2, device="cuda", init_params=init,
                          fast_path=False, **kw) if seed_twin else None
    seed_twin_s[0] += time.perf_counter() - t0
    logs = {"cpu": [], "cuda": [], "seed": []}
    tiers = {"cpu": [], "cuda": [], "seed": []}
    for dev, cl in (("cpu", cpu), ("cuda", gpu), ("seed", seed)):
        if cl is not None:
            _pin_planner_clock(cl, logs[dev])
    orig = SnapshotPool.verify_and_repair
    flips = []
    seed_counts = collections.Counter()
    seed_adam = 0
    _build.reset_launch_counts()
    try:
        with route_twin(flips):
            for k, op in enumerate(TWIN_SEQUENCE):
                where = f"tiny {family} recovery twin op {k} {op}"
                out = _recovery_twin_op(where, op, gpu, cpu, logs, tiers,
                                        orig)
                if seed is not None:
                    if op[0] == "train":
                        seed_adam += sum(len(st.dp_ranks)
                                         for st in seed.stages if st.total)
                    t0 = time.perf_counter()
                    seed_counts.update(seed_twin_op(where, op, out, seed,
                                                    gpu, logs, tiers, orig))
                    seed_twin_s[0] += time.perf_counter() - t0
    finally:
        SnapshotPool.verify_and_repair = orig
    log_flips(f"tiny {family} recovery twin", flips)
    check("rebuilt" in tiers["cuda"] and "rederived" in tiers["cuda"],
          f"tiny {family} recovery twin: tiers {tiers['cuda']}")
    counts = dict(_build.LAUNCHES)
    if seed is not None:
        # the same forward and backward launches as the fast cluster; one
        # fused AdamW a (stage, live rank) a step where it has one a stage
        want = {**counts, "fused_adam": seed_adam}
        got = {k: seed_counts[k] for k in counts}
        check(got == want, f"tiny {family} seed twin: launches {got} != "
                           f"{want}")
        log(f"tiny {family} seed twin (card, fast_path=False): "
            f"{len(seed.recoveries)} recoveries, losses {seed.losses}: == "
            f"the card's fast cluster after every op (state, parameters, "
            f"ring, records, remap plans, tiers, layouts); launches {got} "
            f"(fused_adam {seed_adam}, the fast cluster's "
            f"{counts['fused_adam']})")
    log(f"tiny {family} recovery twin"
        f"{f' (dropout {dropout_rate} {rng_mode})' if dropout_rate else ''}: "
        f"{len(gpu.recoveries)} recoveries, "
        f"{len(logs['cuda'])} remap plans, tiers {tiers['cuda']}, layout "
        f"{gpu.layer_assignment}, dp_ranks "
        f"{[s.dp_ranks for s in gpu.stages]}: card == cpu; launches "
        f"{counts}")
    return counts


def same_layout(a: VirtualCluster, b: VirtualCluster) -> bool:
    """Equal layer assignments, stage DP groups and entries, per-rank
    micro-batch sizes and gradient weights."""
    return (a.layer_assignment == b.layer_assignment
            and [s.dp_ranks for s in a.stages] == [s.dp_ranks for s in b.stages]
            and [s.entries for s in a.stages] == [s.entries for s in b.stages]
            and a.per_rank_mbs == b.per_rank_mbs
            and a.grad_weights == b.grad_weights)


def _recovery_twin_op(where: str, op: tuple, gpu, cpu, logs: dict,
                      tiers: dict, verify):
    """One op of ``TWIN_SEQUENCE`` on the card, then on the CPU, each
    side's integrity tiers logged through ``verify`` (the original
    ``SnapshotPool.verify_and_repair``), then held.  Returns the card's
    result (a loss, a record or None)."""
    out = {}
    for dev, cl in (("cuda", gpu), ("cpu", cpu)):
        def logged(self, *a, _t=tiers[dev], **kk):
            res = verify(self, *a, **kk)
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
    check(same_layout(gpu, cpu), f"{where}: layouts differ")
    check(logs["cuda"] == logs["cpu"], f"{where}: remap plans differ")
    check(tiers["cuda"] == tiers["cpu"], f"{where}: tiers differ")
    check(op[0] == "corrupt" or snapshot_matches_device(gpu),
          f"{where}: ring snapshot != device shards")
    check(all(t.device.type == "cuda" for st in gpu.stages
              for t in st.flat.values()),
          f"{where}: stage state left the card")
    return out["cuda"]


def check_seed_equals_fast(where: str, seed, fast, ring: bool = True):
    """The seed-path cluster's state equals the fast one's with ``==``:
    master, mu and nu of every stage (each path through its own gather)
    and of every rank's shard, the parameters, the ring's CRCs; and, with
    ``ring``, the seed's host ring against its device shards."""
    for p, (ss, sf) in enumerate(zip(seed.stages, fast.stages)):
        for c in ("master", "mu", "nu"):
            a, b = seed._stage_full_vec(ss, c), fast._stage_full_vec(sf, c)
            if not torch.equal(a, b):
                i = int(torch.nonzero(a != b)[0])
                check(False, f"{where}: seed path stage {p} {c} differs "
                             f"first at element {i}: {a[i].item()!r} vs "
                             f"{b[i].item()!r}")
            del a, b
            check(all(torch.equal(ss.shard(r)[c], sf.shard(r)[c])
                      for r in ss.dp_ranks),
                  f"{where}: seed path stage {p} {c} shards differ")
    check(all(torch.equal(a, b) for a, b in zip(seed._leaves, fast._leaves)),
          f"{where}: seed path parameters differ")
    check([pl.crc for pl in seed.snapshots]
          == [pl.crc for pl in fast.snapshots]
          and all(not pl.batched for pl in seed.snapshots),
          f"{where}: seed path ring CRCs differ")
    check(not ring or snapshot_matches_device(seed),
          f"{where}: seed path ring snapshot != device shards")
    check(all(t.device.type == "cuda" for st in seed.stages
              for t in st.flat.values()),
          f"{where}: seed path stage state left the card")


def seed_twin_op(where: str, op: tuple, want, seed, fast, logs: dict,
                 tiers: dict, verify) -> dict:
    """One op of ``TWIN_SEQUENCE`` on the card's seed-path cluster after the
    fast one took it (``want``: what the fast cluster returned), held bit
    for bit: the loss or record, remap plans, tiers, layouts and
    ``check_seed_equals_fast``.  Returns the op's launches, which are then
    taken back off the counters, so that the fast cluster's counts stay
    its own."""
    before = dict(_build.LAUNCHES)

    def logged(self, *a, **kk):
        res = verify(self, *a, **kk)
        tiers["seed"].append(res[0])
        return res
    SnapshotPool.verify_and_repair = logged
    got = _twin_op(seed, op)
    delta = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    _build.LAUNCHES.update(before)
    check(got == want, f"{where}: seed twin {got!r} vs fast {want!r}")
    check(same_layout(seed, fast), f"{where}: seed twin layouts differ")
    check(logs["seed"] == logs["cuda"], f"{where}: seed twin remap plans")
    check(tiers["seed"] == tiers["cuda"], f"{where}: seed twin tiers")
    check_seed_equals_fast(where, seed, fast, ring=op[0] != "corrupt")
    return delta


# snapshot_matches_device's staging: device shards cross to the host in
# chunks of this many bytes through one pinned buffer (a pageable copy ran
# at ~2.3 GB/s, PERF.md §5), each chunk compared on COMPARE_THREADS threads
# (numpy releases the GIL for the comparison)
PINNED_CHUNK_BYTES = 256 << 20
COMPARE_THREADS = 8
_pinned: dict = {}
_compare_pool = ThreadPoolExecutor(COMPARE_THREADS)
# seconds spent in snapshot_matches_device so far (PhaseClock reads it)
snapshot_check_s = [0.0]


def _equal_chunk(a: np.ndarray, b: np.ndarray) -> bool:
    """np.array_equal over ``COMPARE_THREADS`` slices in parallel."""
    step = -(-a.size // COMPARE_THREADS)
    return all(_compare_pool.map(
        lambda i: np.array_equal(a[i:i + step], b[i:i + step]),
        range(0, a.size, step)))


def snapshot_matches_device(cl: VirtualCluster) -> bool:
    """Every ring holder's host copy equals the device shard it backs,
    element for element (``np.array_equal``)."""
    t0 = time.perf_counter()
    try:
        for st, pool in zip(cl.stages, cl.snapshots):
            for c in ("master", "mu", "nu"):
                shards = st.table.split(st.flat[c])
                for i in range(pool.n):
                    if not _shard_matches(shards[pool.backup_rank(i)],
                                          pool.host[i][c]):
                        return False
        return True
    finally:
        snapshot_check_s[0] += time.perf_counter() - t0


def _shard_matches(dev: torch.Tensor, host: np.ndarray) -> bool:
    if host.shape != tuple(dev.shape):
        return False
    per = PINNED_CHUNK_BYTES // dev.element_size()
    if dev.dtype not in _pinned:
        _pinned[dev.dtype] = torch.empty(per, dtype=dev.dtype,
                                         pin_memory=True)
    buf = _pinned[dev.dtype]
    for a in range(0, dev.numel(), per):
        b = min(a + per, dev.numel())
        buf[:b - a].copy_(dev[a:b])
        if not _equal_chunk(buf[:b - a].numpy(), host[a:b]):
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


def phase_train(cfg, want: dict, steps: int,
                profile_step: int | None = None, on_built=None,
                **cluster_kw) -> tuple:
    """``steps`` steps of ``VirtualCluster.train_step`` at dp=2, pp=2, global
    batch 4 in 2 micro-batches, seq 4096, random weights from seed 1; step
    ``profile_step`` under ``torch.profiler`` (``profiled_step``; its step
    time carries the profiler's cost).  ``on_built(cl)`` is called once
    the cluster is built, before its first step.  Returns the launch
    counts, the cluster and each step's wall seconds."""
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
    if on_built is not None:
        on_built(cl)
    _build.reset_launch_counts()
    step_s = []
    for step in range(steps):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if step == profile_step:
            loss, split = profiled_step(cl)
        else:
            loss = cl.train_step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        step_s.append(dt)
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
    return launches, cl, step_s


def phase_seed_step(seed: VirtualCluster, fast: VirtualCluster,
                    fast_step_s: float, want: dict) -> tuple:
    """Phase 8's seed-path twin: ``seed`` (``fast_path=False``, built from
    ``fast``'s weights before its step) takes one step, whose loss and
    state (``check_seed_equals_fast``) must equal ``fast``'s with ``==``;
    launches exact (``want``: one fused AdamW a (stage, rank)).  Its
    step and snapshot seconds are printed beside the fast step's.  Returns
    the launch counts and the record."""
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = seed.train_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    snap, fast_snap = seed.snapshot_seconds[-1], fast.snapshot_seconds[-1]
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(_build.LAUNCHES)
    name = f"{seed.cfg.name} ({seed.cfg.dtype}) seed path"
    log(f"{name}: step_s {dt:.3f} snapshot_s {snap:.3f} (share "
        f"{snap / dt:.3f}) against the fast path's step_s {fast_step_s:.3f} "
        f"snapshot_s {fast_snap:.3f} (share {fast_snap / fast_step_s:.3f}); "
        f"peak_mem_GB {peak:.2f} with the fast cluster held; launches "
        f"{launches}")
    check(launches == want, f"{name}: launches {launches} != {want}")
    check(loss == fast.losses[-1],
          f"{name}: loss {loss!r} != the fast path's {fast.losses[-1]!r}")
    check(same_layout(seed, fast), f"{name}: layouts differ")
    check_seed_equals_fast(name, seed, fast)
    log(f"{name}: loss {loss!r}, every shard's master/mu/nu, the "
        f"parameters and the ring == the fast path's")
    return launches, dict(step_s=dt, snapshot_s=snap, fast_step_s=fast_step_s,
                          fast_snapshot_s=fast_snap, peak_gb=peak)


def phase_float32() -> tuple:
    """Phase 8: the float32 mamba2 step on the float32 tensor-core SSD
    route, depth cut to 2 layers, 1 step; then its seed-path twin, built
    from the same weights before that step, takes the step too and must
    equal it (``phase_seed_step``).  Returns the launch counts by path and
    the seed step's record."""
    cfg32 = dataclasses.replace(mamba2_2p7b.config(), num_layers=2,
                                dtype="float32")
    built = {}

    def build_seed(cl):
        t0 = time.perf_counter()
        built["seed"] = VirtualCluster(
            cfg32, 2, 2, global_batch=4, num_micro=2, seq_len=4096,
            device="cuda", fast_path=False,
            init_params=(cl.stem, cl.layer_params, cl.head))
        built["setup_s"] = time.perf_counter() - t0
        log(f"{cfg32.name} ({cfg32.dtype}) seed path: set-up "
            f"{built['setup_s']:.1f} s (weights copied on the card, its "
            f"per-rank ring bootstrapped)")
    paths = {}
    paths["mamba2-2.7b float32"], fast, step_s = phase_train(
        cfg32, SSM_F32_LAUNCHES, steps=1, on_built=build_seed)
    paths["mamba2-2.7b float32 seed path"], rec = phase_seed_step(
        built["seed"], fast, step_s[0],
        {**SSM_F32_LAUNCHES, "fused_adam": SEED_F32_ADAM})
    rec["setup_s"] = built["setup_s"]
    return paths, rec


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
                                 rejoin_step=2, horizon=3)
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
    check([s["dp_width"] for s in res.steps] == [2, 1, 2],
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


# ---------------------------------------------------------------------------
# phase 3, SSD tier: the final state each route returns for a prefill
# ---------------------------------------------------------------------------
# (route, dtype, h, p, n, chunk, s, regime): mamba2-2.7b's widths on both
# tensor-core routes, one chunk (no state pass before this PR) and eight;
# the tiny ssm configurations' widths (p 16, n 16, chunk 8) on the CUDA-core
# kernel, one chunk and 25 (4 groups of 8 chunks, the last short); and the
# CUDA-core kernel at mamba2's widths (its chunk > 64 path)
SSD_FINAL_CASES = [
    ("ssd_scan_sm90", torch.bfloat16, 80, 64, 128, 256, 256, "typical"),
    ("ssd_scan_sm90", torch.bfloat16, 80, 64, 128, 256, 2048, "typical"),
    ("ssd_scan_sm90", torch.bfloat16, 80, 64, 128, 256, 2048, "carried"),
    ("ssd_scan_sm90_f32", torch.float32, 80, 64, 128, 256, 256, "carried"),
    ("ssd_scan_sm90_f32", torch.float32, 80, 64, 128, 256, 2048, "carried"),
    ("ssd_scan", torch.float32, 8, 16, 16, 8, 8, "carried"),
    ("ssd_scan", torch.float32, 8, 16, 16, 8, 200, "carried"),
    ("ssd_scan", torch.bfloat16, 80, 64, 128, 256, 2048, "carried"),
]


def kernel_ssd_final_state(gen) -> dict:
    """Each SSD route's final state (``final_state=True``) against the
    sequential oracle's, silu-activated views of one xBC as in the model, g
    1: within the route's tier of the float32 oracle elementwise, and of
    the float64 witness scaled by the state's terms (the oracle's state on
    |x|, |B|, |C|), as the signed y cases are held.  y with the state asked
    for is bitwise the y without.  Then the training launch (no state) and
    the prefill launch (the state) of each tensor-core route timed
    interleaved at [1, 4096, 80, 64].  Returns {route: record}."""
    out = {}
    for route, dtype, h, p, n, chunk, s, regime in SSD_FINAL_CASES:
        f32 = dtype == torch.float32
        tier_name = "ssd_scan" if f32 else "ssd_scan_bf16"
        tier = ops.TOLERANCE_TIERS[tier_name]
        xBC = F.silu(torch.randn(1, s, h * p + 2 * n, generator=gen,
                                 device="cuda")).to(dtype)
        x = xBC[..., :h * p].reshape(1, s, h, p)
        B = xBC[..., h * p:h * p + n].reshape(1, s, 1, n)
        C = xBC[..., h * p + n:].reshape(1, s, 1, n)
        if regime == "typical":
            dt = F.softplus(torch.randn(1, s, h, generator=gen,
                                        device="cuda"))
            A = -torch.linspace(1.0, 16.0, h, device="cuda")
        else:
            dt = 1e-3 + (1e-1 - 1e-3) * torch.rand(1, s, h, generator=gen,
                                                   device="cuda")
            A = -(0.05 + 0.95 * torch.rand(h, generator=gen, device="cuda"))
        run = ssd_scan_cuda_cores if route == "ssd_scan" else ssd_scan_cuda
        before = _build.LAUNCHES[route]
        y, fin = run(x, dt, A, B, C, chunk, True)
        y0 = run(x, dt, A, B, C, chunk)
        check(_build.LAUNCHES[route] == before + 2,
              f"final state: {route} not launched")
        check(torch.equal(y, y0), f"{route}: y changes when the final "
                                  f"state is asked for")
        Bh, Ch = (t.repeat_interleave(h, dim=2) for t in (B, C))
        want = ref.ssd_reference(x, dt, A, Bh, Ch)[1]
        d = [t.double() for t in (x, dt, A, Bh, Ch)]
        st64 = ref.ssd_reference(*d)[1]
        terms = ref.ssd_reference(d[0].abs(), d[1], d[2], d[3].abs(),
                                  d[4].abs())[1]
        ok, err = within(fin, want, tier)
        e64 = (fin.double() - st64).abs()
        witness = bool((e64 <= tier["atol"] + tier["rtol"] * terms).all())
        name = (f"final state {route} {str(dtype)[6:]} [1, {s}, {h}, {p}] "
                f"n {n} chunk {chunk} ({s // chunk} chunks) {regime}")
        log(f"{name}: max_abs_err {err:.3e} vs the float32 oracle (max "
            f"|state| {float(want.abs().max()):.3e}), {float(e64.max()):.3e} "
            f"vs float64; tier {tier_name} ok={ok}, witness ok={witness}")
        check(ok and witness, f"{name} outside {tier_name}")
        rec = out.setdefault(route, {"final_state_cases": []})
        rec["final_state_cases"].append(dict(
            case=name, max_abs_err=err, max_abs_err_float64=float(e64.max())))
        del xBC, x, B, C, Bh, Ch, y, y0, fin, want, d, st64, terms, e64
    b, s, h, p, n, chunk = 1, 4096, 80, 64, 128, 256
    for route, dtype in (("ssd_scan_sm90", torch.bfloat16),
                         ("ssd_scan_sm90_f32", torch.float32)):
        xBC = F.silu(torch.randn(b, s, h * p + 2 * n, generator=gen,
                                 device="cuda")).to(dtype)
        x = xBC[..., :h * p].reshape(b, s, h, p)
        B = xBC[..., h * p:h * p + n].reshape(b, s, 1, n)
        C = xBC[..., h * p + n:].reshape(b, s, 1, n)
        dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        med = interleaved_medians(
            {"training": lambda: ssd_scan_cuda(x, dt, A, B, C, chunk),
             "final state": lambda: ssd_scan_cuda(x, dt, A, B, C, chunk,
                                                  True)}, 5, 10)
        log(f"{route} [1, 4096, 80, 64] ms: training launch (no state) "
            f"{med['training']:.4f}, with the final state "
            f"{med['final state']:.4f} (medians of 5 interleaved rounds of "
            f"10)")
        out[route].update(training_ms=med["training"],
                          final_state_ms=med["final state"])
        del xBC, x, B, C, dt
    return out


# ---------------------------------------------------------------------------
# phase 11: the serving plane
# ---------------------------------------------------------------------------
SERVE_TINY = dict(dropout_rate=0.0)
SERVE_SAMPLERS = {"greedy": SamplerConfig(),
                  "top-k": SamplerConfig(method="topk", temperature=0.7,
                                         top_k=8, seed=3)}
SERVE_FULL_TOPK = SamplerConfig(method="topk", temperature=0.7, top_k=40,
                                seed=0)
# the engine-vs-full-forward logits bound of the full-width runs, declared
# before their first run: the bf16 tiers' rtol (ops.TOLERANCE_TIERS, 1e-2:
# one rounding to bf16) for each of the 65 residual branches and the head
# (2L + 1 at codeqwen's 32 layers, L + 1 at mamba2's 64), their independent
# errors adding as a random walk; per row, max |a - b| <= SERVE_LOGIT_RTOL
# * max |b| + atol.
SERVE_BF16 = ops.TOLERANCE_TIERS["flash_attention_bf16"]
SERVE_LOGIT_RTOL = SERVE_BF16["rtol"] * math.sqrt(65)


def serve_logit_rtol(cfg) -> float:
    """The logits bound of ``cfg``'s serving gate: ``SERVE_LOGIT_RTOL``,
    but an enc-dec config's by the same rule at its own depth, the bf16
    tier's rtol for each of its decoder's 3 residual branches a block
    (self-attention, cross-attention, MLP) and the head (whisper-base: 6
    blocks, rtol * sqrt(19), 4.36%); its encoder output is the same tensor
    in the engine and the forward (the prefill's encode of the same
    frames), not a branch that differs between them."""
    if not cfg.is_encdec:
        return SERVE_LOGIT_RTOL
    return SERVE_BF16["rtol"] * math.sqrt(
        3 * (cfg.decoder_layers or cfg.num_layers) + 1)
# the depth that bound is held at: codeqwen's full 32 layers; mamba2 at its
# published widths cut to its first 8 layers, since the random 64-layer
# mamba2 amplifies rounding itself (on an H100, PERF.md §6: decode vs
# forward 2-48% per step at 64 layers in bf16, <= 1.4% at 8;
# benchmarks/torch_serve_depth.py).  Even at 8 layers the bf16 forward is
# itself up to 14% off the float32 forward of the same weights where a
# request's logits run to ~800 (one repeated token), so mamba2's engine is
# held against that float32 forward, each row allowed the bf16 forward's
# own distance from it plus the bound: the cached decode may add no more
# than the bound to the error of the no-cache path.  Every block of both
# models at full depth is held in float32 (SERVE_BLOCK_TIERS)
# The other models are held at the depth they are served at (llama4-scout
# and deepseek-v3 cut to SERVE_MOE_CUTS' layers, deepseek-67b and
# llama3-405b to SERVE_DENSE_LAYERS), against their bf16 forward, to the
# same bound.  Keyed by config name; absent: the served depth.
SERVE_GATE_LAYERS = {"mamba2-2.7b": 8}
SERVE_GATE_FLOAT32 = {"dense": False, "ssm": True, "moe": False,
                      "audio": False, "vlm": False}
# each block, its weights in float32, decoding a step at a time from the
# bf16 forward's residual stream at its input, against its float32
# full-sequence forward from the same inputs: no error crosses a block or
# a step; per row of the block's output, max |a - b| <= rtol * max |b| +
# atol at the float32 tier of the block's kernel (in bf16 the block
# outputs land up to two ulps apart, 1.19% of a row's max on an H100, so
# bf16 rounding, not the decode, would set a bf16 bound)
SERVE_BLOCK_TIERS = {"dense": ops.TOLERANCE_TIERS["flash_attention"],
                     "ssm": ops.TOLERANCE_TIERS["ssd_scan"],
                     "moe": ops.TOLERANCE_TIERS["flash_attention"],
                     "audio": ops.TOLERANCE_TIERS["flash_attention"],
                     "vlm": ops.TOLERANCE_TIERS["flash_attention"]}
# the MoE models served at their published widths, cut: config name ->
# (layers, capacity factor).  llama4-scout's depth 48 cut to 2 layers;
# deepseek-v3's 61 to 4 (its 3 dense MLA layers and the first MoE one,
# 15.1 B params, 30.2 GB in bf16); each at a capacity factor of
# num_experts / top_k (16; 32), so that every expert has a place for every
# token: neither model drops tokens, and a decode must route as its
# forward does (the reference's tests route so where batch mates must not
# matter); the configs keep 1.25
SERVE_MOE_CUTS = {"llama4-scout-17b-a16e": (2, 16.0),
                  "deepseek-v3-671b": (4, 32.0)}
# the dense configs' depth on the card: nemotron-4-15b at its published 32
# layers (15.6 B params); deepseek-67b (95) and llama3-405b (126) at 4
# (4.45 B and 16.95 B: their 67 B and 405 B do not fit one card)
SERVE_DENSE_LAYERS = {"deepseek-67b": 4, "llama3-405b": 4}
# the dense configs' serving run: one replica x 4 slots, 4 requests of
# 1024-token prompts and 16 new tokens, greedy, undisturbed
SERVE_DENSE_RUN = dict(n_requests=4, prompt_len=1024, max_new=16, slots=4,
                       replicas=1, timed=True)
# an MoE block's float32 check casts its experts' weights a group of this
# many experts at a time: deepseek-v3's 256 experts are 45 GB in float32
SERVE_EXPERT_GROUP = 16
# the tiny MLA configuration (tests/test_models_and_perf_paths.py of the
# reference: v head 24 against a qk head of 16 + 16)
SERVE_TINY_MLA = dict(use_mla=True, q_lora_rank=32, kv_lora_rank=32,
                      qk_rope_dim=16, qk_nope_dim=16, v_head_dim=24)
# chunks of the chunked attention path in the tiny twins: a 12-token
# prompt takes 3 query chunks and a padded key chunk
SERVE_TINY_CHUNKS = dict(attn_chunked=True, attn_chunk_q=4, attn_chunk_kv=8)
# the tiny serving twins: name -> (family, overrides); the hybrid pattern
# is 4 layers long
SERVE_TINY_TWINS = {
    "dense": ("dense", dict(num_layers=2)),
    "ssm": ("ssm", dict(num_layers=2)),
    "moe": ("moe", dict(num_layers=2)),
    "hybrid": ("hybrid", dict(num_layers=4)),
    "mla": ("moe", dict(SERVE_TINY_MLA, num_layers=2)),
    "mla absorbed": ("moe", dict(SERVE_TINY_MLA, num_layers=2,
                                 mla_absorb=True)),
    "dense chunked": ("dense", dict(SERVE_TINY_CHUNKS, num_layers=2)),
    "mla chunked": ("moe", dict(SERVE_TINY_MLA, **SERVE_TINY_CHUNKS,
                                num_layers=2)),
    "audio": ("audio", {}),
    "vlm": ("vlm", dict(num_layers=2)),
}


def serve_route(cfg, blk: str):
    """The kernel a prefill of ``cfg`` launches once in a block of type
    ``blk`` (prompts of at least ``ssm_chunk`` tokens); None for MLA and
    the chunked attention path, whose attention is plain tensor code."""
    dt = cfg.torch_dtype
    if blk in (ATTN, ATTN_MOE):
        if cfg.use_mla or cfg.attn_chunked:
            return None
        return "flash_attention_sm90" if uses_sm90(dt, cfg.head_dim) \
            else "flash_attention_bf16_mma" if uses_bf16_mma(dt, cfg.head_dim) \
            else "flash_attention_tf32"
    p, n, c = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    return "ssd_scan_sm90" if ssd_uses_sm90(dt, p, n, c) \
        else "ssd_scan_sm90_f32" if ssd_uses_sm90_f32(dt, p, n, c) \
        else "ssd_scan"


def serve_launches(eng: ServingEngine) -> dict:
    """The launches an engine's run must have made, from its prefills and
    batched decode steps: each prefill one flash or SSD launch a block
    (by its mixer; none in an MLA block or on the chunked path), each
    prefill and batched decode step one rmsnorm a block (ln1), one more a
    Mamba2 block (its gated out_norm), one more a block with an MLP or MoE
    MLP (ln2), two more an MLA block (kv_norm, and q_norm with a q_lora
    rank), and the final norm: 2L+1 for codeqwen (ln1, ln2), mamba2 (ln1,
    out_norm) and llama4-scout (ln1, ln2), 4L+1 for deepseek-v3.  An
    enc-dec prefill also encodes its request's frames (2 norms and a
    flash launch a block, ``enc_norm``), and each of its decoder blocks has a third norm (lnx) and a plain
    cross-attention (``serve_run`` keeps every prefix shorter than the
    frames)."""
    cfg = eng.cfg
    prefills = sum(r.prefills for r in eng.requests.values())
    want = {k: 0 for k in _build.LAUNCHES}
    if cfg.is_encdec:
        n_enc = cfg.encoder_layers or cfg.num_layers
        n_dec = cfg.decoder_layers or cfg.num_layers
        want["rmsnorm"] = prefills * (2 * n_enc + 1) \
            + (prefills + eng.decode_calls) * (3 * n_dec + 1)
        want[serve_route(cfg, ATTN)] = prefills * (n_enc + n_dec)
        return want
    types = R.flat_layer_types(cfg)
    mla = (1 + bool(cfg.q_lora_rank)) if cfg.use_mla else 0
    norms = 1 + sum(1 + (t in (MAMBA, MAMBA_MOE))
                    + (t in (ATTN_MOE, MAMBA_MOE) or cfg.d_ff > 0)
                    + (t in (ATTN, ATTN_MOE)) * mla
                    for t in types)
    want["rmsnorm"] = norms * (prefills + eng.decode_calls)
    for t in types:
        route = serve_route(cfg, t)
        if route is not None:
            want[route] += prefills
    return want


def batch_free_routing(cfg) -> bool:
    """True when a token's route cannot depend on its batch mates: no MoE
    block, or every expert has a place for every routed token."""
    return not cfg.num_experts \
        or cfg.capacity_factor * cfg.top_k >= cfg.num_experts


@contextlib.contextmanager
def watching_routes(on_route):
    """While open, ``on_route(logits, routing)`` sees every MoE routing:
    its float32 router logits [G, n, E] and ``moe.route``'s result."""
    orig = moe.route

    def watched(cfg, logits, *a, **k):
        r = orig(cfg, logits, *a, **k)
        on_route(logits, r)
        return r
    moe.route = watched
    try:
        yield
    finally:
        moe.route = orig


def serve_run(cfg, params, sampler, device, *, event=None, policy=None,
              n_requests=3, prompt_len=12, max_new=6, late=(), late_at=0.0,
              slots=3, replicas=2, timed=False, routes=None) -> dict:
    """One engine run on ``replicas`` replicas of ``slots`` slots:
    ``n_requests`` seeded prompts (those in ``late``
    arrive at ``late_at`` simulated seconds; an enc-dec config's each with
    ``cfg.max_source_positions`` seeded frames, its whole window, drawn
    apart from the prompts), three ticks, then ``event``
    (an ``EventKind``, on replica 0) if given, then drain.  Returns the
    engine, its streams, the logits each sampling step read keyed by (rid,
    position), the event's stats, its launches and, with ``timed``, the
    wall times of each encode, prefill and decode call and of the event.
    A dict
    ``routes`` receives, by (rid, position), the router logits [MoE
    layers, E] of the token whose logits were sampled there and the
    experts its dispatch used [MoE layers, top_k]."""
    eng = ServingEngine(cfg, n_replicas=replicas, slots_per_replica=slots,
                        max_len=prompt_len + max_new + 1, mode="numeric",
                        params=params, sampler=sampler, policy=policy,
                        slo=SLO(ttft=1e9, per_token=1e9), device=device)
    logits, pending = {}, []
    if cfg.is_encdec:
        check(prompt_len + max_new < cfg.max_source_positions,
              f"{cfg.name}: a prefix as long as the frames would take the "
              f"flash kernel in its cross-attention")

    def hook(rids, positions, rows):
        for j, (rid, pos, row) in enumerate(zip(rids, positions, rows)):
            logits[(rid, pos)] = row.copy()
            if routes is not None:
                # a decode step routes the sampled rows in order; a prefill
                # samples from its prompt's last token
                at = j if pending[0][0].shape[1] == len(rids) else -1
                routes[(rid, pos)] = tuple(
                    torch.stack([t[0, at] for t in ts]).cpu()
                    for ts in zip(*pending))
        pending.clear()

    eng.logit_hook = hook
    times = {"encode": [], "prefill": [], "decode": []}
    if timed:
        h = eng.hooks

        def clocked(kind, fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
                return res
            return call

        eng.hooks = ServingHooks(h.init_caches, clocked("prefill", h.prefill),
                                 clocked("decode", h.decode_step),
                                 clocked("encode", h.prepare_extras))
    rng, frames_rng = np.random.default_rng(0), np.random.default_rng(1)
    for rid in range(n_requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=prompt_len).astype(np.int32)
        frames = frames_rng.standard_normal(
            (cfg.max_source_positions, cfg.d_model)).astype(np.float32) \
            if cfg.is_encdec else None
        eng.submit(Request(rid=rid, arrival=late_at if rid in late else 0.0,
                           prompt=prompt, max_new_tokens=max_new,
                           encoder_frames=frames))
    if device == "cuda":
        _build.reset_launch_counts()
        torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        if routes is not None:
            stack.enter_context(watching_routes(
                lambda lg, r: pending.append((lg.detach(),
                                              r["gate_idx"].detach()))))
        run = _serve_ticks(eng, event, device)
    launches = dict(_build.LAUNCHES) if device == "cuda" else None
    if launches is not None:
        want = serve_launches(eng)
        check(launches == want, f"serving {cfg.name} launches {launches} "
                                f"!= {want}")
    return dict(engine=eng, logits=logits, launches=launches, times=times,
                streams=[list(eng.requests[r].generated)
                         for r in range(n_requests)], **run)


def _serve_ticks(eng: ServingEngine, event, device) -> dict:
    """Three ticks, ``event`` on replica 0 (every migrated slot, caches
    and extras, checked against its source bitwise), then drain: the
    event's stats, the requests it moved, the bytes of their extras (not
    in ``kv_bytes_moved``, which counts caches only, as the reference
    does), its wall seconds and the run's."""
    t0 = time.perf_counter()
    for _ in range(3):
        eng.tick()
    stats, moved, event_s, extras_bytes = None, [], 0.0, 0
    if event is not None:
        src = eng.replicas[0].pool
        moved = [(int(src.slot_req[s]), src.read(s))
                 for s in src.active_slots()]
        if device == "cuda":
            torch.cuda.synchronize()
        te = time.perf_counter()
        stats = eng.apply_event(ElasticEvent(event, 0, (0,)))
        if device == "cuda":
            torch.cuda.synchronize()
        event_s = time.perf_counter() - te
        if stats["migrated"]:
            for rid, (cache, extras) in moved:
                req = eng.requests[rid]
                got, got_x = eng.replicas[req.replica].pool.read(req.slot)
                check(all(torch.equal(g[k], c[k]) for g, c in zip(got, cache)
                          for k in g)
                      and (extras is None) == (got_x is None)
                      and (extras is None or all(
                          torch.equal(got_x[k], extras[k]) for k in extras)),
                      f"migrated slot of request {rid} differs from its "
                      f"source")
                if extras is not None:
                    extras_bytes += tree_nbytes(extras)
        moved = [rid for rid, _ in moved]
    eng.drain()
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(stats=stats, moved=moved, event_s=event_s,
                extras_bytes_moved=extras_bytes,
                wall=time.perf_counter() - t0)


def _first_divergence(a: list, b: list, base: dict) -> str:
    """Where streams ``a`` and ``b`` first differ, with the top-2 margin of
    the logits the run ``base`` sampled there."""
    for rid, (sa, sb) in enumerate(zip(a, b)):
        for i, (ta, tb) in enumerate(zip(sa, sb)):
            if ta != tb:
                pos = len(base["engine"].requests[rid].prompt) + i
                top = np.sort(base["logits"][(rid, pos)])[-2:]
                return (f"request {rid} token {i}: {ta} vs {tb}, top-2 "
                        f"margin {float(top[1] - top[0]):.3e}")
    return "no divergence"


def phase_serve_twins() -> dict:
    """The tiny dense (float32, head_dim 16: the 3xTF32 flash route), ssm
    (float32, chunk 8: the CUDA-core SSD route; prompts of 12 tokens, so
    every prefill pads a ragged tail), moe (2 layers, the second MoE),
    hybrid (attention, Mamba2 MoE, Mamba2, Mamba2 MoE), MLA (the moe twin
    with ``SERVE_TINY_MLA``'s latent attention), MLA with the absorbed
    decode, and dense and MLA on the chunked attention path
    (``SERVE_TINY_CHUNKS``), the audio family's enc-dec (32 frames a
    request: encoder outputs migrate with the KV, a rebuild re-encodes)
    and the vlm family's (no prefix, as the reference serves it) engines
    on the card beside a CPU twin of the port from the same weights, 2
    replicas x 3
    slots, 3 requests of 6 new tokens, greedy and top-k: undisturbed, a
    SCALE_IN of replica 0 after two decode ticks (migration), a FAIL_STOP
    (rebuild) and the drop policy.  Stats, event logs and summaries equal
    exactly, the streams equal, every logit row within the
    kernel-consistency bounds (rtol 1e-4, atol 1e-5); on the card the
    SCALE_IN streams equal the undisturbed run's where routing cannot
    depend on batch mates (``batch_free_routing``); launches exact.
    Returns launches by path."""
    counts = {}
    for twin, (family, over) in SERVE_TINY_TWINS.items():
        cfg = tiny_config(family, **SERVE_TINY, **over)
        cpu = R.init_model(torch.Generator().manual_seed(0), cfg)
        card = map_params(lambda t: t.to("cuda"), cpu)
        for sname, sampler in SERVE_SAMPLERS.items():
            runs = {}
            for scen, event, policy in (
                    ("undisturbed", None, None),
                    ("scale-in", EventKind.SCALE_IN, None),
                    ("fail-stop", EventKind.FAIL_STOP, None),
                    ("drop", EventKind.SCALE_IN, DropPolicy())):
                name = f"serving twin {twin} {sname} {scen}"
                flips = []
                with route_twin(flips):
                    a = serve_run(cfg, card, sampler, "cuda", event=event,
                                  policy=policy)
                    b = serve_run(cfg, cpu, sampler, "cpu", event=event,
                                  policy=policy)
                log_flips(name, flips)
                ea, eb = a["engine"], b["engine"]
                check(a["stats"] == b["stats"]
                      and ea.event_log == eb.event_log
                      and json.dumps(ea.summary(), sort_keys=True)
                      == json.dumps(eb.summary(), sort_keys=True),
                      f"{name}: stats, event log or summary differ")
                if a["streams"] != b["streams"]:
                    check(False, f"{name}: streams differ: "
                          + _first_divergence(a["streams"], b["streams"], b))
                check(a["logits"].keys() == b["logits"].keys(),
                      f"{name}: different sampling steps")
                worst = max(float(np.abs(a["logits"][k] - b["logits"][k])
                                  .max()) for k in a["logits"])
                check(all(np.allclose(a["logits"][k], b["logits"][k],
                                      rtol=KCC.PARAM_RTOL,
                                      atol=KCC.PARAM_ATOL0)
                          for k in a["logits"]),
                      f"{name}: logits beyond the kernel-consistency bounds")
                s = a["stats"] or {}
                log(f"{name}: card = cpu (streams, stats, event log, "
                    f"summary); logits max_abs_diff {worst:.3e} over "
                    f"{len(a['logits'])} rows; migrated "
                    f"{s.get('migrated', 0)} rebuilt {s.get('rebuilt', 0)} "
                    f"dropped {s.get('dropped', 0)} kv_bytes_moved "
                    f"{s.get('kv_bytes_moved', 0)}; launches "
                    f"{ {k: v for k, v in a['launches'].items() if v} }")
                runs[scen] = a
                counts[name] = a["launches"]
            check(runs["scale-in"]["stats"]["migrated"] > 0
                  and runs["scale-in"]["stats"]["dropped"] == 0
                  and runs["drop"]["stats"]["dropped"] > 0
                  and runs["fail-stop"]["stats"]["rebuilt"] > 0,
                  f"serving twin {twin} {sname}: dispositions")
            # at the tiny moe configs' capacity factor 1.25 a decode step's
            # places depend on how many slots are live, so migration may
            # change what drops (the reference's semantics too)
            same = runs["scale-in"]["streams"] \
                == runs["undisturbed"]["streams"]
            if batch_free_routing(cfg):
                check(same, f"serving twin {twin} {sname}: SCALE_IN "
                            f"streams differ from the undisturbed run's")
            else:
                log(f"serving twin {twin} {sname}: capacity-limited "
                    f"routing; SCALE_IN streams equal the undisturbed "
                    f"run's: {same}")
            log(f"serving twin {twin} {sname}: fail-stop rebuild streams "
                f"equal the undisturbed run's: "
                f"{runs['fail-stop']['streams'] == runs['undisturbed']['streams']}")
    return counts


def float32_params(tree):
    """A copy of a parameter tree (dicts, lists, tuples of tensors) in
    float32."""
    return map_params(torch.Tensor.float, tree)


def logits_vs_forward(params, cfg, run: dict, float32_ref: bool = False,
                      routes: dict = None) -> dict:
    """Every logits row the run's engine sampled from, against a
    full-sequence forward of the same tokens, per row within
    ``SERVE_LOGIT_RTOL`` of the row's max |logit| (held).  ``float32_ref``:
    the rows are held against the float32 forward of the same weights instead,
    each allowed, on top of the bound, the bf16 forward's own max |error|
    in that row.  ``routes`` (an MoE model: the engine's router logits by
    and dispatched experts by (rid, position), ``serve_run``): each
    position's dispatched experts, layer by layer, against the forward's
    own.  Where they differ the route flipped on a near-tie of the
    router's float32 input (the reference's semantics): that position's
    router logits are held within the same bound of the forward's, at each
    such layer the forward's gap between the swapped experts within twice
    the router logits' difference (``route_agreement``; else the decode
    dispatched to experts its logits did not pick), and its output
    logits, another expert's
    function rather than a rounding of the same one, are printed, not
    held.  Returns the worst held error (beyond any allowance) as a share
    of the row's max |logit|, and the flips."""
    rtol, atol = serve_logit_rtol(cfg), SERVE_BF16["atol"]
    worst, agree, rows, own = 0.0, 0, 0, 0.0
    flips = []
    ref_args = (float32_params(params),
                dataclasses.replace(cfg, dtype="float32")) \
        if float32_ref else None
    for rid, req in sorted(run["engine"].requests.items()):
        seq = [int(t) for t in req.prompt] + req.generated[:-1]
        fwd_routes = []
        with contextlib.ExitStack() as stack:
            if routes is not None:
                stack.enter_context(watching_routes(
                    lambda lg, r: fwd_routes.append(
                        (lg[0].float().cpu(), r["gate_idx"][0].cpu()))))
            full = full_forward_logits(params, cfg, seq, req.encoder_frames) \
                .float().cpu().numpy()
        ref32 = full_forward_logits(*ref_args, seq, req.encoder_frames) \
            .cpu().numpy() if float32_ref else None
        for pos in range(len(req.prompt), len(seq) + 1):
            got, want = run["logits"][(rid, pos)], full[pos - 1]
            slack = 0.0
            if float32_ref:
                want = ref32[pos - 1]
                slack = float(np.abs(full[pos - 1] - want).max())
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            where = f"{cfg.name} serving: request {rid} position {pos}"
            route = None
            if routes is not None:
                route = route_agreement(
                    *routes[(rid, pos)],
                    *(torch.stack([f[pos - 1] for f in ts])
                      for ts in zip(*fwd_routes)))
            if route is not None and route["layers"]:
                flips.append(dict(rid=rid, pos=pos, logits_rel_err=err / scale,
                                  **route))
                log(f"{where}: route flipped at layers {route['layers']} "
                    f"(engine experts {route['engine']}, forward "
                    f"{route['forward']}; the forward router's margin at "
                    f"the top-k boundary {route['margin']}; the forward's "
                    f"gap between the swapped experts against 2 x max "
                    f"|router logit difference| at those layers: "
                    + ", ".join(f"{w['gap']:.4e} <= {2 * w['delta']:.4e}"
                                for w in route["swap"])
                    + f"); at the first, router logits within "
                    f"{route['router_rel_diff']:.4e} of max |router logit|;"
                    f" output logits {err / scale:.4e} of max |logit| "
                    f"(printed, not held)")
                for layer, w in zip(route["layers"], route["swap"]):
                    check(w["gap"] <= 2 * w["delta"]
                          + ROUTE_SWAP_SLACK * w["scale"],
                          f"{where}: at layer {layer} the forward ranks the "
                          f"experts only it took {w['gap']:.4e} above those "
                          f"only the engine took, more than 2 x the router "
                          f"logits' difference {w['delta']:.4e}: the "
                          f"engine's dispatch did not route by its logits")
                check(route["router_rel_diff"] <= rtol,
                      f"{where}: router logits {route['router_rel_diff']:.4e}"
                      f" of max |router logit| off the forward's at layer "
                      f"{route['layers'][0]}, beyond {rtol:.3e}: not a "
                      f"near-tie")
                continue
            worst = max(worst, (err - slack) / scale)
            own = max(own, slack / scale)
            agree += int(np.argmax(got) == np.argmax(want))
            rows += 1
            check(err <= slack + rtol * scale + atol,
                  f"{where}: logits max_abs_err {err:.4e} beyond {slack:.4e} "
                  f"+ {rtol:.3e} x max |logit| {scale:.3f}"
                  + ("" if route is None else
                     f"; engine and forward chose the same experts, the "
                     f"forward router's margin at the top-k boundary "
                     f"{route['margin']}"))
        del full, ref32
    what = ("the float32 forward, beyond the bf16 forward's own error "
            f"(at most {own:.4e} of max |logit|)" if float32_ref
            else "the full-sequence forward")
    log(f"{cfg.name} serving ({cfg.num_layers} layers): engine logits vs "
        f"{what} over {rows} rows: max err / max |logit| {worst:.4e} "
        f"(bound {rtol:.4e}, held), argmax agreement {agree}/{rows}"
        + ("" if routes is None else
           f"; routes equal the forward's at {rows} positions, flipped on a "
           f"near-tie at {len(flips)}"))
    return dict(max_rel_err=worst, bound=rtol, layers=cfg.num_layers,
                float32_ref=float32_ref,
                forward_max_rel_err=own if float32_ref else None,
                argmax_agreement=agree / rows, rows=rows,
                **({} if routes is None else {"route_flips": flips}))


def route_agreement(eng: torch.Tensor, eng_experts: torch.Tensor,
                    fwd: torch.Tensor, fwd_experts: torch.Tensor) -> dict:
    """Router logits [MoE layers, E] of one token in the engine and in the
    forward, and the experts [MoE layers, k] each one's dispatch used: the
    layers whose experts differ, both sides' experts there, the forward's
    margin between its k-th and (k+1)-th logit at every layer, and, at
    each layer whose experts differ, ``swap``: the forward's largest logit
    of an expert only it took less its smallest logit of an expert only
    the engine took (``gap``) beside the largest |difference| of the two
    sides' router logits there (``delta``).  A route flipped by the
    difference alone has ``gap <= 2 * delta``: the engine ranked each
    expert it took no lower than each it left.  ``router_rel_diff``: at
    the first layer whose experts differ (every later layer's input
    follows from the other expert's output), the largest |difference| as
    a share of the forward's largest |logit|."""
    k = fwd_experts.shape[-1]
    e_eng = eng_experts.sort(dim=-1).values
    e_fwd = fwd_experts.sort(dim=-1).values
    layers = [i for i in range(len(eng)) if not torch.equal(e_eng[i],
                                                            e_fwd[i])]
    top = fwd.topk(k + 1).values
    swap = []
    for i in layers:
        only_fwd = sorted(set(e_fwd[i].tolist()) - set(e_eng[i].tolist()))
        only_eng = sorted(set(e_eng[i].tolist()) - set(e_fwd[i].tolist()))
        swap.append(dict(
            gap=float(fwd[i, only_fwd].max() - fwd[i, only_eng].min()),
            delta=float((eng[i] - fwd[i]).abs().max()),
            scale=float(fwd[i].abs().max())))
    first = layers[0] if layers else 0
    return dict(layers=layers, engine=[e_eng[i].tolist() for i in layers],
                forward=[e_fwd[i].tolist() for i in layers],
                margin=[round(float(m), 6) for m in top[:, k - 1] - top[:, k]],
                swap=swap,
                router_rel_diff=float((eng[first] - fwd[first]).abs().max()
                                      / fwd[first].abs().max()))


# a route flip's gap may exceed twice the router logits' difference by the
# float32 softmax's rounding, which the top-k reads: this share of the
# layer's largest |router logit|
ROUTE_SWAP_SLACK = 2.0 ** -20


EXPERT_LEAVES = ("wg", "wu", "wo")


def float32_block(p: dict) -> dict:
    """A block's weights in float32, but an MoE block's expert weights as
    they are: ``float32_expert_groups`` casts them a group at a time where
    they are used (the cast is exact, so the products are the float32
    block's)."""
    out = float32_params({k: v for k, v in p.items() if k != "moe"})
    if "moe" in p:
        out["moe"] = {k: v if k in EXPERT_LEAVES else float32_params(v)
                      for k, v in p["moe"].items()}
    return out


@contextlib.contextmanager
def float32_expert_groups():
    """While open, an MoE layer's expert products run ``SERVE_EXPERT_GROUP``
    experts at a time, each group's weights cast to the buckets' dtype
    (float32) there: the float32 copy of deepseek-v3's 256 experts (45 GB)
    would not fit beside the bf16 model."""
    orig = moe._experts

    def grouped(params, cfg, buckets):
        out = torch.empty_like(buckets)
        for e in range(0, cfg.num_experts, SERVE_EXPERT_GROUP):
            sl = slice(e, e + SERVE_EXPERT_GROUP)
            out[sl] = orig({k: params[k][sl].to(buckets.dtype)
                            for k in EXPERT_LEAVES}, cfg, buckets[sl])
        return out
    moe._experts = grouped
    try:
        yield
    finally:
        moe._experts = orig


def _blocks(params, cfg, tokens, frames=None, prefix=None):
    """The residual stream entering the first decoder block (the token
    embeddings, after ``prefix`` [1, P, d] when given) and, per block,
    (label, weights, ``apply(p, cfg, x, pos, cache, cache_index)`` -> its
    output, ``new_cache(cfg, n)`` -> its zero one-row cache).  An enc-dec
    config's blocks cross-attend to the encoder output of ``frames``
    [T, d] (the bf16 forward's, in the input's dtype)."""
    t = torch.as_tensor(np.asarray(tokens, np.int64)[None], device="cuda")
    if cfg.is_encdec:
        enc = E.encode(params, cfg, torch.as_tensor(frames,
                                                    device="cuda")[None])
        x = R.apply_stem(params, cfg, t)

        def apply(p, c, x, pos, cache, idx):
            return E.apply_decoder_block(p, c, x, pos, enc.to(x.dtype),
                                         cache, idx)

        def new_cache(c, n):
            return E.init_decoder_caches(c, 1, n, device="cuda")[0]
        return x, [(f"decoder {i}", p, apply, new_cache)
                   for i, p in enumerate(params["decoder"])]
    stem, layers, _ = params
    x = R.apply_stem(stem, cfg, t)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    ctx, out = RngCtx(), []
    for i, (blk, p) in enumerate(zip(R.flat_layer_types(cfg), layers)):
        def apply(p, c, x, pos, cache, idx, blk=blk, i=i):
            return T.apply_block(p, c, blk, x, pos, ctx, i, cache=cache,
                                 cache_index=idx)[0]

        def new_cache(c, n, blk=blk):
            return T.init_block_cache(c, blk, 1, n, device="cuda")
        out.append((f"{i} ({blk})", p, apply, new_cache))
    return x, out


def blocks_vs_forward(params, cfg, tokens: list, n_prompt: int,
                      frames=None, prefix=None) -> float:
    """``tokens`` (after ``prefix`` [1, P, d] when given; with ``frames``
    [T, d], an enc-dec config's) through the model once, the residual
    stream kept at each decoder block's input; then each block, its
    weights in float32 (``float32_block``, an MoE block's experts cast a
    group at a time), runs its full-sequence forward on that input and, on
    the same input, prefills the first ``n_prompt`` rows and decodes the
    rest a step at a time, each step's output within
    ``SERVE_BLOCK_TIERS`` of the float32 forward's row (held).  No error
    crosses a block or a step here.  Returns the largest error as a share
    of its row's max |output|."""
    x, blocks = _blocks(params, cfg, tokens, frames, prefix)
    P, S = n_prompt, x.shape[1]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tier = SERVE_BLOCK_TIERS[cfg.family]
    pos = torch.arange(S, device="cuda")[None]
    worst = 0.0
    for name, p, apply, new_cache in blocks:
        p32, x32 = float32_block(p), x.float()
        with float32_expert_groups():
            y = apply(p32, cfg32, x32, pos, new_cache(cfg32, S), 0)
            cache = new_cache(cfg32, S + 1)
            apply(p32, cfg32, x32[:, :P], pos[:, :P], cache, 0)
            steps = [apply(p32, cfg32, x32[:, t:t + 1], pos[:, t:t + 1],
                           cache, torch.tensor([t], device="cuda"))
                     for t in range(P, S)]
        for t, got in zip(range(P, S), steps):
            err = float((got[0, 0] - y[0, t]).abs().max())
            scale = float(y[0, t].abs().max())
            worst = max(worst, err / scale)
            check(err <= tier["rtol"] * scale + tier["atol"],
                  f"{cfg.name} serving: block {name} (float32) decode at "
                  f"position {t}: max_abs_err {err:.4e} beyond "
                  f"{tier['rtol']:g} x max |output| {scale:.3f}")
        del p32, x32, cache, y, steps
        x = apply(p, cfg, x, pos, new_cache(cfg, S), 0)
    log(f"{cfg.name} serving: each of the {len(blocks)} decoder blocks in "
        f"float32 decoding {S - P} positions from the forward's inputs: max "
        f"err / max |output| {worst:.4e} (bound {tier['rtol']:g}, held)")
    return worst


# phase 11's resumed-prefill gate: a prompt of RESUMED_PROMPT tokens
# prefilled whole, and as two parts, the second resumed at RESUMED_SPLIT
# from the first's carried state (chunk 256: the first part's tail and the
# second's padded with dt = 0 rows)
RESUMED_PROMPT, RESUMED_SPLIT = 1024, 600


def resumed_prefill_gate(params, cfg) -> tuple:
    """``cfg`` (mamba2-2.7b's widths at the logits gate's depth), its
    weights in float32 as that gate takes them: one seeded prompt prefilled
    whole (``transformer.prefill``: the SSD kernel with its final state)
    and prefilled as two parts, the second resumed from the carried state
    (``transformer.forward(..., cache_index=RESUMED_SPLIT)``: the plain
    chunked scan from ``initial_state``).  The last logits and each
    layer's final SSM and conv states within the float32 block bound
    (``SERVE_BLOCK_TIERS``, 1e-4 of the tensor's max |value|, held);
    launches exact: 2L + 1 rmsnorms a pass, the SSD route's L launches in
    each prefill from index 0 and none in the resumed part.  Returns the
    launch counts and the record."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = float32_params(params)
    tier = SERVE_BLOCK_TIERS[cfg.family]
    k, n = RESUMED_SPLIT, RESUMED_PROMPT
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, n)), device="cuda")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        whole = T.init_caches(cfg32, 1, n, device="cuda")
        lw, whole = T.prefill(p32, cfg32, tokens, whole)
        parts = T.init_caches(cfg32, 1, n, device="cuda")
        T.prefill(p32, cfg32, tokens[:, :k], parts)
        lr, parts, _ = T.forward(p32, cfg32, tokens[:, k:], caches=parts,
                                 cache_index=k, last_only=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    L_ = cfg.num_layers
    want = {key: 0 for key in launches}
    want["rmsnorm"] = 3 * (2 * L_ + 1)
    want[serve_route(cfg32, MAMBA)] = 2 * L_
    name = f"{cfg.name} resumed prefill ({L_} layers, float32, {n} tokens " \
        f"as {k} + {n - k})"
    check(launches == want, f"{name}: launches {launches} != {want}")

    def rel(a, b, what):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        check(err <= tier["rtol"] * scale + tier["atol"],
              f"{name}: {what} max_abs_err {err:.4e} beyond "
              f"{tier['rtol']:g} x max |value| {scale:.4e}")
        return err / scale
    worst = {"logits": rel(lr, lw, "last logits"), "ssm": 0.0, "conv": 0.0}
    for i, (a, b) in enumerate(zip(parts, whole)):
        for key in ("ssm", "conv"):
            worst[key] = max(worst[key], rel(a[key], b[key],
                                             f"layer {i} {key} state"))
    log(f"{name}: against the whole prefill, max err / max |value|: last "
        f"logits {worst['logits']:.4e}, SSM states {worst['ssm']:.4e}, conv "
        f"states {worst['conv']:.4e} (bound {tier['rtol']:g}, held); "
        f"{wall:.2f} s; launches {({x: v for x, v in launches.items() if v})}")
    del p32, whole, parts
    return launches, dict(max_rel_err=worst, bound=tier["rtol"],
                          layers=L_, split=[k, n - k], wall_s=wall)


def full_forward_logits(params, cfg, tokens: list, frames=None,
                        prefix=None) -> torch.Tensor:
    """Logits [S, V] of every position of ``tokens`` in one full-sequence
    pass (the prefill path over the whole sequence: flash attention or the
    SSD scan over all positions, the caches written and discarded); an
    enc-dec config's decoder over the encoder output of ``frames`` [T, d];
    with ``prefix`` [1, P, d], the rows [P + S, V] of the prefix too."""
    t = torch.as_tensor(np.asarray(tokens, np.int64)[None], device="cuda")
    if cfg.is_encdec:
        enc = E.encode(params, cfg, torch.as_tensor(frames,
                                                    device="cuda")[None])
        caches = E.init_decoder_caches(cfg, 1, len(tokens), device="cuda")
        return E.decode(params, cfg, t, enc, caches=caches,
                        cache_index=0)[0][0]
    n = len(tokens) + (0 if prefix is None else prefix.shape[1])
    caches = T.init_caches(cfg, 1, n, device="cuda")
    return T.forward(params, cfg, t, caches=caches, cache_index=0,
                     prefix_embeds=prefix)[0][0]


# the full-width serving runs: (sampler name, sampler, scenario, event)
SERVE_FULL_RUNS = (("greedy", SamplerConfig(), "undisturbed", None),
                   ("greedy", SamplerConfig(), "scale-in", EventKind.SCALE_IN),
                   ("top-k", SERVE_FULL_TOPK, "scale-in", EventKind.SCALE_IN))
# by default 2 replicas x 4 slots, 8 requests of 1024-token prompts and 64
# new tokens: requests 0-3 arrive at 0, 4-7 at 4.0 simulated seconds
# (after the event)
SERVE_FULL_RUN = dict(n_requests=8, prompt_len=1024, max_new=64,
                      late=range(4, 8), late_at=4.0, slots=4, timed=True)
# whisper-base's serving run: the same fleet and arrivals, 128-token
# prompts (its decoder was trained on 448 positions), each request with its
# 1500 frames, a 30 s window
SERVE_ENCDEC_RUN = dict(SERVE_FULL_RUN, prompt_len=128)
# configs served at fewer layers than their weights are drawn at and their
# blocks held at: mamba2-2.7b's three runs at 16 of its 64 layers (all
# three at one depth, so that their streams compare), its logits gate at
# SERVE_GATE_LAYERS' 8, its float32 block check at all 64
SERVE_SERVED_LAYERS = {"mamba2-2.7b": 16}
# whisper-base's training step: batch 2 of 448 tokens (its decoder's
# positions), 1500 frames a sample; the bf16 loss within BF16_LOSS_RTOL
# (one bf16 spacing, the bf16 twins' loss bound) of the float32 loss of
# the same weights
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_TOKENS = 2, 448
# internvl2-76b at its published widths cut to 4 of its 80 layers
# (5,523,963,904 params, 11.0 GB in bf16; a time cut, not a fit cut: each
# further layer adds ~1.7 GB): batch 1, its 256 prefix embeddings and
# 1024 tokens, a prefill and 15 greedy decode steps
VLM_LAYERS, VLM_PROMPT, VLM_NEW = 4, 1024, 16
# the vlm train step's loss against the forward's cross-entropy past the
# prefix: the same logits in the same float32 reduction
VLM_LOSS_RTOL = 1e-6


def phase_serve_full(cfg, plan=SERVE_FULL_RUNS, **kw) -> tuple:
    """``cfg`` at its published widths (its depth cut where
    ``SERVE_MOE_CUTS`` or ``SERVE_DENSE_LAYERS`` say, served at
    ``SERVE_SERVED_LAYERS``' depth where it says), bf16, random weights
    from seed 0 on the card, serving ``plan`` with ``serve_run``'s keywords
    ``kw`` (default ``SERVE_FULL_RUN``): greedy undisturbed (its logits
    against a full-sequence forward: see ``SERVE_GATE_LAYERS``), and by
    default greedy with a SCALE_IN of replica 0 after two decode ticks
    (every in-flight request migrates, zero drops, the slots, caches and
    an enc-dec config's encoder outputs, equal their source bitwise, the
    streams the undisturbed run's) and a top-k run (temperature 0.7,
    top_k 40) with the same SCALE_IN.  Where ``SERVE_GATE_LAYERS`` cuts the
    depth, the greedy undisturbed run again on the first layers, for gate
    1; every block of the drawn depth in float32.  An enc-dec config also
    takes ``encdec_train_step``.  Launches exact.  Returns (launches by
    run, record)."""
    kw = kw or SERVE_FULL_RUN
    name = cfg.name
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves_with_paths(params))
    served = SERVE_SERVED_LAYERS.get(name, cfg.num_layers)
    scfg, sparams = (cfg, params) if served == cfg.num_layers else (
        dataclasses.replace(cfg, num_layers=served),
        (params[0], params[1][:served], params[2]))
    log(f"{name} serving: {cfg.num_layers} layers, {n_params:,} params "
        f"({str(cfg.torch_dtype)[6:]}), drawn in "
        f"{time.perf_counter() - t0:.1f} s"
        + (f"; served at {served} layers" if scfg is not cfg else ""))
    runs, counts = {}, {}
    # an MoE model's base run keeps each sampled token's router logits
    routes = {} if cfg.num_experts else None
    for sname, sampler, scen, event in plan:
        r = serve_run(scfg, sparams, sampler, "cuda", event=event,
                      routes=routes if event is None else None, **kw)
        runs[(sname, scen)] = r
        counts[f"{name} serving {sname} {scen}"] = r["launches"]
        toks = sum(len(s) for s in r["streams"])
        t = r["times"]
        s = r["stats"] or {}
        log(f"{name} serving {sname} {scen}: {toks} tokens in "
            f"{r['wall']:.2f} s ({toks / r['wall']:.1f} tokens/s); "
            + (f"encode {1e3 * np.mean(t['encode']):.2f} ms a request, "
               if cfg.is_encdec else "")
            + f"prefill {1e3 * np.mean(t['prefill']):.2f} ms a request "
            f"({len(t['prefill'])}), decode "
            f"{1e3 * np.mean(t['decode']):.2f} ms a batched step "
            f"({len(t['decode'])}, {r['engine'].ticks} ticks); "
            + (f"migrated {s['migrated']} dropped {s['dropped']} rebuilt "
               f"{s['rebuilt']}, {s['kv_bytes_moved']:,} KV bytes"
               + (f" and {r['extras_bytes_moved']:,} bytes of encoder "
                  f"outputs" if cfg.is_encdec else "")
               + f" in {r['event_s']:.4f} s wall; " if event else "")
            + f"launches {({k: v for k, v in r['launches'].items() if v})}")
        if event is not None:
            check(s["migrated"] == len(r["moved"]) > 0
                  and s["dropped"] == 0 and s["rebuilt"] == 0,
                  f"{name} serving {sname}: SCALE_IN dispositions {s}")
            base = runs.get((sname, "undisturbed"))
            if base is not None and r["streams"] != base["streams"]:
                check(False, f"{name} serving {sname}: SCALE_IN streams "
                             f"differ: " + _first_divergence(
                                 r["streams"], base["streams"], base))
    # gate 1: the engine's bf16 logits against a full-sequence forward of
    # the same tokens at SERVE_GATE_LAYERS' depth, and every block's decode
    # against its forward from the same inputs in float32 (both held)
    base = runs[("greedy", "undisturbed")]
    depth = SERVE_GATE_LAYERS.get(name, served)
    float32_ref = SERVE_GATE_FLOAT32[cfg.family]
    if depth == served:
        gate = logits_vs_forward(sparams, scfg, base, float32_ref, routes)
    else:
        cut = dataclasses.replace(cfg, num_layers=depth)
        cut_params = (params[0], params[1][:depth], params[2])
        r = serve_run(cut, cut_params, SamplerConfig(), "cuda",
                      **{**kw, "timed": False})
        counts[f"{name} serving greedy undisturbed, {depth} layers"] = \
            r["launches"]
        gate = logits_vs_forward(cut_params, cut, r, float32_ref)
        del r
        if cfg.family == "ssm":
            c, gate["resumed_prefill"] = resumed_prefill_gate(cut_params,
                                                              cut)
            counts[f"{name} resumed prefill, {depth} layers, float32"] = c
    req = base["engine"].requests[0]
    gate["block_max_rel_err"] = blocks_vs_forward(
        params, cfg, [int(t) for t in req.prompt] + req.generated[:-1],
        len(req.prompt), req.encoder_frames)
    train = None
    if cfg.is_encdec:
        c, train = encdec_train_step(params, cfg)
        counts.update(c)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{name} serving: peak device memory {peak:.2f} GB")
    mig = runs.get(("greedy", "scale-in"))
    rec = dict(params=n_params, layers=cfg.num_layers, served_layers=served,
               logits=gate, peak_gb=peak, train=train,
               kv_bytes_moved=mig and mig["stats"]["kv_bytes_moved"],
               extras_bytes_moved=mig and mig["extras_bytes_moved"],
               migration_s=mig and mig["event_s"],
               runs={f"{k[0]} {k[1]}": dict(
                   wall_s=r["wall"],
                   tokens=sum(len(s) for s in r["streams"]),
                   encode_ms=1e3 * float(np.mean(r["times"]["encode"]))
                   if cfg.is_encdec else None,
                   prefill_ms=1e3 * float(np.mean(r["times"]["prefill"])),
                   decode_ms=1e3 * float(np.mean(r["times"]["decode"])),
                   decode_steps=len(r["times"]["decode"]),
                   ticks=r["engine"].ticks) for k, r in runs.items()})
    del runs, base, mig, params, sparams
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rec


def encdec_train_step(params, cfg) -> tuple:
    """``make_train_loss`` of the enc-dec ``cfg`` (bf16) forward and
    backward at ``ENCDEC_TRAIN_BATCH`` x ``ENCDEC_TRAIN_TOKENS`` tokens,
    ``cfg.max_source_positions`` seeded frames a sample: every gradient
    leaf, the encoder's and ``enc_pos`` included, finite and nonzero
    (held), and the loss within ``BF16_LOSS_RTOL`` of the float32 loss of
    the same weights (held); launches exact (``forward_launches``: the
    bf16 forward on the wgmma flash route, the float32 one on the 3xTF32
    route; no backward launches).  Returns (launches by run, record)."""
    B, S, n_frames = ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_TOKENS, \
        cfg.max_source_positions
    rng = np.random.default_rng(2)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, S)),
                          device="cuda")
    batch = dict(frames=torch.as_tensor(rng.standard_normal(
        (B, n_frames, cfg.d_model)).astype(np.float32), device="cuda"),
        tokens=tok, labels=tok)
    loss, grads, launches, step_s = loss_backward(
        params, R.make_train_loss(cfg), batch)
    counts = {f"{cfg.name} train loss (bf16, forward and backward)":
              launches}
    finite, n_leaves = grads_ok(grads), len(grads)
    del grads
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = float32_params(params)
    _build.reset_launch_counts()
    with torch.no_grad():
        loss32 = float(R.make_train_loss(cfg32)(p32, batch))
    counts[f"{cfg.name} train loss (float32 weights, forward)"] = \
        dict(_build.LAUNCHES)
    del p32
    name = f"{cfg.name} train loss (batch {B} x {S} tokens, {n_frames} frames)"
    check(finite, f"{name}: a gradient leaf is not finite or all zero")
    check(math.isfinite(loss) and abs(loss - loss32) <= BF16_LOSS_RTOL
          * abs(loss32), f"{name}: bf16 loss {loss!r} vs float32 {loss32!r}")
    for (what, got), c in zip(counts.items(), (cfg, cfg32)):
        want = forward_launches(c, n_frames, S)
        check(got == want, f"{what}: launches {got} != {want}")
    log(f"{name}: bf16 {loss:.6f} vs float32 {loss32:.6f} (rel "
        f"{abs(loss - loss32) / abs(loss32):.3e}, bound {BF16_LOSS_RTOL:.3e},"
        f" held); forward and backward {step_s:.3f} s; {n_leaves} "
        f"gradient leaves finite and nonzero")
    return counts, dict(loss=loss, loss_float32=loss32, step_s=step_s,
                        leaves=n_leaves)


def phase_vlm_prefix(cfg) -> tuple:
    """The vlm ``cfg`` at its published widths cut to ``VLM_LAYERS``, bf16,
    random weights from seed 0, its ``frontend_embeds`` seeded prefix
    embeddings before ``VLM_PROMPT`` seeded tokens: ``prefill`` with the
    prefix into a cache, then greedy decode steps to ``VLM_NEW`` tokens;
    each sampled logits row against the full forward with the prefix
    within ``SERVE_LOGIT_RTOL`` (held), every block's decode in float32
    (``blocks_vs_forward``, held), launches exact; then one ``train_loss``
    with the prefix, forward and backward: a finite loss within
    ``VLM_LOSS_RTOL`` of the forward's cross-entropy past the prefix,
    every gradient leaf finite and nonzero (held).  Returns (launches by
    run, record)."""
    cfg = dataclasses.replace(cfg, num_layers=VLM_LAYERS)
    name, P, L = cfg.name, cfg.frontend_embeds, cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = R.init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = sum(t.numel() for _, t in leaves_with_paths(params))
    prefix = torch.randn(1, P, cfg.d_model, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1)).to(cfg.torch_dtype)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=VLM_PROMPT)
    tokens = torch.as_tensor(prompt[None], device="cuda")
    caches = T.init_caches(cfg, 1, P + VLM_PROMPT + VLM_NEW, device="cuda")
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = T.prefill(params, cfg, tokens, caches,
                               prefix_embeds=prefix)
    rows = [logits[0, -1].float().cpu().numpy()]
    prefill_s = time.perf_counter() - t0
    toks, decode_s = [int(np.argmax(rows[0]))], []
    for j in range(VLM_NEW - 1):
        t0 = time.perf_counter()
        logits, caches = T.decode_step(
            params, cfg, torch.tensor([[toks[-1]]], device="cuda"), caches,
            torch.tensor([P + VLM_PROMPT + j], device="cuda"))
        rows.append(logits[0, -1].float().cpu().numpy())
        decode_s.append(time.perf_counter() - t0)
        toks.append(int(np.argmax(rows[-1])))
    serve = dict(_build.LAUNCHES)
    want = {k: 0 for k in _build.LAUNCHES}
    want["rmsnorm"] = (2 * L + 1) * VLM_NEW
    want[serve_route(cfg, ATTN)] = L
    check(serve == want, f"{name} prefix serving: launches {serve} != {want}")
    seq = [int(t) for t in prompt] + toks[:-1]
    full = full_forward_logits(params, cfg, seq, prefix=prefix).float() \
        .cpu().numpy()
    rtol, atol = SERVE_LOGIT_RTOL, SERVE_BF16["atol"]
    worst, agree = 0.0, 0
    for j, got in enumerate(rows):
        ref_row = full[P + VLM_PROMPT - 1 + j]
        err, scale = float(np.abs(got - ref_row).max()), \
            float(np.abs(ref_row).max())
        worst = max(worst, err / scale)
        agree += int(np.argmax(got) == np.argmax(ref_row))
        check(err <= rtol * scale + atol,
              f"{name} prefix serving: step {j} logits max_abs_err "
              f"{err:.4e} beyond {rtol:.3e} x max |logit| {scale:.3f}")
    del full
    log(f"{name} prefix serving ({L} layers, {n_params:,} params, prefix "
        f"{P} + {VLM_PROMPT} tokens): prefill {1e3 * prefill_s:.2f} ms, "
        f"decode {1e3 * np.mean(decode_s):.2f} ms a step "
        f"({len(decode_s)}); logits vs the full forward with the prefix "
        f"over {len(rows)} rows: max err / max |logit| {worst:.4e} (bound "
        f"{rtol:.4e}, held), argmax agreement {agree}/{len(rows)}; "
        f"launches { {k: v for k, v in serve.items() if v} }")
    block_err = blocks_vs_forward(params, cfg, seq, P + VLM_PROMPT,
                                  prefix=prefix)
    # one train_loss with the prefix, forward and backward
    _build.reset_launch_counts()
    with torch.no_grad():
        lg = T.forward(params, cfg, tokens, prefix_embeds=prefix)[0]
        xent = float(T.softmax_xent(lg[:, P:-1], tokens[:, 1:]))
        del lg
    fwd = dict(_build.LAUNCHES)
    loss, grads, train, step_s = loss_backward(
        params, R.make_train_loss(cfg),
        dict(prefix_embeds=prefix, tokens=tokens, labels=tokens))
    finite, n_leaves = grads_ok(grads), len(grads)
    del grads
    want = forward_launches(cfg)
    check(fwd == want and train == want,
          f"{name} train loss: launches {fwd} (forward), {train} (loss, "
          f"forward and backward) != {want} each")
    check(finite, f"{name} train loss: a gradient leaf is not finite or "
                  f"all zero")
    check(math.isfinite(loss) and abs(loss - xent) <= VLM_LOSS_RTOL
          * abs(xent), f"{name} train loss {loss!r} != the forward's "
                       f"cross-entropy past the prefix {xent!r}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{name} train loss with the prefix: {loss:.6f}, the forward's "
        f"cross-entropy past it {xent:.6f} (diff {abs(loss - xent):.3e}); "
        f"forward and backward {step_s:.3f} s; {n_leaves} gradient "
        f"leaves finite and nonzero; peak device memory {peak:.2f} GB")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return ({f"{name} prefix serving (prefill, {VLM_NEW - 1} decode steps)":
             serve, f"{name} forward with the prefix": fwd,
             f"{name} train loss with the prefix": train},
            dict(params=n_params, layers=L, prefix=P, prompt=VLM_PROMPT,
                 prefill_ms=1e3 * prefill_s,
                 decode_ms=1e3 * float(np.mean(decode_s)),
                 logits=dict(max_rel_err=worst, bound=rtol,
                             argmax_agreement=agree / len(rows),
                             rows=len(rows), block_max_rel_err=block_err),
                 train=dict(loss=loss, forward_xent=xent, step_s=step_s),
                 peak_gb=peak))


def phase_serve() -> tuple:
    """Phase 11: the serving twins, codeqwen1.5-7b at full width and depth
    and mamba2-2.7b at full width (served at ``SERVE_SERVED_LAYERS``' 16
    layers, its blocks held at 64), llama4-scout-17b-a16e (2 layers,
    capacity factor 16) and deepseek-v3-671b (4 layers, capacity factor
    32) at full width, the dense nemotron-4-15b (full depth), deepseek-67b
    and llama3-405b (4 layers each) at full width in ``SERVE_DENSE_RUN``,
    whisper-base at full width and depth (``SERVE_ENCDEC_RUN``, and its
    train step), internvl2-76b's prefix path (``phase_vlm_prefix``), then
    ``launch/serve.py --smoke`` (mamba2-2.7b and whisper-base) and
    ``examples/torch_serve.py`` on the card.  Returns (launches by path,
    records, wall seconds)."""
    t0 = time.perf_counter()
    counts = phase_serve_twins()
    recs = {}
    moes = []
    for mod in (llama4_scout_17b_a16e, deepseek_v3_671b):
        cfg = mod.config()
        layers, factor = SERVE_MOE_CUTS[cfg.name]
        check(factor == cfg.num_experts / cfg.top_k,
              f"{cfg.name}'s serving capacity factor must give every expert "
              f"a place for every token")
        moes.append(dataclasses.replace(cfg, num_layers=layers,
                                        capacity_factor=factor))
    for cfg in (codeqwen1p5_7b.config(), mamba2_2p7b.config(), *moes):
        c, recs[cfg.name] = phase_serve_full(cfg)
        counts.update(c)
    for mod in (nemotron_4_15b, deepseek_67b, llama3_405b):
        cfg = mod.config()
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DENSE_LAYERS.get(
            cfg.name, cfg.num_layers))
        c, recs[cfg.name] = phase_serve_full(cfg, SERVE_FULL_RUNS[:1],
                                             **SERVE_DENSE_RUN)
        counts.update(c)
    t1 = time.perf_counter()
    c, recs["whisper-base"] = phase_serve_full(whisper_base.config(),
                                               **SERVE_ENCDEC_RUN)
    counts.update(c)
    recs["whisper-base"]["wall_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    c, recs["internvl2-76b"] = phase_vlm_prefix(internvl2_76b.config())
    counts.update(c)
    recs["internvl2-76b"]["wall_s"] = time.perf_counter() - t1
    log(f"phase 11: whisper-base {recs['whisper-base']['wall_s']:.1f} s, "
        f"internvl2-76b {recs['internvl2-76b']['wall_s']:.1f} s")
    for label, fn in (
            ("launch/serve.py --smoke (mamba2-2.7b smoke, top-k)",
             lambda: launch_serve.main(["--arch", "mamba2_2p7b", "--smoke",
                                        "--temperature", "0.8"])),
            ("launch/serve.py --smoke (whisper-base smoke)",
             lambda: launch_serve.main(["--arch", "whisper_base",
                                        "--smoke"])),
            ("examples/torch_serve.py (codeqwen smoke)",
             lambda: load_example("torch_serve").main([]))):
        _build.reset_launch_counts()
        out = fn()
        eng = out["engine"]
        got, want = dict(_build.LAUNCHES), serve_launches(eng)
        check(got == want and out["summary"]["completed"] == len(
            eng.requests), f"{label}: launches {got} != {want}")
        log(f"{label}: {out['summary']['tokens_decoded']} tokens in "
            f"{out['wall_seconds']:.2f} s; launches "
            f"{ {k: v for k, v in got.items() if v} }")
        counts[label] = got
    wall = time.perf_counter() - t0
    log(f"phase 11 (serving): {wall:.1f} s")
    return counts, recs, wall


# phase 12: the whole-model launcher (launch/train.py).  (a) mamba2-2.7b at
# its published size (64 layers) through the launcher's command line; (b)
# codeqwen1.5-7b at full width cut to 8 layers (a fit cut: its 32 layers
# need 131 GB of weights, gradients and AdamW state) through train()
TRAIN_MAMBA = dict(steps=3, seq=512, batch=2)
TRAIN_DENSE = dict(steps=2, seq=1024, batch=2)
TRAIN_DENSE_LAYERS = 8
# (c) the AdamW gate: in the second step of (a), three parameters' update
# redone by the plain version on the card from their copied gradients and
# pre-step state: the embedding (the tied head's too), a Mamba2 in_proj and
# a norm scale (float32)
ADAM_GATE_PATHS = ((0, "embed", "embedding"), (1, 0, "mamba", "in_proj"),
                   (1, 0, "ln1", "scale"))
ADAM_GATE_STEP = 1                 # the state's step before that update
ADAM_TIER = ops.TOLERANCE_TIERS["fused_adam"]
# (d) the tiny card twins: the dense, ssm and audio smoke configs (float32)
# through train() on the card and on the CPU from the same weights; the
# checkpoint on the ssm one (its tied head)
TRAIN_TWIN_MODULES = (codeqwen1p5_7b, mamba2_2p7b, whisper_base)
TRAIN_TWIN = dict(steps=3, seq=16, batch=2)
TRAIN_TWIN_LOSS_RTOL = 1e-5
TRAIN_CKPT_SAVE_STEP = 1


def launcher_launches(cfg, n_params: int, steps: int) -> dict:
    """The launches of ``steps`` launcher steps: a forward's rmsnorm a norm
    (ln1, a Mamba2 block's out_norm or an MLP block's ln2, an enc-dec
    decoder block's lnx, the final norm and the encoder's enc_norm) and
    its route's flash or SSD launch a mixer (an enc-dec config's frames
    are as many as its tokens, so its cross-attention launches flash too);
    one fused AdamW a distinct parameter; the backward launches nothing (it
    differentiates the plain versions)."""
    want = {k: 0 for k in _build.LAUNCHES}
    if cfg.is_encdec:
        n_enc = cfg.encoder_layers or cfg.num_layers
        n_dec = cfg.decoder_layers or cfg.num_layers
        want["rmsnorm"] = 2 * n_enc + 1 + 3 * n_dec + 1
        want[serve_route(cfg, ATTN)] = n_enc + 2 * n_dec
    else:
        for blk in R.flat_layer_types(cfg):
            want["rmsnorm"] += 2
            want[serve_route(cfg, blk)] += 1
        want["rmsnorm"] += 1
    want["fused_adam"] = n_params
    return {k: v * steps for k, v in want.items()}


def adam_gate(pre: dict, params, state: dict, cfg: AdamConfig) -> dict:
    """Each gated parameter's update redone by the plain version
    (``ref.adam_flat_reference``, the CPU path of ``ops.fused_adam_``) on
    the card, from its copied bf16 or float32 gradient and pre-step state
    (copies on the card), held to the ``fused_adam`` tier against the
    kernel's; whether bitwise (both sides take the bias corrections of
    ``ops.adam_scalars``).  On the card: the CPU's copies and passes over
    the embedding's 129 M elements took ~5 s of host time."""
    out = {}
    scalars = ops.adam_scalars(state["step"], b1=cfg.b1, b2=cfg.b2,
                               eps=cfg.eps, lr=cfg.lr,
                               weight_decay=cfg.weight_decay)
    for path, c in pre.items():
        g = c["g"].reshape(-1).float()
        new = ref.adam_flat_reference(
            g, *(c[k].reshape(-1) for k in ("master", "mu", "nu")), scalars)
        card = {k: v.reshape(-1) for k, v in
                at(state["leaves"], path).items()}
        card["p"] = at(params, path).detach().reshape(-1)
        new["p"] = new["master"].to(card["p"].dtype)
        rec = {}
        for k in ("master", "mu", "nu", "p"):
            check(new[k].is_cuda, f"AdamW gate: {k} off the card")
            ok, err = within(card[k], new[k], ADAM_TIER)
            check(ok, f"AdamW gate {'/'.join(map(str, path))} {k}: max "
                      f"|diff| {err:.3e} beyond the fused_adam tier")
            rec[k] = dict(max_abs_err=err,
                          bitwise=bool(torch.equal(card[k], new[k])))
        out["/".join(map(str, path))] = dict(elements=g.numel(), **rec)
    return out


@contextlib.contextmanager
def launcher_probe(gate_paths: tuple = ()):
    """Times each launcher step and each AdamW update (between
    ``torch.cuda.synchronize`` calls) and counts each step's launches, by
    wrapping ``launch.train.train_step`` and ``optim.adam.adam_update``;
    records the optimizer state's bytes and device, and runs the AdamW gate
    on ``gate_paths`` at the step whose state is at ``ADAM_GATE_STEP``."""
    rec = dict(step_ms=[], adam_ms=[], step_launches=[], gate=None,
               gate_s=0.0)
    inner_step, inner_adam = launch_train.train_step, adam_mod.adam_update

    def step(*a, **k):
        before, gate_s = dict(_build.LAUNCHES), rec["gate_s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_step(*a, **k)
        torch.cuda.synchronize()
        # the AdamW gate's copies and plain update are not the step's
        rec["step_ms"].append((time.perf_counter() - t0
                               - (rec["gate_s"] - gate_s)) * 1e3)
        rec["step_launches"].append(
            {k: v - before[k] for k, v in _build.LAUNCHES.items()})
        return out

    def adam(params, grads, state, cfg):
        copy = lambda t: t.detach().clone()                  # noqa: E731
        # the step's queued forward and backward stay in the step's time
        torch.cuda.synchronize()
        pre = None
        if gate_paths and state["step"] == ADAM_GATE_STEP:
            t0 = time.perf_counter()
            pre = {path: dict(g=copy(at(grads, path)),
                              **{c: copy(v) for c, v in
                                 at(state["leaves"], path).items()})
                   for path in gate_paths}
            torch.cuda.synchronize()
            rec["gate_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        params, new = inner_adam(params, grads, state, cfg)
        torch.cuda.synchronize()
        rec["adam_ms"].append((time.perf_counter() - t0) * 1e3)
        leaves = [t for _, t in leaves_with_paths(new["leaves"])]
        rec["state_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
        rec["state_on_card"] = all(t.is_cuda for t in leaves)
        distinct = [t for _, t in leaves_with_paths(params)]
        rec["params"] = sum(t.numel() for t in distinct)
        rec["n_leaves"] = len(distinct)
        if pre is not None:
            t0 = time.perf_counter()
            rec["gate"] = adam_gate(pre, params, new, cfg)
            del pre
            torch.cuda.synchronize()
            rec["gate_s"] += time.perf_counter() - t0
        return params, new

    launch_train.train_step, adam_mod.adam_update = step, adam
    try:
        yield rec
    finally:
        launch_train.train_step, adam_mod.adam_update = inner_step, inner_adam


def float32_first_loss(cfg, seq: int, batch: int) -> float:
    """The launcher's first loss recomputed in float32: the weights
    ``launch.train.train`` draws (``registry.init_model`` from seed 0 on
    the card), cast to float32, on step 0's batch, forward only."""
    params = R.init_model(torch.Generator("cuda").manual_seed(0), cfg)
    p32 = float32_params(params)
    del params
    b = make_batch(GlobalBatchSampler(batch).sample_ids(0), seq,
                   cfg.vocab_size, device="cuda")
    b.update(launch_train.extra_inputs(cfg, 0, batch, seq, "cuda"))
    with torch.no_grad():
        loss = float(R.make_train_loss(
            dataclasses.replace(cfg, dtype="float32"))(p32, b))
    del p32
    torch.cuda.empty_cache()
    return loss


def phase_launcher_full(name: str, cfg, run: dict, fn) -> tuple:
    """One launcher run at full width on the card: the first loss within
    one bf16 spacing (2**-7 relative) of the float32 loss on the same
    weights and batch, every loss finite, launches exact a step, the AdamW
    state on the card at 12 bytes a parameter; ms a step and an AdamW
    update, peak device memory.  ``fn()`` trains ``cfg`` for ``run``'s
    steps, seq and batch and returns the losses.  Returns (launches,
    record)."""
    seq, batch, steps = run["seq"], run["batch"], run["steps"]
    loss32 = float32_first_loss(cfg, seq, batch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with launcher_probe(ADAM_GATE_PATHS if cfg.family == "ssm" else ()) \
            as probe:
        losses = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = probe["params"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{name}: losses {losses}")
    check(abs(losses[0] - loss32) <= BF16_LOSS_RTOL * abs(loss32),
          f"{name}: first loss {losses[0]!r} vs the float32 forward's "
          f"{loss32!r}")
    check(probe["state_on_card"] and probe["state_bytes"] == 12 * n,
          f"{name}: AdamW state {probe['state_bytes']} bytes, on the card "
          f"{probe['state_on_card']}, want {12 * n}")
    want = launcher_launches(cfg, probe["n_leaves"], 1)
    for i, c in enumerate(probe["step_launches"]):
        check(c == want, f"{name} step {i}: launches {c} != {want}")
    check(counts == {k: v * steps for k, v in want.items()},
          f"{name}: launches {counts}")
    if cfg.family == "ssm":
        check(probe["gate"] is not None, f"{name}: the AdamW gate never ran")
    rec = dict(params=n, layers=cfg.num_layers, seq=seq, batch=batch,
               losses=losses, float32_first_loss=loss32,
               step_ms=probe["step_ms"], adam_ms=probe["adam_ms"],
               wall_s=wall, adam_gate_s=probe["gate_s"], peak_mem_GB=peak,
               state_bytes=probe["state_bytes"],
               launches_per_step={k: v for k, v in want.items() if v},
               adam_gate=probe["gate"])
    log(f"{name}: {n} params ({cfg.param_count()} by the config's count, "
        f"which leaves out the norms), {cfg.num_layers} layers, seq {seq} x "
        f"batch {batch}: losses {losses} (float32 first loss {loss32:.6f}); "
        f"ms a step {[round(x, 3) for x in probe['step_ms']]}, an AdamW "
        f"update {[round(x, 3) for x in probe['adam_ms']]}; peak_mem_GB "
        f"{peak:.2f}; AdamW state {probe['state_bytes']} bytes on the card; "
        f"launches a step {rec['launches_per_step']}; {wall:.1f} s")
    if probe["gate"]:
        log(f"{name}: AdamW gate (step {ADAM_GATE_STEP + 1}, the kernel vs "
            f"the plain version on the card, {probe['gate_s']:.2f} s, not in "
            f"the step's time): {probe['gate']}")
    return counts, rec


def launcher_steps(params, opt, cfg, first: int, n: int) -> tuple:
    """The launcher's steps ``first .. first + n - 1`` of ``cfg`` on the
    card at ``TRAIN_TWIN``'s seq and batch (``launch.train.train_steps``);
    returns (losses, opt)."""
    return launch_train.train_steps(
        cfg, params, opt, first, n, seq=TRAIN_TWIN["seq"],
        batch=TRAIN_TWIN["batch"], device="cuda",
        log=lambda m: None)


def trees_within(a, b, rtol: float, atol: float) -> tuple:
    """Whether every tensor of tree ``a`` is within ``rtol`` /
    ``atol`` of ``b``'s (on the CPU), and the largest difference."""
    ok, worst = True, 0.0
    for (_, x), (_, y) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        x = x.detach().cpu()
        ok = ok and torch.allclose(x, y, rtol=rtol, atol=atol)
        worst = max(worst, float((x - y).abs().max()))
    return ok, worst


def phase_launcher_twins(tmp: Path) -> tuple:
    """(d): ``launch.train.train`` on the tiny dense, ssm and audio smoke
    configs (float32) on the card and on the CPU from the same weights for
    3 steps: losses within 1e-5 relative, parameters and AdamW state within
    the bf16 twins' bound (2**-7 relative on top of the step-sign allowance
    ``KCC.PARAM_ATOL0 + 2 lr step``), launches exact.  Then the checkpoint
    on the card (the ssm config, its head tied): a save without blocking at
    step 1 while training goes on in place, restored into a fresh tree bit
    for bit, 2 steps from it and from the live state within the twins'
    bound (and whether bitwise).  Returns (launches by path, records)."""
    counts, recs = {}, {}
    for mod in TRAIN_TWIN_MODULES:
        cfg = mod.smoke_config()
        cpu = R.init_model(torch.Generator().manual_seed(0), cfg)
        card = map_params(lambda t: t.to("cuda"), cpu)
        out = {}
        for dev, params in (("cuda", card), ("cpu", cpu)):
            _build.reset_launch_counts()
            out[dev] = launch_train.train(
                cfg, device=dev, params=params, log=lambda m: None,
                **TRAIN_TWIN)
            if dev == "cuda":
                got = dict(_build.LAUNCHES)
        name = f"launcher twin {cfg.name} (float32)"
        a, b = out["cuda"], out["cpu"]
        check(all(abs(x - y) <= TRAIN_TWIN_LOSS_RTOL * abs(y)
                  for x, y in zip(a, b)),
              f"{name}: losses {a} (card) vs {b} (cpu)")
        atol = KCC.PARAM_ATOL0 + 2.0 * 1e-3 * TRAIN_TWIN["steps"]
        ok, worst = trees_within(card, cpu, BF16_PARAM_RTOL, atol)
        check(ok, f"{name}: parameters beyond the twins' bound (max |diff| "
                  f"{worst:.3e})")
        want = launcher_launches(cfg, len(leaves_with_paths(cpu)),
                                 TRAIN_TWIN["steps"])
        check(got == want, f"{name}: launches {got} != {want}")
        log(f"{name}: losses card {a} cpu {b}; parameters max |diff| "
            f"{worst:.3e}; launches {({k: v for k, v in got.items() if v})}")
        counts[name] = got
        recs[cfg.name] = dict(losses_card=a, losses_cpu=b,
                              param_max_abs_diff=worst)
    # the checkpoint on the card
    cfg = mamba2_2p7b.smoke_config()
    params = map_params(lambda t: t.to("cuda"),
                      R.init_model(torch.Generator().manual_seed(0), cfg))
    opt = adam_mod.init_opt_state(params, launch_train.ADAM)
    _build.reset_launch_counts()
    _, opt = launcher_steps(params, opt, cfg, 0, TRAIN_CKPT_SAVE_STEP + 1)
    ck = CheckpointManager(tmp / "ckpt")
    saved = [t.clone() for _, t in leaves_with_paths((params, opt["leaves"]))]
    t0 = time.perf_counter()
    ck.save(TRAIN_CKPT_SAVE_STEP, params, opt, blocking=False)
    save_s = time.perf_counter() - t0
    live, opt = launcher_steps(params, opt, cfg, TRAIN_CKPT_SAVE_STEP + 1, 2)
    ck.wait()
    step, flat, _ = ck.restore()
    fresh = map_params(lambda t: t.to("cuda"),
                     R.init_model(torch.Generator().manual_seed(1), cfg))
    fresh_opt = adam_mod.init_opt_state(fresh, launch_train.ADAM)
    fresh = ck.restore_into(fresh, flat["params"])
    fresh_opt = ck.restore_into(fresh_opt, flat["opt"])
    restored = [t for _, t in leaves_with_paths((fresh, fresh_opt["leaves"]))]
    check(step == TRAIN_CKPT_SAVE_STEP
          and fresh_opt["step"] == TRAIN_CKPT_SAVE_STEP + 1
          and all(t.is_cuda for t in restored)
          and len(restored) == len(saved)
          and all(torch.equal(x, y) for x, y in zip(restored, saved)),
          "checkpoint: the restored tree differs from the state at the save")
    again, fresh_opt = launcher_steps(fresh, fresh_opt, cfg,
                                      TRAIN_CKPT_SAVE_STEP + 1, 2)
    bitwise = again == live and all(
        torch.equal(x, y) for (_, x), (_, y) in
        zip(leaves_with_paths((fresh, fresh_opt["leaves"])),
            leaves_with_paths((params, opt["leaves"]))))
    check(all(abs(x - y) <= TRAIN_TWIN_LOSS_RTOL * abs(y)
              for x, y in zip(again, live)),
          f"checkpoint: losses from the restored state {again} vs the live "
          f"state's {live}")
    counts["launcher checkpoint (tiny ssm)"] = dict(_build.LAUNCHES)
    recs["checkpoint"] = dict(save_call_s=save_s, live_losses=live,
                              restored_losses=again, bitwise=bitwise,
                              leaves=len(saved))
    log(f"launcher checkpoint on the card ({cfg.name}): save without "
        f"blocking returned in {save_s:.4f} s; {len(saved)} tensors restored "
        f"bit for bit; losses after the restore {again} vs live {live}; "
        f"bitwise {bitwise}")
    return counts, recs


def phase_launcher(tmp: Path) -> tuple:
    """Phase 12: the whole-model training launcher (``launch/train.py``):
    (a) mamba2-2.7b at its published size through the launcher's command
    line, with the AdamW gate (c); (b) codeqwen1.5-7b at full width, 8
    layers; (d) the tiny twins and the checkpoint.  Returns (launches by
    path, records, wall seconds)."""
    t0 = time.perf_counter()
    counts, recs = {}, {}
    argv = ["--arch", "mamba2_2p7b"] + [
        x for k, v in TRAIN_MAMBA.items() for x in (f"--{k}", str(v))]
    dense = dataclasses.replace(codeqwen1p5_7b.config(),
                                num_layers=TRAIN_DENSE_LAYERS)
    runs = (("mamba2-2.7b (launcher, 64 layers)", mamba2_2p7b.config(),
             TRAIN_MAMBA, lambda: launch_train.main(argv)),
            (f"codeqwen1.5-7b (launcher, {TRAIN_DENSE_LAYERS} layers)", dense,
             TRAIN_DENSE, lambda: launch_train.train(dense, **TRAIN_DENSE)))
    for name, cfg, run, fn in runs:
        counts[name], recs[name] = phase_launcher_full(name, cfg, run, fn)
        gc.collect()
        torch.cuda.empty_cache()
    c, recs["twins"] = phase_launcher_twins(tmp)
    counts.update(c)
    wall = time.perf_counter() - t0
    log(f"phase 12 (launcher): {wall:.1f} s")
    return counts, recs, wall


# phase 13: the dry-run cells on the card.  codeqwen1.5-7b cut to 8 layers
# (phase 12's fit cut: its train step's state is 36.6 GB, and the remat
# check holds one step's result beside the other's) and mamba2-2.7b cut to
# 8 (its 64 would take 2 x 37.8 GB); whisper-base whole.  Seq x batch:
# codeqwen's and mamba2's 1024 x 2; whisper-base's 448 (its decoder's
# positions) x 2 with its 1500 frames
CELL_RUN = dict(seq=1024, batch=2)
CELL_LAYERS = 8
CELL_ENCDEC_TOKENS = 448
CELL_BF16 = ops.TOLERANCE_TIERS["flash_attention_bf16"]


def branch_rtol(cfg) -> float:
    """A decode step's logits bound against the forward: the bf16 tier's
    rtol for each residual branch and the head, adding as a random walk
    (``serve_logit_rtol``'s rule at ``cfg``'s own depth: 2L + 1, an enc-dec
    decoder's 3L + 1)."""
    n = cfg.decoder_layers or cfg.num_layers
    return CELL_BF16["rtol"] * math.sqrt(
        (3 * n if cfg.is_encdec else 2 * cfg.num_layers) + 1)


def rows_within(a: torch.Tensor, b: torch.Tensor, rtol: float) -> tuple:
    """Whether each row's max |a - b| is within ``rtol`` of its max |b|
    (plus the bf16 tier's atol), and the largest such ratio."""
    a, b = a.float().reshape(-1, a.shape[-1]), b.float().reshape(
        -1, b.shape[-1])
    err = (a - b).abs().amax(-1)
    ratio = err / (rtol * b.abs().amax(-1) + CELL_BF16["atol"])
    return bool((ratio <= 1).all()), float(ratio.max())


def cell_train_launches(cfg, n_leaves: int, remat: bool,
                        frames: int = 0, tokens: int = 0) -> dict:
    """A train cell's launches: one forward's (a decoder-only config's as
    ``launcher_launches`` counts them, an enc-dec config's
    ``forward_launches``: its ``frames`` != ``tokens``), its blocks' again
    under remat (the recompute; the final norm and an enc-dec
    ``enc_norm`` run outside the checkpointed blocks), one fused AdamW a
    parameter leaf."""
    if cfg.is_encdec:
        want = dict(forward_launches(cfg, frames, tokens),
                    fused_adam=n_leaves)
    else:
        want = launcher_launches(cfg, n_leaves, 1)
    if remat:
        outside = 2 if cfg.is_encdec else 1
        want = {k: v if k == "fused_adam" else 2 * v - outside
                if k == "rmsnorm" else 2 * v for k, v in want.items()}
    return want


def decode_launches(cfg) -> dict:
    """One decode step's launches: every norm's rmsnorm, no flash or SSD
    launch (attention over the cache and the SSM recurrence are plain)."""
    want = {k: 0 for k in _build.LAUNCHES}
    n = cfg.decoder_layers or cfg.num_layers
    want["rmsnorm"] = (3 * n if cfg.is_encdec else 2 * cfg.num_layers) + 1
    return want


def bits_digest(tree) -> list:
    """Each leaf's bits summed, plain and weighted by position (int64 on
    the card): a witness that two draws of a tree are the same bits."""
    out = []
    for _, t in leaves_with_paths(tree):
        v = t.detach().reshape(-1)
        bits = v.view(torch.int16 if v.element_size() == 2 else torch.int32
                      ).to(torch.int64)
        out.append((int(bits.sum()), int((bits * torch.arange(
            1, bits.numel() + 1, device=bits.device)).sum())))
    return out


def cell_batch(cfg, seq: int, batch: int, seed: int) -> dict:
    """Seeded int32 tokens (labels the same) and, for an enc-dec config,
    its frames, on the card."""
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, seq))
                          .astype(np.int32), device="cuda")
    out = {"tokens": tok, "labels": tok}
    if cfg.is_encdec:
        out["frames"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.max_source_positions, cfg.d_model)).astype(
            np.float32), device="cuda").to(cfg.torch_dtype)
    return out


@contextlib.contextmanager
def peak_before_adam():
    """Yields a list that gets the peak device memory allocated up to the
    first ``optim.adam.adam_update`` call (a step's forward and backward),
    read at that call."""
    seen, inner = [], adam_mod.adam_update

    def adam(*a, **k):
        torch.cuda.synchronize()
        seen.append(torch.cuda.max_memory_allocated())
        return inner(*a, **k)

    adam_mod.adam_update = adam
    try:
        yield seen
    finally:
        adam_mod.adam_update = inner


def cell_train_pair(name: str, cfg, seq: int, batch: int, card: str) -> tuple:
    """``cfg``'s ``train_4k`` cell at ``seq`` x ``batch`` without remat,
    then with it, each one step from the parameters of seed 0 on the card
    and a fresh AdamW state: the loss and every parameter, mu, nu and
    master bitwise equal (held), launches exact (held), peak device memory
    of each above what was allocated before it, up to AdamW (the forward
    and backward) and over the step.  The first step's result stays on the
    card while the second runs (36.6 GB at codeqwen's 8 layers).  Returns
    (launches by path, record)."""
    mesh = production_mesh_shape(False)
    b = cell_batch(cfg, seq, batch, seed=13)
    frames = cfg.max_source_positions if cfg.is_encdec else 0
    out, counts, rec = {}, {}, {}
    for remat in (False, True):
        cell = build_cell(cfg, "train_4k", seq, batch, mesh, remat=remat)
        params = R.init_model(torch.Generator("cuda").manual_seed(0), cfg)
        digest = bits_digest(params)
        opt = adam_mod.init_opt_state(params, adam_mod.AdamConfig())
        n_leaves = len(leaves_with_paths(params))
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        with peak_before_adam() as fwd_bwd:
            t0 = time.perf_counter()
            params, opt, loss = cell.fn(params, opt, b)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        got = dict(_build.LAUNCHES)
        want = cell_train_launches(cfg, n_leaves, remat, frames, seq)
        tag = f"{name} train_4k cell ({'remat' if remat else 'no remat'})"
        check(got == want, f"{tag}: launches {got} != {want}")
        check(math.isfinite(float(loss)), f"{tag}: loss {float(loss)}")
        counts[tag] = got
        peak = torch.cuda.max_memory_allocated()
        rec["remat" if remat else "no_remat"] = dict(
            loss=float(loss), step_s=step_s, peak_GB=peak / 1e9,
            allocated_before_GB=base / 1e9,
            peak_GB_above_before=(peak - base) / 1e9,
            fwd_bwd_peak_GB_above_before=(fwd_bwd[0] - base) / 1e9,
            launches={k: v for k, v in got.items() if v})
        out[remat] = ((params, opt["leaves"]), loss, digest)
        del cell
    (a, la, da), (c, lc, dc) = out[False], out[True]
    check(da == dc, f"{name}: the two draws of the parameters differ")
    diffs = [("/".join(map(str, p)), float((x.float() - y.float()).abs()
                                           .max()))
             for (p, x), (_, y) in zip(leaves_with_paths(a),
                                       leaves_with_paths(c))
             if not torch.equal(x, y)]
    check(torch.equal(la, lc), f"{name}: remat loss {float(lc)!r} != "
                               f"{float(la)!r} without")
    check(not diffs, f"{name}: remat changed {len(diffs)} leaves: "
                     f"{diffs[:5]}")
    rec.update(params=sum(t.numel() for _, t in leaves_with_paths(a[0])),
               leaves_compared=len(leaves_with_paths(a)), bitwise=True)
    log(f"{name} train_4k cell, seq {seq} x batch {batch}: loss "
        f"{float(la):.6f} with and without remat, bitwise; every one of "
        f"{rec['leaves_compared']} parameter, mu, nu and master tensors "
        f"bitwise; peak GB above what was allocated before the step (its "
        f"parameters and AdamW state; the remat step's also the first "
        f"step's result), forward and backward: no remat "
        f"{rec['no_remat']['fwd_bwd_peak_GB_above_before']:.3f}, remat "
        f"{rec['remat']['fwd_bwd_peak_GB_above_before']:.3f}; the whole "
        f"step (AdamW's float32 gradient copies beside the gradients): "
        f"{rec['no_remat']['peak_GB_above_before']:.3f} / "
        f"{rec['remat']['peak_GB_above_before']:.3f}; absolute peak "
        f"{rec['no_remat']['peak_GB']:.3f} / {rec['remat']['peak_GB']:.3f};"
        f" step s "
        f"{rec['no_remat']['step_s']:.3f} / {rec['remat']['step_s']:.3f} "
        f"({card})")
    del a, c, out
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rec


def cell_serving(name: str, cfg, seq: int, batch: int, card: str) -> tuple:
    """``cfg``'s ``prefill_32k`` cell over a seeded prompt of ``seq``
    tokens against the forward's last position (an enc-dec config's
    ``encdec.decode`` over its encoder output), elementwise within the
    bf16 tier; then its ``decode_32k`` cell's step at position seq - 1
    after the prefill cell wrote the first seq - 1 tokens into its caches,
    against the same logits within ``branch_rtol``.  Launches exact.
    Returns (launches by path, record)."""
    mesh = production_mesh_shape(False)
    pre = build_cell(cfg, "prefill_32k", seq, batch, mesh)
    dec = build_cell(cfg, "decode_32k", seq, batch, mesh)
    params = R.init_model(torch.Generator("cuda").manual_seed(0), cfg)
    b = cell_batch(cfg, seq, batch, seed=14)
    tok = b["tokens"]
    init = E.init_decoder_caches if cfg.is_encdec else T.init_caches

    def zeros():
        return init(cfg, batch, seq, "cuda")

    extra = (b["frames"],) if cfg.is_encdec else ()
    with torch.no_grad():
        if cfg.is_encdec:
            enc = E.encode(params, cfg, b["frames"])
            full = E.decode(params, cfg, tok, enc)[0][:, -1]
        else:
            full = T.forward(params, cfg, tok)[0][:, -1]
        counts = {}
        _build.reset_launch_counts()
        logits, _ = pre.fn(params, zeros(), tok, *extra)
        counts[f"{name} prefill_32k cell"] = dict(_build.LAUNCHES)
        ok_p, err_p = within(logits[:, 0], full, CELL_BF16)
        _build.reset_launch_counts()
        _, caches = pre.fn(params, zeros(), tok[:, :-1], *extra)
        if cfg.is_encdec:
            enc_args = (E.encode(params, cfg, b["frames"]),)
        else:
            enc_args = ()
        counts[f"{name} prefill of seq - 1, encode, for the decode"] = \
            dict(_build.LAUNCHES)
        _build.reset_launch_counts()
        step, _ = dec.fn(params, caches, tok[:, -1:], *enc_args,
                         torch.tensor(seq - 1, dtype=torch.int32,
                                      device="cuda"))
        counts[f"{name} decode_32k cell"] = dict(_build.LAUNCHES)
    rtol = branch_rtol(cfg)
    ok_d, ratio_d = rows_within(step[:, 0], full, rtol)
    frames = cfg.max_source_positions if cfg.is_encdec else 0
    want_pre = forward_launches(cfg, frames, seq)
    check(counts[f"{name} prefill_32k cell"] == want_pre,
          f"{name} prefill cell: launches "
          f"{counts[f'{name} prefill_32k cell']} != {want_pre}")
    want_fill = forward_launches(cfg, frames, seq - 1)
    if cfg.is_encdec:               # the decode's encoder output
        n_enc = cfg.encoder_layers or cfg.num_layers
        want_fill["rmsnorm"] += 2 * n_enc + 1
        want_fill[serve_route(cfg, ATTN)] += n_enc
    fill = counts[f"{name} prefill of seq - 1, encode, for the decode"]
    check(fill == want_fill, f"{name} the decode's prefill: launches "
                             f"{fill} != {want_fill}")
    check(counts[f"{name} decode_32k cell"] == decode_launches(cfg),
          f"{name} decode cell: launches {counts[f'{name} decode_32k cell']}"
          f" != {decode_launches(cfg)}")
    check(ok_p, f"{name} prefill cell: logits vs the forward's, max |diff| "
                f"{err_p:.3e} beyond the bf16 tier")
    check(ok_d, f"{name} decode cell: logits vs the forward's, a row's "
                f"max |diff| {ratio_d:.3f} of its bound (rtol {rtol:.4f})")
    log(f"{name} prefill_32k cell ({seq} x {batch}): logits max |diff| "
        f"{err_p:.3e} vs the forward (bf16 tier, held); decode_32k cell at "
        f"position {seq - 1}: worst row {ratio_d:.3f} of its bound (rtol "
        f"{rtol:.4f}, held) ({card})")
    rec = dict(prefill_max_abs_err=err_p, decode_row_ratio=ratio_d,
               decode_rtol=rtol)
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rec


def placement_summary() -> dict:
    """On the host: for each published config on both production meshes,
    the parameter leaves the rules shard and the parameter bytes one rank
    holds (each leaf's bytes over the product of its spec's axes)."""
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        shapes = R.model_param_shapes(cfg)
        leaves = leaves_with_paths(shapes)
        total = sum(t.numel() * t.element_size() for _, t in leaves)
        row = dict(leaves=len(leaves), param_bytes=total)
        for multi in (False, True):
            mesh = production_mesh_shape(multi)
            specs = sharding.param_pspecs(cfg, mesh, shapes)
            n_sharded, rank_bytes = 0, 0
            for (_, t), (_, spec) in zip(leaves, sharding.spec_leaves(specs)):
                split = math.prod(sharding.mesh_axis_size(mesh, e)
                                  for e in spec)
                n_sharded += split > 1
                rank_bytes += t.numel() * t.element_size() // split
            row["x".join(map(str, mesh.sizes))] = dict(
                sharded_leaves=n_sharded, rank_param_bytes=rank_bytes)
        out[cfg.name] = row
    return out


# phase 14: the dry run on this machine's torch, held to the artifact's
# values on the CPU, as tests/test_torch_dryrun_ref.py pins them: two
# fields that need no count, and the two counts (the local FLOPs and the
# collective operand bytes), which this machine's torch could change
DRYRUN_CELL = ("whisper_base", "decode_32k", "single")
DRYRUN_PIN = {"argument_size_in_bytes": 220_857_252,
              "model_flops": 28_094_758_912,
              "hlo_flops_per_device": 8_540_463_104,
              "collective_bytes.total": 217_879_424}


def phase_dryrun_start(tmp: Path):
    """Phase 14's start: ``python -m repro_torch.launch.dryrun`` on
    ``DRYRUN_CELL`` in a subprocess (its artifact under ``tmp``), started
    before the kernels' build so that the two overlap (the child runs on
    the host's cores alone: meta tensors, no device, no kernel; the build
    times nothing, so no phase's times are taken beside it).  Returns (the
    process, its start time)."""
    arch, shape, mesh = DRYRUN_CELL
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out-dir", str(tmp)],
        cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    return proc, time.perf_counter()


def phase_dryrun_finish(proc, t0: float, tmp: Path) -> tuple:
    """Phase 14's end: wait for the dry run, hold its artifact to
    ``DRYRUN_PIN``.  The child raises if any launch counter moves in it
    (``dryrun.count_cell``), so its exit code 0 says none did.  Returns
    (the artifact's summary, the child's wall seconds, the seconds waited
    here)."""
    tw = time.perf_counter()
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    waited = time.perf_counter() - tw
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"dry run {DRYRUN_CELL} failed (rc "
                                f"{proc.returncode}): {err[-3000:]}")
    arch, shape, mesh = DRYRUN_CELL
    art = json.loads((tmp / f"{arch}__{shape}__{mesh}.json").read_text())
    check(art["status"] == "ok", f"dry run {DRYRUN_CELL}: {art}")
    fields = {**art, **art["memory_analysis"], "collective_bytes.total":
              art["collective_bytes"]["total"]}
    for k, v in DRYRUN_PIN.items():
        check(fields[k] == v, f"dry run {DRYRUN_CELL}: {k} {fields[k]} != "
                              f"{v}")
    rec = {"cell": "/".join(DRYRUN_CELL), "child_s": wall,
           "waited_s": waited, "trace_s": art["trace_s"],
           "collective_bytes": art["collective_bytes"],
           "peak_live_bytes": art["memory_analysis"]["peak_live_bytes"],
           "bottleneck": art["roofline"]["bottleneck"], **DRYRUN_PIN}
    log(f"phase 14 (dry run {'/'.join(DRYRUN_CELL)}): the child {wall:.1f} "
        f"s (trace {art['trace_s']} s), waited {waited:.1f} s after the "
        f"build; {json.dumps(rec)}")
    return rec, wall, waited


def phase_cells(card: str) -> tuple:
    """Phase 13: the dry-run cells on the card (codeqwen1.5-7b and
    mamba2-2.7b at their widths cut to ``CELL_LAYERS``, whisper-base
    whole) and the placement summary on the host.  Returns (launches by
    path, records, wall seconds)."""
    t0 = time.perf_counter()
    counts, recs = {}, {}
    t = time.perf_counter()
    recs["placements"] = placement_summary()
    recs["placements_s"] = time.perf_counter() - t
    log(json.dumps({"placements": recs["placements"]}))
    dense = dataclasses.replace(codeqwen1p5_7b.config(),
                                num_layers=CELL_LAYERS)
    ssm = dataclasses.replace(mamba2_2p7b.config(), num_layers=CELL_LAYERS)
    audio = whisper_base.config()
    for name, cfg, seq, serve in (
            (f"codeqwen1.5-7b ({CELL_LAYERS} layers)", dense,
             CELL_RUN["seq"], True),
            (f"mamba2-2.7b ({CELL_LAYERS} layers)", ssm, CELL_RUN["seq"],
             False),
            ("whisper-base", audio, CELL_ENCDEC_TOKENS, True)):
        c, recs[name] = cell_train_pair(name, cfg, seq, CELL_RUN["batch"],
                                        card)
        counts.update(c)
        if serve:
            c, recs[name]["serving"] = cell_serving(
                name, cfg, seq, CELL_RUN["batch"], card)
            counts.update(c)
    wall = time.perf_counter() - t0
    log(f"phase 13 (dry-run cells): {wall:.1f} s")
    return counts, recs, wall


class PhaseClock:
    """Wall seconds from one ``mark`` to the next and, of them, the ring
    snapshot checks' (``snapshot_matches_device``), logged and kept by
    phase name."""

    def __init__(self):
        self.rows: dict = {}
        self._t, self._c = time.perf_counter(), snapshot_check_s[0]

    def mark(self, name: str) -> None:
        t, c = time.perf_counter(), snapshot_check_s[0]
        self.rows[name] = dict(wall_s=t - self._t,
                               snapshot_checks_s=c - self._c)
        log(f"[clock] {name}: {t - self._t:.1f} s, of which ring snapshot "
            f"checks {c - self._c:.1f} s")
        self._t, self._c = t, c


def main() -> None:
    clock = PhaseClock()
    card = phase_device()
    tmp = _build.BUILD_ROOT.parent / "chip_smoke_dryrun"
    shutil.rmtree(tmp, ignore_errors=True)
    dry = phase_dryrun_start(tmp)        # phase 14, beside the build
    try:
        pipes = phase_build()
        clock.mark("phases 1-2 (device, build, SASS)")
        dryrun, dryrun_s, _ = phase_dryrun_finish(*dry, tmp)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
        shutil.rmtree(tmp, ignore_errors=True)
    clock.mark("phase 14 (dry run, after the build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = {**kernel_rmsnorm(gen), **kernel_flash(gen)}
    recs["rmsnorm"]["routes_max_abs_err"] = kernel_rmsnorm_routes(gen)
    recs["rmsnorm"]["route_sweep"] = rmsnorm_route_sweep(gen)
    recs["rmsnorm"]["launch_cost"] = rmsnorm_launch_cost(gen)
    cfg = codeqwen1p5_7b.config()
    # the larger stage of the dense phase: one layer + the head
    stage = cfg._block_params("attn") + cfg.d_model * cfg.vocab_size \
        + cfg.d_model
    recs["fused_adam"] = kernel_adam(gen, stage)
    recs.update(kernel_ssd(gen))
    torch.cuda.empty_cache()
    for route, rec in kernel_ssd_final_state(gen).items():
        recs[route].update(rec)
    torch.cuda.empty_cache()
    recs["threefry_dropout"] = kernel_dropout(gen)
    for dt, (alu, mad) in pipes.items():
        tag = "" if dt == "bf16" else "float32_"
        recs["threefry_dropout"].update({
            f"{tag}sass_alu_pipe_per_element": alu,
            f"{tag}sass_multiply_add_pipe_per_element": mad})
    torch.cuda.empty_cache()
    clock.mark("phase 3 (kernels)")
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
    # the MoE family: moe at the default capacity factor 1.25 (tokens
    # drop), moe with row dispatch, hybrid (attention, Mamba2 and MoE
    # blocks: the 3xTF32 flash and CUDA-core SSD routes)
    tiny_moe = {}
    for family, twin in MOE_TWINS:
        counts = phase_tiny_twin(family, twin)
        ssd = family == "hybrid"
        check(counts["flash_attention_tf32"] > 0
              and (counts["ssd_scan"] > 0) == ssd
              and all(counts[k] == 0 for k in (
                  "flash_attention", "flash_attention_sm90",
                  "flash_attention_bf16_mma", "ssd_scan_sm90",
                  "ssd_scan_sm90_f32")),
              f"tiny {family} twin ({twin}) must take the 3xTF32 flash "
              f"route{' and the CUDA-core SSD route' if ssd else ''} only: "
              f"{counts}")
        tiny_moe[(family, twin)] = counts
    tiny_mla = phase_tiny_twin("moe", "mla")
    check(tiny_mla == MLA_TWIN_LAUNCHES, f"tiny MLA twin: launches "
                                         f"{tiny_mla} != {MLA_TWIN_LAUNCHES}")
    # the enc-dec and vlm families' whole-model losses and gradients
    loss_twins = {family: phase_loss_twin(family)
                  for family in ("audio", "vlm")}
    twin_dense = phase_tiny_recovery_twin("dense")
    check(twin_dense["flash_attention_tf32"] > 0
          and twin_dense["flash_attention"] == 0
          and twin_dense["flash_attention_sm90"] == 0,
          f"tiny dense recovery twin (float32) must take the 3xTF32 flash "
          f"route only: {twin_dense}")
    # MoE under fail-stop, as the reference tests it
    # (tests/test_cluster_elastic.py: capacity factor 16, so that routing
    # does not depend on which samples share an item)
    twin_moe = phase_tiny_recovery_twin("moe", capacity_factor=16.0)
    check(twin_moe["flash_attention_tf32"] > 0 and twin_moe["ssd_scan"] == 0
          and twin_moe["flash_attention_sm90"] == 0,
          f"tiny moe recovery twin (float32) must take the 3xTF32 flash "
          f"route only: {twin_moe}")
    # the seed path (fast_path=False) on the card beside the fast twins of
    # ssm and of dense at dropout 0.1, bit for bit
    twin_ssm = phase_tiny_recovery_twin("ssm", seed_twin=True)
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
    twin_drop = phase_tiny_recovery_twin("dense", dropout_rate=DROPOUT_RATE,
                                         seed_twin=True)
    want = {**twin_dense,
            "threefry_dropout": DROPOUT_TWIN_LAUNCHES["dense recovery"]}
    check(twin_drop == want, f"tiny dense recovery twin (dropout): launches "
                             f"{twin_drop} != {want}")
    for name, errs in kernel_path_shapes(gen).items():
        recs[name].update(errs)
    torch.cuda.empty_cache()
    clock.mark("phase 4 (tiny twins, path shapes)")
    log(f"[clock] phase 4's seed-path twins (ssm, dense at dropout 0.1): "
        f"{seed_twin_s[0]:.1f} s of phase 4's time")
    # the dense train step without dropout, one step (cut from 2 for the
    # serving phase's time)
    paths = {"codeqwen1.5-7b": phase_train(
        dataclasses.replace(cfg, num_layers=2), DENSE_STEP_LAUNCHES,
        steps=1)[0]}
    gc.collect()                 # free the dense cluster's host and card state
    torch.cuda.empty_cache()
    clock.mark("phase 5 (codeqwen step)")
    # the same model at dropout 0.1, samples' streams addressed by their
    # global ids, 1 step (cut from 2 for phase 12's time), profiled
    paths["codeqwen1.5-7b dropout 0.1"] = phase_train(
        dataclasses.replace(cfg, num_layers=2, dropout_rate=DROPOUT_RATE),
        DENSE_DROPOUT_STEP_LAUNCHES, steps=1, profile_step=0,
        rng_mode="reshard")[0]
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("phase 5 (codeqwen at dropout 0.1)")
    paths["mamba2-2.7b"], ssm, _ = phase_train(
        dataclasses.replace(mamba2_2p7b.config(), num_layers=4), SSM_LAUNCHES,
        steps=2, hw=H100_HW)
    clock.mark("phase 6 (mamba2 steps)")
    paths["mamba2-2.7b recovery"], recoveries = phase_recovery(ssm)
    del ssm
    gc.collect()           # free the bf16 mamba2 cluster's host and card state
    torch.cuda.empty_cache()
    clock.mark("phase 7 (recovery)")
    # the float32 mamba2 step and its seed-path twin
    f32_paths, seed_step = phase_float32()
    paths.update(f32_paths)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("phase 8 (mamba2 float32)")
    scenario_paths, scenarios, scenario_s = phase_scenarios()
    paths.update(scenario_paths)
    clock.mark("phase 9 (scenarios)")
    fuzz_paths, fuzz_runs, fuzz_s = phase_fuzz()
    paths.update(fuzz_paths)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("phase 10 (fuzzer)")
    serve_paths, serving, serve_s = phase_serve()
    paths.update(serve_paths)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("phase 11 (serving)")
    tmp = _build.BUILD_ROOT.parent / "chip_smoke_launcher"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        launcher_paths, launcher, launcher_s = phase_launcher(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths.update(launcher_paths)
    clock.mark("phase 12 (launcher)")
    cell_paths, cells, cells_s = phase_cells(card)
    paths.update(cell_paths)
    clock.mark("phase 13 (dry-run cells)")
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
             f"dropout {DROPOUT_RATE})", twin_drop),
            *(("flash_attention_tf32", f"tiny-{f} twin ({t})", counts)
              for (f, t), counts in tiny_moe.items()),
            ("ssd_scan", "tiny-hybrid twin (float32)",
             tiny_moe[("hybrid", "float32")]),
            ("flash_attention_tf32", "tiny-moe recovery twin (float32)",
             twin_moe),
            ("rmsnorm", "tiny MLA twin (float32)", tiny_mla),
            ("fused_adam", "tiny MLA twin (float32)", tiny_mla),
            *((name, f"tiny {family} loss twin (float32)", counts)
              for family, counts in loss_twins.items()
              for name in ("rmsnorm", "flash_attention_tf32"))):
        by_name[name]["launches_by_path"][path] = counts[name]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"recoveries": recoveries}))
    log(json.dumps({"seed_path": seed_step}))
    log(json.dumps({"scenarios": scenarios, "phase_s": scenario_s}))
    log(json.dumps({"fuzz": fuzz_runs, "phase_s": fuzz_s}))
    log(json.dumps({"serving": serving, "phase_s": serve_s}))
    log(json.dumps({"launcher": launcher, "phase_s": launcher_s}))
    log(json.dumps({"dryrun_cells": cells, "phase_s": cells_s}))
    log(json.dumps({"dryrun": dryrun, "phase_s": dryrun_s}))
    log(json.dumps({"phases": clock.rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
