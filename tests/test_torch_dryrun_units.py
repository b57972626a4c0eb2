"""The dry run's counter and its entry point (``launch/hlo_analysis.py``,
``launch/dryrun.py``) on a fake process group, and the DTensor-aware model
helpers (``parallel/dtensor.py``) on plain tensors.

* Counts are per device: the local product of a sharded matmul, not the
  global one; a ``Shard(0) -> Replicate()`` all-gather's operand is the
  local input; a shard-dim all-to-all, which the ``"cpu"`` mesh runs as
  all-gather + chunk, is counted as an all-to-all.
* ``roofline_terms`` with the reference's TPU constants passed gives the
  reference's terms; its defaults are the H100 data-sheet rates.
* The extrapolation over the two reduced depths equals a direct count at
  full depth; ``multi`` shards state below 0.75 x ``single``;
  ``seq_shard_acts`` turns the all-reduces into reduce-scatters and
  all-gathers; a constraint's gradient is constrained alike; no kernel
  launch counter moves during a dry run.
* Importing the modules initialises no process group and sets no
  environment variable; the cell list and its skips are the reference's.
* Each DTensor-aware helper is the plain operation, bit for bit, on plain
  tensors.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_analysis as JH
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.parallel import dtensor as DT

from _torch_dryrun import world  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _dt(mesh, shape, placements, dtype=torch.bfloat16):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_matmul_counts_the_local_product(world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = world("single")
    x = _dt(mesh, (64, 1024, 8192), [Shard(0), Replicate()])
    w = _dt(mesh, (8192, 28672), [Replicate(), Shard(1)])
    with H.DeviceCounter() as c:
        y = x @ w
    assert c.flops == 2 * 4 * 1024 * 8192 * 1792 == 120_259_084_288
    assert c.flops != 2 * 64 * 1024 * 8192 * 28672      # the global op
    assert tuple(y.to_local().shape) == (4, 1024, 1792)
    assert c.collective_bytes()["total"] == 0


def test_all_gather_operand_is_the_local_input(world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = world("single")
    a = _dt(mesh, (1024, 1024), [Replicate(), Shard(0)])
    with H.DeviceCounter() as c:
        a.redistribute(mesh, [Replicate(), Replicate()])
    coll = c.collective_bytes()
    assert coll["all-gather"] == 131_072 == 1024 * 1024 * 2 / 16
    assert coll["total"] == 131_072


def test_cpu_mesh_all_to_all_counted_as_all_to_all(world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = world("single")
    a = _dt(mesh, (1024, 1024), [Replicate(), Shard(0)])
    with H.DeviceCounter() as c:
        a.redistribute(mesh, [Replicate(), Shard(1)])
    coll = c.collective_bytes()
    assert coll["all-to-all"] == 131_072 and coll["all-gather"] == 0


def test_constrain_reduces_a_partial_gradient(world):
    """The gradient of a constrained tensor is constrained alike (JAX's
    transpose of a sharding constraint): a tensor-parallel partial sum
    arriving in the backward is all-reduced there, where DTensor's own
    redistribute would pass it on as a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = world("single")
    x = _dt(mesh, (256, 64, 512), [Shard(0), Partial()], torch.float32)
    x.requires_grad_(True)
    y = DT.constrain(x, "dp", None, None)
    assert list(y.placements) == [Shard(0), Replicate()]
    g = _dt(mesh, (256, 64, 512), [Shard(0), Partial()], torch.float32)
    with H.DeviceCounter() as c:
        y.backward(g)
    assert list(x.grad.placements) == [Shard(0), Replicate()]
    assert c.collective_bytes()["all-reduce"] == 16 * 64 * 512 * 4


def test_roofline_terms_reference_constants():
    kw = dict(flops=197e12, bytes_accessed=819e9 * 2, coll_bytes=50e9,
              chips=1)
    got = H.roofline_terms(**kw, peak_flops=197e12, hbm_bw=819e9,
                           link_bw=50e9)
    assert got == JH.roofline_terms(**kw)
    assert got["bottleneck"] == "memory"
    # the defaults are the H100's data-sheet rates
    h = H.roofline_terms(989e12, 3.35e12, 50e9, chips=1)
    assert h["compute_s"] == 1.0 and h["memory_s"] == 1.0
    assert h["collective_s"] == 1.0


def test_extrapolation_equals_a_full_depth_count(world):
    mesh = world("single")
    cfg = configs.get_config("whisper_base")
    ext = D.extrapolated_costs(cfg, "decode_32k", 32768, 128, mesh)
    full = D.count_cell(dataclasses.replace(cfg, scan_layers=False),
                        "decode_32k", 32768, 128, mesh)
    for k in ("flops", "bytes", "coll"):
        assert ext[k] == full[k], k
    assert ext["coll_by_kind"] == full["coll_by_kind"]


def test_layer_variants_are_the_references():
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        c1, c2, L1, L2, Lf = D._layer_variants(cfg)
        if cfg.is_encdec:
            assert (L1, L2, Lf) == (1, 2, cfg.encoder_layers)
            assert c2.decoder_layers == 2 and c2.encoder_layers == 2
        else:
            period = cfg.attn_period if cfg.family == "hybrid" else 1
            assert (L1, L2) == (cfg.first_k_dense + period,
                                cfg.first_k_dense + 2 * period)
            assert Lf == cfg.num_layers
        assert (c1.num_layers, c2.num_layers) == (L1, L2)
        assert not c1.scan_layers and not c2.scan_layers


@pytest.mark.parametrize("arch", ["llama3_405b", "deepseek_v3_671b",
                                  "deepseek_67b"])
def test_multi_pod_shards_state(world, arch):
    from repro_torch.launch.steps import build_cell
    cfg = configs.get_config(arch)
    got = {}
    for kind in ("single", "multi"):
        mesh = world(kind)
        cell = build_cell(cfg, "train_4k", 4096, 256, mesh)
        got[kind] = D.local_bytes(mesh, cell.arg_shapes, cell.arg_pspecs)
    assert got["multi"] < 0.75 * got["single"]


def test_seq_shard_acts_swaps_all_reduce_for_rs_and_ag(world):
    mesh = world("single")
    cfg = D._layer_variants(configs.get_config("codeqwen1p5_7b"))[0]
    kinds = {}
    for ss in (False, True):
        c = D.count_cell(dataclasses.replace(cfg, seq_shard_acts=ss),
                         "prefill_32k", 32768, 32, mesh)
        kinds[ss] = c["coll_by_kind"]
        assert c["flops"] > 0
    assert kinds[False]["all-reduce"] > 0
    assert kinds[False]["reduce-scatter"] == 0
    assert kinds[True]["all-reduce"] == 0
    assert kinds[True]["reduce-scatter"] == kinds[False]["all-reduce"]
    assert kinds[True]["all-gather"] > kinds[False]["all-gather"]


def test_no_launch_counter_moves(world, monkeypatch):
    """Every wrapper takes its plain version on meta: the launch counters
    stay as they are, and a launch would make count_cell raise."""
    mesh = world("single")
    cfg = D._layer_variants(configs.get_config("mamba2_2p7b"))[0]
    before = dict(_build.LAUNCHES)
    c = D.count_cell(cfg, "train_4k", 4096, 256, mesh)
    assert c["flops"] > 0 and dict(_build.LAUNCHES) == before
    monkeypatch.setitem(_build.LAUNCHES, "rmsnorm", 0)
    from repro_torch.kernels import ops
    real = ops.ref.rmsnorm_reference

    def launching(*a, **k):
        _build.LAUNCHES["rmsnorm"] += 1
        return real(*a, **k)

    monkeypatch.setattr(ops.ref, "rmsnorm_reference", launching)
    with pytest.raises(RuntimeError, match="launched during a dry run"):
        D.count_cell(cfg, "decode_32k", 32768, 128, mesh)


def test_import_touches_no_process_group_or_environment():
    code = ("import os, sys; sys.path.insert(0, 'src'); env = dict(os.environ)\n"
            "import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
            "import repro_torch.parallel.dtensor\n"
            "assert not dist.is_initialized()\n"
            "assert dict(os.environ) == env\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cell_list_and_skips_are_the_references():
    cells = D.cell_list(["single", "multi"])
    want = [(a, n, m) for a in jconfigs.ARCH_IDS
            for n, _, _ in jconfigs.get_config(a).shapes
            for m in ("single", "multi")]
    assert sorted(cells) == sorted(want) and len(cells) == 80
    for arch in configs.ARCH_IDS:
        assert configs.get_config(arch).skip_shapes == \
            jconfigs.get_config(arch).skip_shapes
        for name, why in configs.get_config(arch).skip_shapes:
            art = D.run_cell(arch, name, "single")
            assert art == {"arch": arch, "shape": name, "mesh": "single",
                           "status": "skipped", "reason": why}


def test_override_parsing():
    assert D._parse_override("remat=false") == ("remat", False)
    assert D._parse_override("seq_shard_acts=True") == \
        ("seq_shard_acts", True)
    assert D._parse_override("attn_chunk_q=256") == ("attn_chunk_q", 256)
    assert D._parse_override("capacity_factor=1.5") == \
        ("capacity_factor", 1.5)
    assert D._parse_override("dtype=float32") == ("dtype", "float32")


def test_tagged_run_writes_perf_artifact(world, tmp_path):
    """A tagged run writes into ``--out-dir`` when one is given (by
    default ``artifacts/perf_torch/``), nowhere else."""
    assert D.PERF_DIR == D.ART_DIR.parent / "perf_torch"
    art = D.main(["--arch", "mamba2_2p7b", "--shape", "decode_32k",
                  "--override", "remat=false", "--tag", "t1",
                  "--out-dir", str(tmp_path)])
    f = tmp_path / "mamba2_2p7b__decode_32k__single__t1.json"
    assert [p.name for p in tmp_path.iterdir()] == [f.name]
    saved = json.loads(f.read_text())
    assert saved["tag"] == "t1" and saved["overrides"] == {"remat": "False"}
    assert saved["hlo_flops_per_device"] == art["hlo_flops_per_device"] > 0


# --------------------------------------------------------------------------
# The DTensor-aware helpers are the plain operations on plain tensors
# --------------------------------------------------------------------------
def test_helpers_are_plain_on_plain_tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 24, generator=g)
    assert torch.equal(DT.split_last(x, 4, 6), x.reshape(2, 5, 4, 6))
    table = torch.randn(24, 3, generator=g)
    assert torch.equal(DT.merge_heads(x.reshape(2, 5, 4, 6)), x)
    assert DT.gather_dim(x, -1) is x
    assert DT.constrain(x, "dp", "model", None) is x
    assert DT.constrain_acts(x, True) is x
    labels = torch.randint(0, 24, (2, 5), generator=g)
    assert torch.equal(DT.embed_rows(table, labels), table[labels])
    assert torch.equal(DT.take_last(x, labels),
                       torch.gather(x, -1, labels[..., None])[..., 0])
    tree = {"a": [x, x[0]], "b": (x,)}
    out = DT.gather_axes(tree, ("data",))
    assert out["a"][0] is x and out["b"][0] is x
    q, k = torch.randn(2, 5, 4, 6), torch.randn(2, 5, 2, 6)
    seen = DT.per_head_shard(lambda *a: a, q, (k,), ((labels, 0, None),))
    assert seen[0] is q and seen[1] is k and seen[2] is labels
    assert not DT.is_dtensor(x)


def test_is_prefill_decides_from_what_is_passed():
    from repro_torch.models import layers as L
    assert L.is_prefill(0) and L.is_prefill(np.int64(0))
    assert not L.is_prefill(3) and not L.is_prefill(None)
    # a tensor index is a decode, whatever its value (a meta tensor has
    # none): the decode cells pass a 0-d one
    assert not L.is_prefill(torch.tensor(0))
    assert not L.is_prefill(torch.empty((), dtype=torch.int32,
                                        device="meta"))
    assert not L.is_prefill(torch.tensor([0, 4]))



def test_train_cell_multi_mesh_halves_the_work_a_device(world):
    """The multi mesh doubles the data-parallel ranks over the same
    model-parallel split, so one device's share of a train step's products
    halves exactly; a backward that gathered weights to meet unreduced
    partial sums broke this (llama3-405b's 3.3x)."""
    cfg, *_ = D._layer_variants(configs.get_config("llama3_405b"))
    single = D.count_cell(cfg, "train_4k", 4096, 256, world("single"))
    multi = D.count_cell(cfg, "train_4k", 4096, 256, world("multi"))
    assert single["flops"] == 2 * multi["flops"] > 0
