"""Shared code of the dry-run tests (tests/test_torch_dryrun*.py; not
collected): a module fixture that runs the tests of one file over a fake
process group and tears it down after, so that no process-group state
outlives the file on its worker, the reference's closed-form artifact
fields from the JAX package's configs (no compile), and the reference's
own artifact of a cell, compiled in a subprocess."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
EXACT = ("model_flops", "params_total", "params_active",
         "state_bytes_per_chip", "chips", "kind", "seq", "batch")
# XLA's output_size_in_bytes holds the output tuple's table, 8 bytes a
# leaf of the flattened output (3 on a decode cell, 50 on codeqwen's
# train cell), beside the leaves' own bytes
XLA_TUPLE_BYTES_PER_LEAF = 8


@pytest.fixture(scope="module")
def world():
    """The dry run's ``production_mesh``, fake process group torn down at
    the end of the module."""
    from repro_torch.launch import dryrun as D
    assert not dist.is_initialized()
    yield D.production_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def reference_fields(arch: str, shape: str, mesh_kind: str) -> dict:
    """The fields the reference's ``run_cell`` computes in closed form
    (``repro/launch/dryrun.py``), from the JAX package's config."""
    from repro import configs as jconfigs
    cfg = jconfigs.get_config(arch)
    seq, batch = {n: (s, b) for n, s, b in cfg.shapes}[shape]
    kind = "train" if shape.startswith("train") else \
        "prefill" if shape.startswith("prefill") else "decode"
    chips = 512 if mesh_kind == "multi" else 256
    n_active, n_total = cfg.active_param_count(), cfg.param_count()
    tokens = batch * seq if kind != "decode" else batch
    return {"chips": chips, "kind": kind, "seq": seq, "batch": batch,
            "model_flops": (6 if kind == "train" else 2) * n_active * tokens,
            "params_total": n_total, "params_active": n_active,
            "state_bytes_per_chip":
                n_total * (2 + 12 if kind == "train" else 2) / chips}


def check_artifact(art: dict, arch: str, shape: str, mesh_kind: str):
    """An ok artifact of the cell: the reference's closed-form fields
    equal, per-device counts positive and consistent."""
    assert art["status"] == "ok", art
    for k, v in reference_fields(arch, shape, mesh_kind).items():
        assert art[k] == v, (k, art[k], v)
    r = art["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert art["hlo_flops_global"] == art["hlo_flops_per_device"] * \
        art["chips"]
    coll = art["collective_bytes"]
    assert coll["total"] == pytest.approx(
        sum(v for k, v in coll.items() if k != "total"))
    mem = art["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes"]
    assert art["useful_fraction"] == art["model_flops"] / \
        art["hlo_flops_global"]


def reference_artifact(arch: str, shape: str) -> dict:
    """``repro.launch.dryrun.run_cell(arch, shape, "single")`` in a
    subprocess (the module sets ``XLA_FLAGS`` when imported;
    ``DRYRUN_XLA_FLAGS`` gives 256 placeholder devices), with
    ``out_leaves``: the leaves of the compiled step's flattened output."""
    code = ("import json, sys; sys.path.insert(0, 'src')\n"
            "import jax\n"
            "from jax.sharding import PartitionSpec as P\n"
            "from repro import configs\n"
            "from repro.launch import dryrun as D\n"
            "from repro.launch.mesh import make_production_mesh\n"
            "from repro.launch.steps import build_cell\n"
            f"art = D.run_cell({arch!r}, {shape!r}, 'single')\n"
            f"cfg = configs.get_config({arch!r})\n"
            f"seq, b = {{n: (s, bb) for n, s, bb in cfg.shapes}}[{shape!r}]\n"
            f"cell = build_cell(cfg, {shape!r}, seq, b, "
            "make_production_mesh(multi_pod=False))\n"
            "art['out_leaves'] = len(jax.tree_util.tree_leaves(\n"
            "    cell.out_pspecs, is_leaf=lambda x: isinstance(x, P)))\n"
            "print(json.dumps(art))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=256")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def check_against_reference(got: dict, ref: dict, flop_ratio,
                            unread_argument_bytes: int,
                            output_extra: int = 0) -> float:
    """The port's artifact ``got`` against the reference's ``ref``: the
    closed-form fields equal; argument bytes equal but for the reference's
    unread arguments (``unread_argument_bytes``, the port's more) and
    output bytes but for XLA's tuple table and ``output_extra`` (the
    reference's more); the FLOP ratio port / reference within
    ``flop_ratio``.  Returns the ratio."""
    assert ref["status"] == got["status"] == "ok"
    for k in EXACT:
        assert got[k] == ref[k], (k, got[k], ref[k])
    gm, rm = got["memory_analysis"], ref["memory_analysis"]
    assert gm["argument_size_in_bytes"] - rm["argument_size_in_bytes"] == \
        unread_argument_bytes
    assert rm["output_size_in_bytes"] - gm["output_size_in_bytes"] == \
        XLA_TUPLE_BYTES_PER_LEAF * ref["out_leaves"] + output_extra
    ratio = got["hlo_flops_per_device"] / ref["hlo_flops_per_device"]
    assert flop_ratio[0] <= ratio <= flop_ratio[1], ratio
    assert set(got["collective_bytes"]) == set(ref["collective_bytes"])
    assert set(got["roofline"]) == set(ref["roofline"])
    return ratio
