"""The dry run of the port: every (arch x shape x mesh) cell's step on meta
``DTensor``s, counted per device, mirroring ``repro.launch.dryrun``.

For each cell:
  a fake process group of 256 (single) or 512 (multi) ranks, one process
  mesh = make_production_mesh(..., device_type="cpu")
  args = DTensor.from_local(<meta local shard>) of every meta argument
  with implicit_replication(), DeviceCounter():
      cell.fn(*args)
  -> artifact JSON

Nothing is allocated and no kernel launches: every tensor is on the meta
device, where the kernel wrappers take their plain versions
(``kernels/ops.py``), so the counts are of those plain versions.  The
counter (``launch/hlo_analysis.py``) sees the local ops DTensor runs on one
device (rank 0) and the collectives it runs.

The reference reads per-device counts off XLA's compiled program and undoes
its count-the-scan-body-once by extrapolating over two reduced depths.  The
port has no scan (layers are a Python loop), so the extrapolation over the
same two depths (:func:`_layer_variants`) is exact: depth enters linearly,
and a test holds it to a direct full-depth count.  ``memory_analysis``
gives ``argument_size_in_bytes`` and ``output_size_in_bytes`` from the
full-depth cell's local shard shapes (no run needed) and, in place of
XLA's ``temp_size_in_bytes``, ``peak_live_bytes``: the arguments plus the
most op outputs alive at once over the run, extrapolated over the two
depths as the counts are.  ``trace_s`` (the two depths' runs) replaces
``lower_s`` and ``compile_s``.

Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``--tag``: ``artifacts/perf_torch/``; ``--out-dir`` names another
directory for either).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_405b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs 4]

Importing this module touches no process group and sets no environment
variable.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
PERF_DIR = ART_DIR.parent / "perf_torch"

MODEL_FLOPS_NOTE = ("MODEL_FLOPS = 6*N*D dense / 6*N_active*D MoE "
                    "(train); 2*N*D serving fwd")
COUNT_NOTE = ("per-device counts of the local ATen ops on meta DTensors "
              "(rank 0): FLOPs are torch.utils.flop_counter's (matrix "
              "products and attention; elementwise work uncounted); bytes "
              "are each op's local input and output bytes, unfused, an "
              "upper bound; the kernels' plain versions are what is counted")


def _layer_variants(cfg):
    """Two reduced-depth variants (L1, L2) whose cost difference isolates
    one repeat unit of the layer pattern, the reference's: the port's
    costs are linear in depth, so extrapolating over them is exact."""
    if cfg.is_encdec:
        c1 = dataclasses.replace(cfg, num_layers=1, encoder_layers=1,
                                 decoder_layers=1, scan_layers=False)
        c2 = dataclasses.replace(cfg, num_layers=2, encoder_layers=2,
                                 decoder_layers=2, scan_layers=False)
        return c1, c2, 1, 2, cfg.encoder_layers or cfg.num_layers
    period = 1
    if cfg.family == "hybrid":
        period = cfg.attn_period
    L1 = cfg.first_k_dense + period
    L2 = cfg.first_k_dense + 2 * period
    c1 = dataclasses.replace(cfg, num_layers=L1, scan_layers=False)
    c2 = dataclasses.replace(cfg, num_layers=L2, scan_layers=False)
    return c1, c2, L1, L2, cfg.num_layers


# --------------------------------------------------------------------------
# The fake world and the cell's arguments
# --------------------------------------------------------------------------
def init_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (rank 0),
    replacing one of another size.  DTensor caches its sharding decisions
    keyed by a mesh's shape and names, and a cached decision holds the
    mesh, and so the process groups, it was made under: the caches are
    cleared before a new group is made, so that none outlives its group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    prop = DTensor._op_dispatcher.sharding_propagator
    for clear in (getattr(prop.propagate_op_sharding, "cache_clear", None),
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None)):
        if clear is not None:
            clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(mesh_kind: str):
    """The ``DeviceMesh`` of ``mesh_kind`` ("single": (16, 16), "multi":
    (2, 16, 16)) over a fake process group of its size."""
    from repro_torch.launch.mesh import (make_production_mesh,
                                         production_mesh_shape)
    multi = mesh_kind == "multi"
    init_fake_world(math.prod(production_mesh_shape(multi).sizes))
    return make_production_mesh(multi_pod=multi, device_type="cpu")


def _local_shape(mesh, shape, spec):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.parallel.sharding import to_placements
    pl = to_placements(mesh, spec)
    return compute_local_shape_and_global_offset(tuple(shape), mesh, pl)[0], pl


def to_dtensors(mesh, shapes, specs):
    """Each meta tensor of ``shapes`` as a ``DTensor`` of its spec in
    ``specs`` (a tree of the same structure), its local shard a meta
    tensor; other leaves (the AdamW step, an int) as they are."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import map_with_path
    from repro_torch.tree import at

    def leaf(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        local, pl = _local_shape(mesh, t.shape, at(specs, path))
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())

    return map_with_path(leaf, shapes)


def local_bytes(mesh, shapes, specs) -> int:
    """Bytes of one device's shards of the meta tensors of ``shapes``."""
    import torch
    from repro_torch.tree import at, leaves_with_paths
    total = 0
    for path, t in leaves_with_paths(shapes):
        if isinstance(t, torch.Tensor):
            local, _ = _local_shape(mesh, t.shape, at(specs, path))
            total += math.prod(local) * t.element_size()
    return total


def _output_shapes(cfg, cell, batch: int):
    """The meta shapes of a cell's outputs: the train step's updated
    parameters and AdamW state and its float32 loss; a serving step's
    logits [batch, 1, vocab] in the model's dtype and its caches."""
    import torch
    if cell.kind == "train":
        params, opt, _ = cell.arg_shapes
        return (params, opt, torch.empty((), dtype=torch.float32,
                                         device="meta"))
    logits = torch.empty((batch, 1, cfg.vocab_size), dtype=cfg.torch_dtype,
                         device="meta")
    return (logits, cell.arg_shapes[1])


# --------------------------------------------------------------------------
# Counting
# --------------------------------------------------------------------------
def count_cell(cfg, shape_name: str, seq: int, batch: int, mesh,
               remat: bool = True) -> Dict[str, Any]:
    """One device's counts of ``cfg``'s cell at its own depth: ``flops``,
    ``bytes``, ``coll`` (total collective operand bytes), ``coll_by_kind``,
    ``peak_live`` (arguments plus the most op outputs alive at once) and
    ``seconds``."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels import _build
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch.steps import build_cell

    t0 = time.time()
    cell = build_cell(cfg, shape_name, seq, batch, mesh, remat=remat)
    args = to_dtensors(mesh, cell.arg_shapes, cell.arg_pspecs)
    launches = dict(_build.LAUNCHES)
    with implicit_replication(), H.DeviceCounter() as c:
        out = cell.fn(*args)
    del out, args
    if dict(_build.LAUNCHES) != launches:
        raise RuntimeError("a kernel launched during a dry run")
    coll = c.collective_bytes()
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "coll": coll["total"], "coll_by_kind": coll,
            "peak_live": float(local_bytes(mesh, cell.arg_shapes,
                                           cell.arg_pspecs) + c.peak_live),
            "seconds": time.time() - t0}


def extrapolated_costs(cfg, shape_name: str, seq: int, batch: int, mesh,
                       remat: bool = True) -> Dict[str, Any]:
    """Per-device (flops, bytes, collective bytes, peak live bytes) at
    full depth, by linear extrapolation over the two reduced depths of
    :func:`_layer_variants` (exact: depth enters linearly)."""
    c1, c2, L1, L2, Lf = _layer_variants(cfg)
    a = count_cell(c1, shape_name, seq, batch, mesh, remat=remat)
    b = count_cell(c2, shape_name, seq, batch, mesh, remat=remat)

    def ext(x, y):
        return x + (y - x) / (L2 - L1) * (Lf - L1)

    out = {k: ext(a[k], b[k]) for k in ("flops", "bytes", "coll",
                                          "peak_live")}
    out["coll_by_kind"] = {k: ext(a["coll_by_kind"][k], b["coll_by_kind"][k])
                           for k in a["coll_by_kind"]}
    out["trace_s"] = a["seconds"] + b["seconds"]
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: Optional[dict] = None) -> dict:
    """The artifact of one cell (the reference's keys; see the module
    docstring for what the port counts in place of XLA's analyses)."""
    from repro_torch import configs
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch.steps import build_cell, shape_kind

    cfg = configs.get_config(arch)
    shapes = {n: (s, b) for n, s, b in cfg.shapes}
    skip = {n: why for n, why in cfg.skip_shapes}
    if shape_name in skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": skip[shape_name]}
    seq, batch = shapes[shape_name]
    mesh = production_mesh(mesh_kind)
    chips = mesh.size()
    remat = True
    if overrides:
        overrides = dict(overrides)
        remat = overrides.pop("remat", True)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)

    # the full-depth cell's arguments and outputs, from its shard shapes
    cell = build_cell(cfg, shape_name, seq, batch, mesh, remat=remat)
    mem = {"argument_size_in_bytes": local_bytes(mesh, cell.arg_shapes,
                                                 cell.arg_pspecs),
           "output_size_in_bytes": local_bytes(
               mesh, _output_shapes(cfg, cell, batch), cell.out_pspecs)}
    del cell
    ext = extrapolated_costs(cfg, shape_name, seq, batch, mesh, remat=remat)
    mem["peak_live_bytes"] = ext["peak_live"]
    flops = ext["flops"]
    terms = H.roofline_terms(flops, ext["bytes"], ext["coll"], chips=1)

    kind = shape_kind(shape_name)
    n_active = cfg.active_param_count()
    tokens = batch * seq if kind != "decode" else batch
    model_flops = (6 if kind == "train" else 2) * n_active * tokens
    n_total = cfg.param_count()
    state_bytes = n_total * (2 + 12 if kind == "train" else 2)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips,
        "status": "ok", "kind": kind,
        "seq": seq, "batch": batch,
        "trace_s": round(ext["trace_s"], 2),
        "memory_analysis": mem,
        "cost_analysis": {"flops": flops, "bytes accessed": ext["bytes"]},
        "collective_bytes": ext["coll_by_kind"],
        "roofline": terms,
        "model_flops": model_flops,
        "hlo_flops_per_device": flops,
        "hlo_flops_global": flops * chips,
        "useful_fraction": model_flops / (flops * chips) if flops else None,
        "params_total": n_total, "params_active": n_active,
        "state_bytes_per_chip": state_bytes / chips,
        "note": f"{MODEL_FLOPS_NOTE}; {COUNT_NOTE}",
    }


def cell_list(mesh_kinds):
    from repro_torch import configs
    cells = []
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for (name, _, _) in cfg.shapes:
            for mk in mesh_kinds:
                cells.append((arch, name, mk))
    return cells


def _parse_override(ov: str):
    k, v = ov.split("=", 1)
    if v.lower() in ("true", "false"):
        return k, v.lower() == "true"
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    return k, v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override key=value (perf iterations); "
                         "also accepts remat=false")
    ap.add_argument("--tag", default=None,
                    help="artifact tag: writes to artifacts/perf_torch/ "
                         "instead")
    ap.add_argument("--out-dir", default=None,
                    help="artifact directory, tagged or not (default "
                         "artifacts/dryrun_torch/, artifacts/perf_torch/ "
                         "with --tag)")
    args = ap.parse_args(argv)
    art_dir = Path(args.out_dir) if args.out_dir else \
        PERF_DIR if args.tag and not args.all else ART_DIR
    art_dir.mkdir(parents=True, exist_ok=True)

    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are needed without --all")
        overrides = dict(_parse_override(ov) for ov in args.override)
        art = run_cell(args.arch, args.shape, mesh_kinds[0],
                       overrides=overrides or None)
        if args.tag:
            art["tag"] = args.tag
            art["overrides"] = {k: str(v) for k, v in overrides.items()}
            out = art_dir / (f"{args.arch}__{args.shape}__{mesh_kinds[0]}"
                             f"__{args.tag}.json")
        else:
            out = art_dir / f"{args.arch}__{args.shape}__{mesh_kinds[0]}.json"
        out.write_text(json.dumps(art, indent=2))
        print(json.dumps(art, indent=2))
        if art["status"] == "ok":
            print(f"OK {args.arch} {args.shape} {mesh_kinds[0]} "
                  f"bottleneck={art['roofline']['bottleneck']}")
        return art

    # one subprocess a cell: each builds its own fake process group
    cells = cell_list(mesh_kinds)
    pending = []
    for (arch, shape, mk) in cells:
        out = art_dir / f"{arch}__{shape}__{mk}.json"
        if out.exists() and not args.force:
            continue
        pending.append((arch, shape, mk, out))
    print(f"{len(pending)} cells to run ({len(cells) - len(pending)} cached)",
          flush=True)
    procs = []

    def launch(arch, shape, mk, out):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mk,
               "--out-dir", str(art_dir)]
        log = out.with_suffix(".log").open("w")
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), \
            (arch, shape, mk, out)

    i, failed = 0, 0
    while i < len(pending) or procs:
        while i < len(pending) and len(procs) < args.jobs:
            procs.append(launch(*pending[i]))
            i += 1
        done = [p for p in procs if p[0].poll() is not None]
        for p, meta in done:
            procs.remove((p, meta))
            ok = p.returncode == 0 and meta[3].exists()
            failed += not ok
            status = "OK" if ok else f"FAIL(rc={p.returncode})"
            print(f"[{status}] {meta[0]} {meta[1]} {meta[2]}", flush=True)
        time.sleep(0.2)
    if failed:
        raise SystemExit(f"{failed} cells failed")


if __name__ == "__main__":
    main()
