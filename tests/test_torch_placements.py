"""DTensor placements of the production layout on a fake process group.

In a subprocess (no process-group state reaches the test worker), a fake
process group of 256 ranks builds the (16, 16) mesh and one of 512 the
(2, 16, 16) mesh (``launch/mesh.make_production_mesh`` on ``"cpu"``).  For
every parameter leaf of llama3-405b, deepseek-v3-671b and whisper-base
(meta tensors, full size), ``sharding.to_placements`` of its spec gives a
``DTensor`` (``from_local`` of a meta shard) whose global shape is the
leaf's; its local shape is the leaf's divided by the product of each
dim's mesh axes in the reference's spec (``repro.parallel.sharding``, on
the reference's stacked tree without the leading layer axis), and the
shard's offset on one rank is the reference's: a dim split over
``("pod", "data")`` takes block ``pod * 16 + data``.  The specs taken on
the ``DeviceMesh`` equal those taken on the ``MeshShape``.

Also: importing ``launch/mesh.py`` and ``parallel/sharding.py``
initialises no process group and imports no jax; ``make_mesh`` raises
without a process group and on a world size that is not the mesh's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

import _torch_stacked as ST  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama3_405b", "deepseek_v3_671b", "whisper_base")
# the rank whose shards are checked: inside the mesh, no coordinate 0
RANKS = {256: 37, 512: 301}

_PROBE = r"""
import json, sys
sys.path.insert(0, "src")
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch import configs
from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
from repro_torch.models import registry as R
from repro_torch.parallel import sharding as S
from repro_torch.tree import leaves_with_paths

world, rank = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("fake", store=FakeStore(), rank=rank,
                        world_size=world)
multi = world == 512
mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
out = {"coordinate": list(mesh.get_coordinate()),
       "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "archs": {}}
for arch in sys.argv[3:]:
    cfg = configs.get_config(arch)
    shapes = R.model_param_shapes(cfg)
    specs = S.param_pspecs(cfg, mesh, shapes)
    same = specs == S.param_pspecs(cfg, production_mesh_shape(multi), shapes)
    leaves = {}
    for (path, leaf), (_, spec) in zip(leaves_with_paths(shapes),
                                       S.spec_leaves(specs)):
        pl = S.to_placements(mesh, spec)
        shape = tuple(leaf.shape)
        local, offset = compute_local_shape_and_global_offset(shape, mesh, pl)
        dt = DTensor.from_local(torch.empty(local, dtype=leaf.dtype,
                                            device="meta"),
                                mesh, pl, run_check=False)
        leaves["/".join(map(str, path))] = dict(
            shape=list(shape), global_shape=list(dt.shape),
            local=list(dt.to_local().shape), computed_local=list(local),
            offset=list(offset), placements=[str(p) for p in pl],
            meta=dt.to_local().device.type == "meta")
    out["archs"][arch] = dict(same_on_mesh_shape=same, leaves=leaves)
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module", params=sorted(RANKS))
def probe(request):
    world = request.param
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, str(world), str(RANKS[world]),
         *ARCHS], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return world, json.loads(res.stdout.strip().splitlines()[-1])


def _ref_specs(arch, multi_pod):
    cfg = configs.get_config(arch)
    _, fm = ST.meshes(multi_pod)
    jcfg = jconfigs.get_config(arch)
    ref = JS.param_pspecs(jcfg, fm, JR.model_param_shapes(jcfg))
    port = ST.specs(ST.params_to_port(cfg, ref, ST.strip_spec, ST.keep_spec))
    return {"/".join(map(str, k)): v for k, v in port.items()}, fm.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_dtensor_shapes_match_reference_specs(probe, arch):
    world, out = probe
    multi = world == 512
    ref, sizes = _ref_specs(arch, multi)
    assert out["mesh"] == sizes
    coord = dict(zip(sizes, out["coordinate"]))
    got = out["archs"][arch]
    assert got["same_on_mesh_shape"]
    assert got["leaves"].keys() == ref.keys()
    sharded = 0
    for path, spec in ref.items():
        leaf = got["leaves"][path]
        assert leaf["meta"] and leaf["global_shape"] == leaf["shape"], path
        local, offset = [], []
        for size, entry in zip(leaf["shape"], spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n, block = 1, 0
            for a in axes:                   # the first axis major
                n, block = n * sizes[a], block * sizes[a] + coord[a]
            assert size % n == 0, (path, spec)
            local.append(size // n)
            offset.append(block * (size // n))
        assert leaf["local"] == local == leaf["computed_local"], (path, spec)
        assert leaf["offset"] == offset, (path, spec, leaf["placements"])
        sharded += local != leaf["shape"]
    assert sharded > len(ref) // 3


def test_imports_touch_no_process_group_and_no_jax():
    code = ("import sys; sys.path.insert(0, 'src');"
            "import repro_torch.launch.mesh, repro_torch.parallel.sharding;"
            "import torch.distributed as dist;"
            "print(dist.is_initialized(), sorted(k for k in sys.modules if"
            " k in ('jax', 'repro') or k.startswith(('jax.', 'repro.'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False []"


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        M.make_production_mesh(device_type="cpu")


def test_make_mesh_checks_the_world_size():
    code = ("import sys; sys.path.insert(0, 'src');"
            "import torch.distributed as dist;"
            "from torch.testing._internal.distributed.fake_pg import "
            "FakeStore;"
            "dist.init_process_group('fake', store=FakeStore(), rank=0, "
            "world_size=256);"
            "from repro_torch.launch.mesh import make_production_mesh;"
            "make_production_mesh(multi_pod=True, device_type='cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "the process group has 256 ranks" in res.stderr


def test_to_placements_orders():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel.sharding import Spec, to_placements
    m = M.production_mesh_shape(True)
    assert to_placements(m, Spec((("pod", "data"), "model"))) == [
        Shard(0), Shard(0), Shard(1)]
    assert to_placements(m, Spec((None, "data"))) == [
        Replicate(), Shard(1), Replicate()]
    for bad in (Spec((("data", "pod"),)), Spec(("data", "data")),
                Spec(("expert",))):
        with pytest.raises(ValueError):
            to_placements(m, bad)
