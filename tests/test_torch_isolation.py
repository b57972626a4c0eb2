"""The port stands alone: it, its chip smoke, its examples and its fuzz
soak script import neither jax nor the JAX package, its entry points (a
drawn fuzz workload's cluster too) default to the card, and no kernel
wrapper hands a CUDA tensor to its plain version."""
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.core.cluster import VirtualCluster
from repro_torch.models.registry import tiny_config
from repro_torch.scenarios import make_case
from repro_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import pkgutil, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    __import__(name)
import chip_smoke
import importlib.util
for path in ("examples/torch_quickstart.py", "examples/torch_elastic_train.py",
             "examples/torch_serve.py", "benchmarks/torch_fuzz_soak.py"):
    spec = importlib.util.spec_from_file_location(path.replace("/", "_"),
                                                  path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20
    assert bad.strip() == "[]"


def test_cluster_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VirtualCluster(tiny_config("dense", num_layers=2), 2, 2,
                       global_batch=8, num_micro=2, seq_len=16)


@pytest.mark.parametrize("mode", ["numeric", "synthetic"])
def test_serving_engine_defaults_to_the_card(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tiny_config("dense", num_layers=2), mode=mode)


@pytest.mark.parametrize("mode", ["cluster", "kernel", "chaos"])
def test_fuzz_workloads_default_to_the_card(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = make_case(mode, 6).workload
    assert w.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        w.make_cluster()


def _fake_card(monkeypatch):
    """Every tensor counts as a CUDA tensor; kernels record their calls and
    the plain versions fail if reached."""
    calls = []
    monkeypatch.setattr(ops, "on_card", lambda t: True)

    def plain(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")

    for name in ("rmsnorm_reference", "gqa_attention_reference",
                 "mha_reference", "adam_flat_reference", "ssd_reference",
                 "ssd_chunked", "dropout_reference"):
        monkeypatch.setattr(ref, name, plain)
    monkeypatch.setattr(ops, "rmsnorm_cuda",
                        lambda x, s, eps: calls.append("rmsnorm") or x)
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        lambda q, k, v, c: calls.append("flash") or q)
    monkeypatch.setattr(ops, "fused_adam_cuda_",
                        lambda *a: calls.append("adam"))
    monkeypatch.setattr(ops, "ssd_scan_cuda",
                        lambda x, *a: calls.append("ssd") or x)
    monkeypatch.setattr(ops, "threefry_dropout_cuda",
                        lambda x, *a: calls.append("dropout") or x)
    return calls


def test_wrappers_never_give_a_cuda_tensor_to_the_plain_version(monkeypatch):
    calls = _fake_card(monkeypatch)
    x = torch.zeros(2, 8, 4, 16)
    ops.rmsnorm(x, torch.ones(16))
    ops.flash_attention(x, x[:, :, :2], x[:, :, :2])
    v = torch.zeros(5)
    ops.fused_adam_(v, v.clone(), v.clone(), v.clone(), step=1)
    ops.ssd_scan(x, torch.ones(2, 8, 4), -torch.ones(4), x[:, :, :1],
                 x[:, :, :1], chunk=4)
    ops.dropout(x, (1, 2), torch.zeros(2, dtype=torch.int32), 0.1)
    assert calls == ["rmsnorm", "flash", "adam", "ssd", "dropout"]


def test_final_state_scan_launches_the_kernel(monkeypatch):
    calls = _fake_card(monkeypatch)
    monkeypatch.setattr(
        ops, "ssd_scan_cuda",
        lambda x, dt, A, B, C, chunk, final=False: calls.append(
            ("ssd", final)) or (x, torch.zeros(2, 4, 16, 1)))
    x = torch.zeros(2, 8, 4, 16)
    y, state = ops.ssd_scan(x, torch.ones(2, 8, 4), -torch.ones(4),
                            x[:, :, :1], x[:, :, :1], chunk=4,
                            return_final_state=True)
    assert calls == [("ssd", True)] and state.shape == (2, 4, 16, 1)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_serving_path_never_gives_a_cuda_tensor_to_the_plain_version(
        family, monkeypatch):
    """A prefill (with a ragged ssm tail) and a decode step with every
    tensor counted as on the card: each norm, attention and scan goes to
    its kernel, none to ``ref.py``."""
    from repro_torch.models import registry as R, transformer as T
    calls = _fake_card(monkeypatch)

    def scan(x, dt, A, B, C, chunk, final=False):
        calls.append("ssd")
        st = torch.zeros(x.shape[0], x.shape[2], x.shape[3], B.shape[3])
        return (x, st) if final else x

    monkeypatch.setattr(ops, "ssd_scan_cuda", scan)
    cfg = tiny_config(family, num_layers=2)
    params = R.init_model(torch.Generator().manual_seed(0), cfg)
    caches = T.init_caches(cfg, 1, 16)
    T.prefill(params, cfg, torch.zeros(1, 11, dtype=torch.int64), caches)
    T.decode_step(params, cfg, torch.zeros(1, 1, dtype=torch.int64), caches,
                  torch.tensor([11]))
    kernel = "flash" if family == "dense" else "ssd"
    assert calls.count(kernel) == 2 and set(calls) == {"rmsnorm", kernel}
    assert calls.count("rmsnorm") == 2 * (2 * 2 + 1)


def test_other_devices_raise(monkeypatch):
    """Meta (the dry run), where nothing launches, takes the plain
    version: no launch is counted and no kernel is reached.  A device
    that is neither cpu, cuda nor meta still raises."""
    def kernel(*a, **k):
        raise AssertionError("kernel reached for a meta tensor")

    monkeypatch.setattr(ops, "rmsnorm_cuda", kernel)
    before = dict(_build.LAUNCHES)
    x = torch.zeros(2, 16, device="meta")
    y = ops.rmsnorm(x, torch.ones(16, device="meta"))
    assert y.device.type == "meta" and y.shape == x.shape
    assert dict(_build.LAUNCHES) == before
    assert ops.on_card(x) is False
    for dev in ("xpu", "mps", "hpu"):
        t = types.SimpleNamespace(device=torch.device(dev))
        with pytest.raises(ValueError, match=dev):
            ops.on_card(t)


def test_launch_counts_only_successful_launches(monkeypatch):
    class Lib:
        @staticmethod
        def repro_ok(*a):
            return 0

        @staticmethod
        def repro_bad(*a):
            return 700

    monkeypatch.setattr(_build, "library", lambda: Lib)
    monkeypatch.setattr(_build, "LAUNCHES", {"k": 0})
    _build.launch("k", "repro_ok")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _build.launch("k", "repro_bad")
    assert _build.LAUNCHES == {"k": 1}
    _build.reset_launch_counts()
    assert _build.LAUNCHES == {"k": 0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
