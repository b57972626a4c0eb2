"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``) on the CPU:
a round trip of a model's parameters and optimizer state (bitwise, in
place), bf16 bit for bit, ``keep``,
``latest_step``, a corrupted file raising ``IOError``, a non-blocking save
unchanged by the in-place updates after it, a failed background write
raised by ``wait``, and the same dict of numpy arrays saved by the port's
and the reference's managers: the same directory, manifest keys and
array contents.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as M
from repro_torch.models import registry as R
from repro_torch.optim import adam as A
from repro_torch.tree import leaves_with_paths

from _torch_threads import torch_one_thread  # noqa: F401


def _model(seed, dtype=None):
    cfg = configs.get_smoke_config("mamba2_2p7b")
    if dtype:
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = R.init_model(torch.Generator().manual_seed(seed), cfg)
    opt = A.init_opt_state(params, A.AdamConfig())
    return params, opt


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_trees_equal(a, b):
    pa, pb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), \
                path
        else:
            assert x == y and type(x) is type(y), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bitwise(tmp_path, dtype):
    """Parameters and optimizer state (step included) back into a fresh
    tree, bit for bit; bf16 leaves stored as their bits, listed in the
    manifest; the tied tree's keys, with no head matrix; restored in
    place."""
    params, opt = _model(0, dtype)
    opt["step"] = 7
    ck = CheckpointManager(tmp_path)
    ck.save(7, params, opt, extra={"note": "x"})
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert manifest["extra"] == {"note": "x"}
    with np.load(tmp_path / "step_00000007" / "params.npz") as z:
        keys = set(z.files)
    assert "0/embed/embedding" in keys and "2/head/w" not in keys
    bf16 = manifest["arrays"]["params"].get(M.BF16_KEY, [])
    assert ("0/embed/embedding" in bf16) == (dtype == "bfloat16")
    assert "0/embed/embedding" not in manifest["arrays"]["opt"].get(
        M.BF16_KEY, [])
    step, flat, extra = ck.restore()
    assert step == 7 and extra == {"note": "x"}
    fresh, fresh_opt = _model(1, dtype)
    emb = fresh[0]["embed"]["embedding"]
    assert not torch.equal(_bits(emb), _bits(params[0]["embed"]["embedding"]))
    got = ck.restore_into(fresh, flat["params"])
    got_opt = ck.restore_into(fresh_opt, flat["opt"])
    assert got[0]["embed"]["embedding"] is emb
    _assert_trees_equal(got, params)
    _assert_trees_equal(got_opt, opt)
    assert got_opt["step"] == 7 and isinstance(got_opt["step"], int)


def test_bf16_special_values_survive(tmp_path):
    vals = torch.tensor([0.0, -0.0, 1.0, -2.5, float("inf"), float("-inf"),
                         1e-40, 3.3895e38], dtype=torch.bfloat16)
    nan = torch.tensor([0x7FC1, 0xFFC0 - 0x10000], dtype=torch.int16) \
        .view(torch.bfloat16)
    tree = {"a": vals, "b": [nan]}
    ck = CheckpointManager(tmp_path)
    ck.save(0, tree)
    _, flat, _ = ck.restore(0)
    assert flat["params"]["a"].dtype == np.uint16
    out = ck.restore_into({"a": torch.zeros(8, dtype=torch.bfloat16),
                           "b": [torch.zeros(2, dtype=torch.bfloat16)]},
                          flat["params"])
    _assert_trees_equal(out, tree)


def test_keep_and_latest_step(tmp_path):
    ck = CheckpointManager(tmp_path, keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    tree = {"w": torch.arange(6.0)}
    for step in (3, 11, 12, 40):
        ck.save(step, tree, blocking=step % 2 == 0)
    ck.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000012", "step_00000040"]
    assert ck.latest_step() == 40
    assert ck.restore(12)[0] == 12


def test_corrupted_file_raises(tmp_path):
    ck = CheckpointManager(tmp_path)
    ck.save(1, {"w": torch.arange(64.0)}, {"m": np.ones(3)})
    fn = tmp_path / "step_00000001" / "params.npz"
    raw = bytearray(fn.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    fn.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupted"):
        ck.restore(1)


def test_nonblocking_save_is_immune_to_later_updates(tmp_path, monkeypatch):
    """The write is held until the tree has been updated in place: the
    checkpoint still holds the values at the save."""
    params, opt = _model(0)
    want = [t.clone() for _, t in leaves_with_paths(params)]
    go, savez = threading.Event(), np.savez

    def held(*a, **k):
        assert go.wait(30)
        return savez(*a, **k)
    monkeypatch.setattr(np, "savez", held)
    ck = CheckpointManager(tmp_path)
    ck.save(0, params, opt, blocking=False)
    with torch.no_grad():
        for _, t in leaves_with_paths(params):
            t.add_(1.0)
        for _, t in leaves_with_paths(opt["leaves"]):
            t.add_(1.0)
    go.set()
    ck.wait()
    assert ck._thread is None
    _, flat, _ = ck.restore()
    fresh, _ = _model(1)
    got = ck.restore_into(fresh, flat["params"])
    for (_, g), w in zip(leaves_with_paths(got), want):
        assert torch.equal(g, w)
    assert not (flat["opt"]["leaves/0/embed/embedding/mu"] != 0).any()


def test_failed_background_write_is_raised_by_wait(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    ck = CheckpointManager(tmp_path)
    ck.save(0, {"w": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                        # raised once


def test_same_arrays_same_checkpoint_as_the_reference(tmp_path):
    """A dict of numpy arrays saved by both managers: the same directory
    entries, manifest keys and array contents (the zip files' bytes, and
    so their hashes, may differ)."""
    jm = pytest.importorskip("repro.checkpoint.manager")
    rs = np.random.default_rng(0)
    params = {"embed": {"embedding": rs.standard_normal((5, 3))
                        .astype(np.float32)},
              "blocks": [{"w": rs.standard_normal((3, 3)).astype(np.float32),
                          "n": np.arange(4, dtype=np.int32)}
                         for _ in range(2)],
              "final_norm": {"scale": np.ones(3, np.float32)}}
    opt = {"leaves": {"embed": {"embedding": {"mu": np.zeros((5, 3),
                                                             np.float32)}}},
           "step": np.asarray(4, np.int32)}
    dirs = {}
    for name, mgr in (("port", CheckpointManager), ("ref",
                                                    jm.CheckpointManager)):
        d = tmp_path / name
        mgr(d, keep=2).save(4, params, opt, extra={"k": 1})
        dirs[name] = d
    listing = [sorted(str(p.relative_to(d)) for p in d.rglob("*"))
               for d in dirs.values()]
    assert listing[0] == listing[1]
    manifests = [json.loads((d / "step_00000004" / "manifest.json")
                            .read_text()) for d in dirs.values()]
    assert manifests[0].keys() == manifests[1].keys()
    for a, b in zip(*(m["arrays"].items() for m in manifests)):
        assert a[0] == b[0] and a[1].keys() == b[1].keys()
    assert manifests[0]["extra"] == manifests[1]["extra"]
    for f in ("params.npz", "opt.npz"):
        with np.load(dirs["port"] / "step_00000004" / f) as zp, \
                np.load(dirs["ref"] / "step_00000004" / f) as zr:
            assert sorted(zp.files) == sorted(zr.files)
            for k in zp.files:
                assert zp[k].dtype == zr[k].dtype
                np.testing.assert_array_equal(zp[k], zr[k])
