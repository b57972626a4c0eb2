"""The whole-model training launcher (``repro_torch.launch.train``) on the
CPU against the JAX package.

One launcher step (``train_step``: the loss forward and backward, the
tree-level AdamW, gradients dropped) on the dense, vlm and audio smoke
configs against the reference's un-jitted ``value_and_grad`` +
``adam_update``, within the bounds of ``tests/_torch_launch_twin.py``
(the ssm and hybrid configs: ``test_torch_train_launch_ssm.py``, the
MoE ones: ``test_torch_train_launch_moe.py``).
Then ``make_batch`` against the reference's, and ``main``:
a CPU run writing its checkpoints, ``--dryrun``, and the default device
without a card.
"""
import json
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402

from _torch_launch_twin import check_launcher_step  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: F401,E402

# the dense, vlm and audio smoke configs; the ssm and hybrid ones are in
# tests/test_torch_train_launch_ssm.py, the MoE ones in
# tests/test_torch_train_launch_moe.py (one file took ~110 s)
ARCHS = ("codeqwen1p5_7b", "llama3_405b", "deepseek_67b", "nemotron_4_15b",
         "internvl2_76b", "whisper_base")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_launcher_step_matches_reference(arch, monkeypatch):
    check_launcher_step(arch, monkeypatch)


def test_the_three_files_step_every_smoke_config():
    from test_torch_train_launch_moe import ARCHS as MOE
    from test_torch_train_launch_ssm import ARCHS as SSM
    assert sorted(ARCHS + MOE + SSM) == sorted(jconfigs.ARCH_IDS)


@pytest.mark.parametrize("seed", [0, 5])
def test_make_batch_equals_reference(seed):
    ids = np.array([3, 17, 1 << 33, 0], dtype=np.int64)
    want = JP.make_batch(ids, 24, 50280, seed=seed)
    got = P.make_batch(ids, 24, 50280, seed=seed, device="cpu")
    assert got["tokens"].dtype == got["labels"].dtype == torch.int64
    assert got["sample_ids"].dtype == torch.int32
    for k in ("tokens", "labels", "sample_ids"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_extra_inputs_by_family():
    """Frames for an enc-dec config, prefix embeddings for a vlm config,
    nothing otherwise; a step's draw is the same on every call."""
    audio = configs.get_smoke_config("whisper_base")
    vlm = configs.get_smoke_config("internvl2_76b")
    fr = TR.extra_inputs(audio, 3, 2, 16, "cpu")
    assert list(fr) == ["frames"] and fr["frames"].shape == (2, 16, 64)
    pre = TR.extra_inputs(vlm, 3, 2, 16, "cpu")["prefix_embeds"]
    assert pre.shape == (2, vlm.frontend_embeds, vlm.d_model)
    assert TR.extra_inputs(configs.get_smoke_config("mamba2_2p7b"), 3, 2,
                           16, "cpu") == {}
    assert torch.equal(fr["frames"],
                       TR.extra_inputs(audio, 3, 2, 16, "cpu")["frames"])
    assert not torch.equal(fr["frames"],
                           TR.extra_inputs(audio, 4, 2, 16, "cpu")["frames"])


def test_main_trains_and_writes_checkpoints(tmp_path, capsys):
    losses = TR.main(["--arch", "mamba2_2p7b", "--smoke", "--device", "cpu",
                      "--steps", "10", "--seq", "32", "--batch", "2",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert "training mamba2-2.7b-smoke" in out and "step    9" in out
    assert "checkpoints: ['step_00000009']" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000009"]
    assert sorted(p.name for p in (tmp_path / "step_00000009").iterdir()) \
        == ["manifest.json", "opt.npz", "params.npz"]


def test_dryrun_raises_naming_the_slice(tmp_path):
    """``--dryrun`` no longer raises: it runs the full config's train_4k
    cell through ``python -m repro_torch.launch.dryrun`` (on meta DTensors
    over a fake process group of 256 ranks) and writes its artifact, here
    in ``--out-dir``."""
    out = tmp_path / "llama3_405b__train_4k__single.json"
    with pytest.raises(SystemExit) as e:
        TR.main(["--arch", "llama3_405b", "--dryrun", "--out-dir",
                 str(tmp_path)])
    assert e.value.code == 0
    art = json.loads(out.read_text())
    assert art["status"] == "ok" and art["chips"] == 256
    assert art["kind"] == "train" and art["hlo_flops_per_device"] > 0


def test_default_device_without_a_card_raises(monkeypatch):
    """The default device is the card: without one the launcher raises
    and never trains on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.main(["--arch", "mamba2_2p7b", "--smoke", "--steps", "1"])
