"""The port's two training examples, as functions, at a tiny size on the
CPU: ``examples/torch_quickstart.py`` keeps its loss trajectory through a
fail-stop (deviation below its own 1e-4 gate), and
``examples/torch_elastic_train.py`` makes its two recoveries (a fail-stop
found by the probes, then a fail-slow) with finite losses.  Both default to
the card and raise without one."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_keeps_the_loss_trajectory(capsys):
    out = _example("torch_quickstart").quickstart(device="cpu", num_layers=2,
                                                  steps=4)
    assert len(out["base_losses"]) == len(out["losses"]) == 4
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["deviation"] < 1e-4
    assert out["recovery"]["total"] > 0
    assert "computation consistency: OK" in capsys.readouterr().out


def test_elastic_train_makes_two_recoveries(capsys):
    out = _example("torch_elastic_train").elastic_train(
        steps=6, dmodel=64, layers=2, vocab=256, seq=16, report_every=3,
        device="cpu")
    assert len(out["losses"]) == 6
    assert all(math.isfinite(x) for x in out["losses"])
    fail_stop, fail_slow = out["recoveries"]
    assert fail_stop["rng_moves"] > 0 and fail_stop["total"] > 0
    assert fail_slow["migration"] >= 0
    text = capsys.readouterr().out
    assert "FAIL-STOP injected" in text and "FAIL-SLOW injected" in text
    assert "recoveries: 2;" in text


@pytest.mark.parametrize("name,fn", [("torch_quickstart", "quickstart"),
                                     ("torch_elastic_train",
                                      "elastic_train")])
def test_examples_default_to_the_card(name, fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(_example(name), fn)()
