"""One whole-model launcher step (``repro_torch.launch.train.train_step``)
on the ssm and hybrid smoke configs (mamba2-2.7b's tied head, jamba's
Mamba2 and Mamba2-MoE blocks)
on the CPU against the reference's un-jitted ``value_and_grad`` +
``adam_update``, within the bounds of ``tests/_torch_launch_twin.py``.
"""
import pytest

pytest.importorskip("jax")

from _torch_launch_twin import check_launcher_step  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: F401,E402

ARCHS = ("mamba2_2p7b", "jamba_1p5_large_398b")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_launcher_step_matches_reference(arch, monkeypatch):
    check_launcher_step(arch, monkeypatch)
