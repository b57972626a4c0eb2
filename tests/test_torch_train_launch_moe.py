"""One whole-model launcher step (``repro_torch.launch.train.train_step``)
on the MoE smoke configs (llama4-scout's MoE blocks, deepseek-v3's MoE
and MLA)
on the CPU against the reference's un-jitted ``value_and_grad`` +
``adam_update``, within the bounds of ``tests/_torch_launch_twin.py``.
"""
import pytest

pytest.importorskip("jax")

from _torch_launch_twin import check_launcher_step  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: F401,E402

ARCHS = ("llama4_scout_17b_a16e", "deepseek_v3_671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_launcher_step_matches_reference(arch, monkeypatch):
    check_launcher_step(arch, monkeypatch)
