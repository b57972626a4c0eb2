"""The cells of tests/test_torch_dryrun_cells.py on the multi-pod
(2, 16, 16) mesh over a fake process group of 512 ranks: dense
codeqwen1.5-7b train, prefill and decode, MoE llama4-scout train, MLA
deepseek-v3 decode, ssm mamba2-2.7b prefill (the rest in
tests/test_torch_dryrun_cells_multi2.py and ..._multi3.py, so that no file
runs much over a minute)."""
import pytest

from repro_torch.kernels import _build
from repro_torch.launch import dryrun as D

from _torch_dryrun import check_artifact, world  # noqa: F401

CELLS = [("codeqwen1p5_7b", "train_4k"), ("codeqwen1p5_7b", "prefill_32k"),
         ("codeqwen1p5_7b", "decode_32k"),
         ("llama4_scout_17b_a16e", "train_4k"),
         ("deepseek_v3_671b", "decode_32k"), ("mamba2_2p7b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_multi(world, arch, shape):
    world("multi")
    before = dict(_build.LAUNCHES)
    art = D.run_cell(arch, shape, "multi")
    check_artifact(art, arch, shape, "multi")
    assert dict(_build.LAUNCHES) == before
