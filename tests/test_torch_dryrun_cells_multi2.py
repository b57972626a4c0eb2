"""More of the multi-pod cells (see tests/test_torch_dryrun_cells_multi.py):
hybrid jamba-1.5-large train and the vlm internvl2-76b prefill."""
import pytest

from repro_torch.kernels import _build
from repro_torch.launch import dryrun as D

from _torch_dryrun import check_artifact, world  # noqa: F401

CELLS = [("jamba_1p5_large_398b", "train_4k"),
         ("internvl2_76b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_multi(world, arch, shape):
    world("multi")
    before = dict(_build.LAUNCHES)
    art = D.run_cell(arch, shape, "multi")
    check_artifact(art, arch, shape, "multi")
    assert dict(_build.LAUNCHES) == before
