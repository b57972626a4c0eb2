"""The last of the multi-pod cells (see
tests/test_torch_dryrun_cells_multi.py): enc-dec whisper-base train and
decode."""
import pytest

from repro_torch.kernels import _build
from repro_torch.launch import dryrun as D

from _torch_dryrun import check_artifact, world  # noqa: F401

CELLS = [("whisper_base", "train_4k"), ("whisper_base", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_multi(world, arch, shape):
    world("multi")
    before = dict(_build.LAUNCHES)
    art = D.run_cell(arch, shape, "multi")
    check_artifact(art, arch, shape, "multi")
    assert dict(_build.LAUNCHES) == before
