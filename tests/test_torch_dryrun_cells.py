"""One dry-run cell of each family and kind on the single (16, 16) mesh
(``launch/dryrun.run_cell`` on meta DTensors over a fake process group of
256 ranks): dense codeqwen1.5-7b train, prefill and decode, MoE
llama4-scout train, MLA deepseek-v3 decode, ssm mamba2-2.7b prefill,
hybrid jamba-1.5-large train, enc-dec whisper-base train and decode, and
the vlm internvl2-76b prefill.  Each artifact is ok, its closed-form fields
are the reference's (from the JAX package's configs), its per-device
counts positive and consistent, and no kernel launch counter moves.  The
multi mesh's cells are in tests/test_torch_dryrun_cells_multi*.py."""
import pytest

from repro_torch.kernels import _build
from repro_torch.launch import dryrun as D

from _torch_dryrun import check_artifact, world  # noqa: F401

CELLS = [("codeqwen1p5_7b", "train_4k"), ("codeqwen1p5_7b", "prefill_32k"),
         ("codeqwen1p5_7b", "decode_32k"),
         ("llama4_scout_17b_a16e", "train_4k"),
         ("deepseek_v3_671b", "decode_32k"), ("mamba2_2p7b", "prefill_32k"),
         ("jamba_1p5_large_398b", "train_4k"), ("whisper_base", "train_4k"),
         ("whisper_base", "decode_32k"), ("internvl2_76b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_single(world, arch, shape):
    world("single")
    before = dict(_build.LAUNCHES)
    art = D.run_cell(arch, shape, "single")
    check_artifact(art, arch, shape, "single")
    assert dict(_build.LAUNCHES) == before
