"""The port's dry-run artifacts against the reference's on whisper-base and
mamba2-2.7b ``decode_32k``, single mesh.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported,
so its ``run_cell`` runs in a subprocess, with ``DRYRUN_XLA_FLAGS`` giving
256 placeholder devices (~6-7 s a cell here); the port's runs in this
process on a fake process group.

* ``model_flops``, ``params_total``, ``params_active``,
  ``state_bytes_per_chip``, ``chips``, ``kind``, ``seq`` and ``batch`` are
  equal.
* ``argument_size_in_bytes``: the port counts every argument's local
  shard; XLA leaves out the arguments the compiled step never reads.
  whisper-base's decode step reads the encoder's output, not the encoder
  (``encoder``, ``enc_pos``, ``enc_norm``); mamba2-2.7b's reads no
  position, so not the 0-d cache index (4 bytes).  The difference is
  exactly those bytes.
* ``output_size_in_bytes``: XLA's is 24 bytes more on both cells, its
  output tuple's table (8 bytes a leaf of the flattened output, 3 leaves
  here; the port's is the outputs' local shards alone).
* ``hlo_flops_per_device``: the port counts matrix products and attention
  (the plain forms' S x T scores) and no elementwise work; XLA counts
  both and pads whisper-base's 8 heads to the 16-wide ``model`` axis
  where the port gathers them.  The ratio port / reference is held to
  [0.7, 1.4] (measured on torch 2.13 CPU: whisper-base 1.277,
  mamba2-2.7b 0.7495).  The train cell's check is in
  tests/test_torch_dryrun_ref_train.py.
* whisper-base's artifact also equals the values ``chip_smoke.py``'s
  phase 14 holds the card machine's dry run to (its ``DRYRUN_PIN``).
"""
import pytest

from repro_torch import configs
from repro_torch.launch import dryrun as D
from repro_torch.launch.steps import build_cell

from _torch_dryrun import check_against_reference, reference_artifact
from _torch_dryrun import world  # noqa: F401

FLOP_RATIO = (0.7, 1.4)
# chip_smoke.py's DRYRUN_PIN: the card machine's dry run of this cell is
# held to these
DRYRUN_PIN = {"argument_size_in_bytes": 220_857_252,
              "model_flops": 28_094_758_912,
              "hlo_flops_per_device": 8_540_463_104,
              "collective_bytes.total": 217_879_424}


def _unread_argument_bytes(arch: str, mesh) -> int:
    """Local bytes of the arguments the reference's compiled decode step
    does not read (see the module docstring)."""
    cfg = configs.get_config(arch)
    cell = build_cell(cfg, "decode_32k", 32768, 128, mesh)
    if arch == "whisper_base":
        params, specs = cell.arg_shapes[0], cell.arg_pspecs[0]
        keys = ("encoder", "enc_pos", "enc_norm")
        return D.local_bytes(mesh, {k: params[k] for k in keys},
                             {k: specs[k] for k in keys})
    index = cell.arg_shapes[-1]
    assert index.dim() == 0 and index.element_size() == 4
    return 4


@pytest.mark.parametrize("arch", ["whisper_base", "mamba2_2p7b"])
def test_decode_cell_matches_the_reference(world, arch):
    mesh = world("single")
    ref = reference_artifact(arch, "decode_32k")
    got = D.run_cell(arch, "decode_32k", "single")
    assert ref["out_leaves"] == 3
    check_against_reference(got, ref, FLOP_RATIO,
                            _unread_argument_bytes(arch, mesh))
    if arch == "whisper_base":
        fields = {**got, **got["memory_analysis"], "collective_bytes.total":
                  got["collective_bytes"]["total"]}
        assert {k: fields[k] for k in DRYRUN_PIN} == DRYRUN_PIN
