"""The port's dry-run artifact of codeqwen1.5-7b ``train_4k`` (single
mesh) against the reference's (``repro.launch.dryrun.run_cell``, compiled
in a subprocess on 256 placeholder devices, ~14 s here).

* ``model_flops``, ``params_total``, ``params_active``,
  ``state_bytes_per_chip``, ``chips``, ``kind``, ``seq`` and ``batch`` are
  equal.
* ``argument_size_in_bytes``: the reference's is 4 bytes more, AdamW's
  ``step``, a 0-d int32 array there and a Python int in the port.
* ``output_size_in_bytes``: the reference's is 404 bytes more: the step
  again (4) and XLA's output tuple table, 8 bytes for each of the
  flattened output's 50 leaves.
* ``hlo_flops_per_device``: the ratio port / reference is held to [0.6,
  0.75] (measured on torch 2.13 CPU: 0.6662).  The port counts matrix
  products and attention, no elementwise work; XLA counts both, with its
  own partition and remat.  Before a constraint's gradient was constrained
  too (``parallel.dtensor.constrain``), the backward's partial sums
  reached each branch unreduced, its products gathered their weights
  whole, and the port counted 2.23 times its present count here.
"""
from repro_torch.launch import dryrun as D

from _torch_dryrun import check_against_reference, reference_artifact
from _torch_dryrun import world  # noqa: F401

FLOP_RATIO = (0.6, 0.75)
ADAM_STEP_BYTES = 4


def test_train_cell_matches_the_reference(world):
    world("single")
    ref = reference_artifact("codeqwen1p5_7b", "train_4k")
    got = D.run_cell("codeqwen1p5_7b", "train_4k", "single")
    assert ref["out_leaves"] == 50
    check_against_reference(got, ref, FLOP_RATIO, -ADAM_STEP_BYTES,
                            output_extra=ADAM_STEP_BYTES)
