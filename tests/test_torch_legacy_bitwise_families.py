"""The port's seed path equals its fast path bit for bit under the
contiguous layout (the dense case of ``test_torch_legacy_bitwise.py``) and
on the moe (capacity factor 16, so that routing does not depend on which
samples share an item) and ssm families at dropout 0.1, dp 2, pp 2, global
batch 8, as the reference's ``TestOtherModesBitIdentical::test_families``
configures them: the sequence and checks of ``test_torch_legacy_bitwise.py``.
"""
import pytest

from test_torch_legacy_bitwise import DENSE, run_case
from _torch_threads import torch_one_thread  # noqa: F401

KW = dict(global_batch=8, num_micro=2, seq_len=16)
CASES = {
    "contiguous": {**DENSE, "kw": {**DENSE["kw"],
                                   "zero_layout": "contiguous"}},
    "moe": dict(family="moe", cfg=dict(dropout_rate=0.1,
                                       capacity_factor=16.0),
                dp=2, pp=2, kw=KW),
    "ssm": dict(family="ssm", cfg=dict(dropout_rate=0.1), dp=2, pp=2, kw=KW),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_path_equals_fast_path_bitwise(case):
    run_case(CASES[case])
