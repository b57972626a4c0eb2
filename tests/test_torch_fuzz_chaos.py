"""Detection-chaos cases through the port's ``DetectionChaosRunner`` on the
CPU, against the JAX package's on its fast path.

Chaos seeds 0 (``corrupt``: a kill and a drain, each read from a
bit-flipped snapshot shard), 1 (``mixed``, pp 2: a kill, a preemption
notice and an OOM ramp) and 3 (``flap_only``, pp 2: no real failure), each
as both packages draw it, run from the reference's initial weights with
the dataflow, RNG and MTTR checkers on both sides.  Probe chaos is drawn
from the seed, so the controller sees the same probes on both sides.  The
planner's measured wall clock is pinned to 0 on both sides.

Held exactly: the recovery records, the steps run (horizon and settle
window), the final alive grid, the agent's registered ranks and the
tolerance-tier (degraded) rebuild count.  Held within the loss bound of
the reference's ``KernelConsistencyChecker``: losses.
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_fuzz_twin import loss_within, run_chaos  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: E402,F401

# seed: (class, ranks dead at the end, degraded rebuilds)
CASES = {0: ("corrupt", [1, 2], 1), 1: ("mixed", [0, 4], 0),
         3: ("flap_only", [], 0)}


@pytest.mark.parametrize("seed", list(CASES))
def test_chaos_case_matches_reference(seed):
    got, want, case = run_chaos(seed)
    chaos_class, dead, degraded = CASES[seed]
    assert case.chaos_class == chaos_class
    assert got.recoveries == want.recoveries
    assert got.step_count == want.step_count >= case.horizon
    assert np.array_equal(got.alive, np.asarray(want.alive))
    assert got.agent.ranks == want.agent.ranks
    n = got.dp0 * got.pp
    assert [r for r in range(n) if r not in got.agent.ranks] == dead
    assert sum(int(r.get("degraded", 0)) for r in got.recoveries) == \
        sum(int(r.get("degraded", 0)) for r in want.recoveries) == degraded
    assert len(got.losses) == len(want.losses) == got.step_count
    for a, b in zip(got.losses, want.losses):
        assert math.isfinite(a) and loss_within(a, float(b)), (seed, a, b)
