"""Dataflow planner (paper §4.1): micro-batch resizing, not rerouting.

On DP shrink from D to D', each surviving rank's micro-batch size grows so
that  D' x mbs' x num_micro == global_batch  is preserved exactly; the
per-rank gradient weights (= samples contributed / global_batch) keep the
global gradient identical to the fault-free run (§4.4 "adjust the computation
of average gradient ... so that the unevenly divided micro batch will not
affect the final gradient results").

A copy of ``repro.core.planners.dataflow`` (the JAX package), numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DataflowPlan:
    micro_batch_sizes: Tuple[int, ...]    # per surviving DP rank
    num_micro_batches: int
    grad_weights: Tuple[float, ...]       # per rank, sums to 1 per micro-batch
    global_batch: int

    def validate(self):
        assert sum(self.micro_batch_sizes) * self.num_micro_batches == self.global_batch
        s = sum(self.grad_weights)
        assert abs(s - 1.0) < 1e-9, s


def plan_dataflow(global_batch: int, num_micro_batches: int,
                  surviving_dp: int) -> DataflowPlan:
    """Split each micro-batch's global slice among surviving DP ranks.

    If the per-micro-batch slice (global_batch / num_micro) does not divide
    evenly by D', sizes differ by at most 1 (handled by per-rank grad
    weights, keeping the global gradient exact).
    """
    assert global_batch % num_micro_batches == 0
    per_micro = global_batch // num_micro_batches
    base = per_micro // surviving_dp
    rem = per_micro % surviving_dp
    sizes = tuple(base + (1 if r < rem else 0) for r in range(surviving_dp))
    weights = tuple(s / per_micro for s in sizes)
    plan = DataflowPlan(sizes, num_micro_batches, weights, global_batch)
    plan.validate()
    return plan
