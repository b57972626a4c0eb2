"""Named scenario library.

A copy of ``repro.scenarios.library`` (the JAX package), with its workloads
unchanged; each ``ClusterWorkload`` runs on the card unless its ``device``
says otherwise.

Every entry returns ``(Scenario, ClusterWorkload)`` pairs runnable via
:func:`repro_torch.scenarios.runner.run_scenario`.  The first three are shapes the
pre-scenario-engine benchmark scripts could *not* express:

* ``concurrent_burst``       — two ranks in *different* stages fail in the
  same step (switch-domain failure).  Expected shape: one burst recovery
  record whose itemized MTTR accumulates both ranks' control-plane phases
  with detection paid once; the loss trajectory stays consistent with a
  fault-free twin.
* ``shrink_regrow``          — scale-in (preemption) followed by the same
  worker rejoining.  Expected shape: DP width dips then recovers to the
  initial value; rejoin MTTR is communicator-add + reverse remap only (no
  detect / plan / migration).
* ``cascading_failslow``     — a straggler worsens in two waves, then a DVFS
  setpoint up-clocks the slowed workers.  Expected shape: step time rises
  with each wave (minus what migration rebalance claws back) and drops after
  the DVFS absorption event.

Plus single-event baselines (``single_failstop``, ``single_failslow``) used
by tests and as copy-paste templates for new scenarios.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.core.events import EventKind

from .spec import ClusterWorkload, Scenario


def concurrent_burst() -> Tuple[Scenario, ClusterWorkload]:
    w = ClusterWorkload(dp=4, pp=2, global_batch=16, num_micro=2)
    # ranks: (d=1, p=0) and (d=2, p=1) fail in the same step
    scn = Scenario.fail_stop_burst(
        "concurrent_burst", step=3,
        ranks=(w.rank(1, 0), w.rank(2, 1)), horizon=7)
    return scn, w


def shrink_regrow() -> Tuple[Scenario, ClusterWorkload]:
    w = ClusterWorkload(dp=4, pp=2, global_batch=16, num_micro=2)
    scn = Scenario.shrink_regrow("shrink_regrow", rank=w.rank(1, 1),
                                 fail_step=2, rejoin_step=5, horizon=8)
    return scn, w


def cascading_failslow() -> Tuple[Scenario, ClusterWorkload]:
    w = ClusterWorkload(dp=4, pp=2, global_batch=32, num_micro=8,
                        dropout_rate=0.0)
    slow_ranks = (w.rank(0, 0), w.rank(1, 0))
    scn = Scenario.cascade(
        "cascading_failslow",
        cells_factors=[(slow_ranks[0], 1.25), (slow_ranks[1], 1.5)],
        start=2, spacing=2, horizon=9,
        absorb_freq=(slow_ranks, 1.4, 6))
    return scn, w


def preempt_drain() -> Tuple[Scenario, ClusterWorkload]:
    """Spot preemption with a two-minute notice: the named rank is drained
    proactively (verified snapshot flush + remap inside the window) and the
    instance rejoins later.  ``Scenario.reactive_twin()`` of this trace is
    the fail-stop baseline the reference's ``benchmarks/proactive_mttr.py``
    diffs against."""
    w = ClusterWorkload(dp=3, pp=2, global_batch=12, num_micro=2,
                        dropout_rate=0.0)
    scn = Scenario.preempt_notice("preempt_drain", step=2,
                                  ranks=(w.rank(1, 0),), horizon=8,
                                  deadline=120.0, rejoin_step=6)
    return scn, w


def single_failstop() -> Tuple[Scenario, ClusterWorkload]:
    w = ClusterWorkload()
    scn = Scenario.single("single_failstop", EventKind.FAIL_STOP, step=3,
                          ranks=(w.rank(1, 1),), horizon=6)
    return scn, w


def single_failslow() -> Tuple[Scenario, ClusterWorkload]:
    w = ClusterWorkload(global_batch=32, num_micro=8, dropout_rate=0.0)
    scn = Scenario.single("single_failslow", EventKind.FAIL_SLOW, step=2,
                          ranks=(w.rank(0, 0),), horizon=5, slow_factor=1.6)
    return scn, w


SCENARIOS: Dict[str, Callable[[], Tuple[Scenario, ClusterWorkload]]] = {
    "concurrent_burst": concurrent_burst,
    "shrink_regrow": shrink_regrow,
    "cascading_failslow": cascading_failslow,
    "preempt_drain": preempt_drain,
    "single_failstop": single_failstop,
    "single_failslow": single_failslow,
}


def get_scenario(name: str) -> Tuple[Scenario, ClusterWorkload]:
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {sorted(SCENARIOS)}") from None
