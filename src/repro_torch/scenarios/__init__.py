"""Trace-driven elastic-scenario engine of the port.

Declarative scenario specs (:mod:`.spec`), a two-mode runner (:mod:`.runner`
— numeric ``VirtualCluster`` on the card or the CPU / analytic policy
evaluation), a shared JSON metrics schema (:mod:`.metrics`) and a library of
named scenarios (:mod:`.library`), as ``repro.scenarios`` (the JAX package)
has them, and the trace fuzzer (:mod:`.fuzz`: random legal traces in
analytic, cluster and kernel modes, the shrinker, detection-chaos cases and
the detector-only sweep), and the serving runner (:mod:`.serve`: the same
traces against the port's ``ServingEngine``).

Quick use::

    from repro_torch.core.invariants import default_cluster_checkers
    from repro_torch.scenarios import get_scenario, run_scenario
    result = run_scenario(*get_scenario("concurrent_burst"),
                          checkers=default_cluster_checkers(device="cuda"))
    print(result.summary)
    result.write("artifacts/")
"""
from repro_torch.core.clusterview import ClusterView, FailureDomainMap, GroupDelta

from .fuzz import (CHAOS_CLASSES, ChaosCase, DetectionChaosRunner, FuzzCase,
                   POLICY_NAMES, make_analytic_case, make_case,
                   make_chaos_case, make_cluster_case, make_kernel_case,
                   make_policy, run_case, run_chaos_case, run_detector_chaos,
                   shrink_case, trace_is_legal)
from .library import SCENARIOS, get_scenario
from .metrics import MetricsCollector, ScenarioResult
from .runner import (AnalyticScenarioRunner, ClusterScenarioRunner,
                     run_scenario)
from .serve import ServeScenarioRunner, ServeWorkload, run_serve_scenario
from .spec import (AnalyticWorkload, ClusterWorkload, Scenario,
                   node_shrink_cells, validate_event_legality)

__all__ = [
    "AnalyticScenarioRunner", "AnalyticWorkload", "CHAOS_CLASSES",
    "ChaosCase", "ClusterScenarioRunner", "ClusterView", "ClusterWorkload",
    "DetectionChaosRunner", "FailureDomainMap", "FuzzCase", "GroupDelta",
    "MetricsCollector", "POLICY_NAMES", "SCENARIOS", "Scenario",
    "ScenarioResult", "ServeScenarioRunner", "ServeWorkload", "get_scenario", "make_analytic_case", "make_case",
    "make_chaos_case", "make_cluster_case", "make_kernel_case", "make_policy",
    "node_shrink_cells", "run_case", "run_chaos_case", "run_detector_chaos",
    "run_scenario", "run_serve_scenario", "shrink_case", "trace_is_legal",
    "validate_event_legality",
]
