"""Trace-driven elastic-scenario engine of the port.

Declarative scenario specs (:mod:`.spec`), a two-mode runner (:mod:`.runner`
— numeric ``VirtualCluster`` on the card or the CPU / analytic policy
evaluation), a shared JSON metrics schema (:mod:`.metrics`) and a library of
named scenarios (:mod:`.library`), as ``repro.scenarios`` (the JAX package)
has them.  Its fuzzer (``fuzz``: random legal traces, kernel-mode and
detection-chaos cases) and its serving runner (``serve``) are not ported
yet; they wait for the port's fuzzer and its serving plane.

Quick use::

    from repro_torch.core.invariants import default_cluster_checkers
    from repro_torch.scenarios import get_scenario, run_scenario
    result = run_scenario(*get_scenario("concurrent_burst"),
                          checkers=default_cluster_checkers(device="cuda"))
    print(result.summary)
    result.write("artifacts/")
"""
from repro_torch.core.clusterview import ClusterView, FailureDomainMap, GroupDelta

from .library import SCENARIOS, get_scenario
from .metrics import MetricsCollector, ScenarioResult
from .runner import (AnalyticScenarioRunner, ClusterScenarioRunner,
                     run_scenario)
from .spec import (AnalyticWorkload, ClusterWorkload, Scenario,
                   node_shrink_cells, validate_event_legality)

__all__ = [
    "AnalyticScenarioRunner", "AnalyticWorkload", "ClusterScenarioRunner",
    "ClusterView", "ClusterWorkload", "FailureDomainMap", "GroupDelta",
    "MetricsCollector", "SCENARIOS", "Scenario", "ScenarioResult",
    "get_scenario", "node_shrink_cells", "run_scenario",
    "validate_event_legality",
]
