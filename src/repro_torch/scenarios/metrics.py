"""Scenario metrics: per-step records, itemized MTTR, JSON artifacts.

A copy of ``repro.scenarios.metrics`` (the JAX package), plain Python.

Every scenario run — cluster-mode or analytic — funnels through one
:class:`MetricsCollector` so artifacts share a schema:

```
{"scenario": {...}, "mode": "cluster"|"analytic", "workload": {...},
 "steps":      [{"step": 0, ...}, ...],
 "recoveries": [{"step": 3, "kind": "fail_stop", "ranks": [2],
                 "mttr": {"detect": .., "plan": .., "communicator": ..,
                          "remap": .., "migration": .., "total": ..}, ...}],
 "summary": {...}}
```

Cluster-mode step records carry loss / simulated step time / throughput /
surviving DP width (convergence-consistency material); analytic records carry
per-interval relative throughput and decision metadata.  Records are plain
dicts built deterministically from the trace: identical traces produce
identical *step* records.  The only
intentionally non-replayable fields are measured wall clocks — the planner's
``plan`` seconds inside a recovery record's MTTR itemization (folded into
``total``) and the analytic runner's ``decide_wall_seconds``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.core.events import ElasticEvent


@dataclasses.dataclass
class ScenarioResult:
    scenario: Dict
    mode: str
    workload: Dict
    steps: List[Dict]
    recoveries: List[Dict]
    summary: Dict

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent,
                          sort_keys=True, default=float)

    def write(self, out_dir) -> Path:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{self.scenario['name']}.json"
        path.write_text(self.to_json())
        return path

    @property
    def mttr_total(self) -> float:
        return sum(r["mttr"].get("total", 0.0) for r in self.recoveries)


class MetricsCollector:
    def __init__(self):
        self.steps: List[Dict] = []
        self.recoveries: List[Dict] = []

    def record_step(self, step: int, **fields):
        self.steps.append({"step": step, **fields})

    def record_recovery(self, step: int, event: ElasticEvent,
                        mttr: Dict[str, float], **extra):
        self.recoveries.append({
            "step": step, "kind": event.kind.value,
            "ranks": list(event.ranks), "event": event.describe(),
            "mttr": dict(mttr), **extra})

    def result(self, scenario, mode: str, workload: Dict,
               summary: Optional[Dict] = None) -> ScenarioResult:
        return ScenarioResult(scenario=scenario.describe(), mode=mode,
                              workload=workload, steps=list(self.steps),
                              recoveries=list(self.recoveries),
                              summary=dict(summary or {}))
