"""ServeScenarioRunner: capacity traces replayed against the serving engine,
mirroring ``repro.scenarios.serve``.

The third execution mode of the scenario engine (after cluster-numeric and
analytic-policy): the SAME declarative :class:`~repro_torch.scenarios.spec.Scenario`
traces — including ``Scenario.from_capacity_trace`` spot replays, whose
"steps" are wall-clock seconds — drive a
:class:`~repro_torch.serving.engine.ServingEngine` under a deterministic request
stream.  Rank-addressed trace events map onto serving replicas via
``ranks_per_replica`` (capacity traces built for a dp×pp training grid treat
one node = ``pp`` ranks = one serving replica), so the exact traces the
training benchmarks replay exercise the inference tier too.

Artifacts share the :class:`~repro_torch.scenarios.metrics.MetricsCollector`
schema: per-boundary step records (queue depth, active slots, alive
replicas), per-event recovery records (migrated / rebuilt / dropped, KV
bytes moved, stall charged as MTTR), and a latency/goodput summary — the
material for a serving benchmark.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .metrics import MetricsCollector, ScenarioResult
from .spec import Scenario


@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    """A serving-tier workload: model family (reduced config), replica
    fleet shape, and a deterministic open-loop request stream."""
    family: str = "dense"
    num_layers: int = 2
    n_replicas: int = 4
    slots_per_replica: int = 6
    max_len: int = 48
    prompt_len: int = 16
    max_new_tokens: int = 16
    request_rate: float = 0.5          # requests / simulated second
    seed: int = 0
    mode: str = "synthetic"            # "synthetic" | "numeric"
    ranks_per_replica: int = 2         # capacity-trace node = pp ranks
    sampler_method: str = "greedy"
    sampler_top_k: int = 0
    sampler_temperature: float = 1.0
    slo_ttft: float = 3.0
    slo_per_token: float = 0.25
    device: Optional[str] = None       # None = the card

    def make_engine(self, policy=None):
        from repro_torch.models import registry as R
        from repro_torch.serving import SLO, SamplerConfig, ServingEngine
        cfg = R.tiny_config(self.family, num_layers=self.num_layers,
                            dropout_rate=0.0)
        sampler = SamplerConfig(method=self.sampler_method,
                                top_k=self.sampler_top_k,
                                temperature=self.sampler_temperature,
                                seed=self.seed)
        return ServingEngine(
            cfg, n_replicas=self.n_replicas,
            slots_per_replica=self.slots_per_replica, max_len=self.max_len,
            mode=self.mode, seed=self.seed, sampler=sampler,
            slo=SLO(ttft=self.slo_ttft, per_token=self.slo_per_token),
            policy=policy, ranks_per_replica=self.ranks_per_replica,
            device=self.device)

    def describe(self) -> Dict:
        return dataclasses.asdict(self)


class ServeScenarioRunner:
    """Serving mode: scenario events against a live ServingEngine."""

    def __init__(self, scenario: Scenario, workload: ServeWorkload,
                 policy=None, time_scale: float = 1.0):
        self.scenario = scenario
        self.workload = workload
        self.policy = policy
        self.time_scale = time_scale

    def run(self) -> ScenarioResult:
        from repro_torch.serving import poisson_arrivals
        w = self.workload
        m = MetricsCollector()
        engine = w.make_engine(self.policy)
        horizon = self.scenario.horizon * self.time_scale
        cfg = engine.cfg
        for req in poisson_arrivals(
                w.request_rate / self.time_scale, horizon,
                prompt_len=w.prompt_len, max_new_tokens=w.max_new_tokens,
                vocab_size=cfg.vocab_size, seed=w.seed):
            engine.submit(req)

        for t in self.scenario.event_steps:
            engine.run_until(t * self.time_scale)
            for ev in self.scenario.events_at(t):
                stats = engine.apply_event(ev)
                m.record_recovery(
                    t, ev,
                    {"migration": stats["stall_seconds"],
                     "total": stats["stall_seconds"]},
                    serving={k: stats[k] for k in
                             ("replicas", "policy", "migrated", "rebuilt",
                              "dropped", "kv_bytes_moved")})
            m.record_step(t, clock=engine.clock, queued=engine.n_queued,
                          active=engine.n_active,
                          alive_replicas=len(engine.replicas),
                          completed=engine.summary()["completed"])
        engine.run_until(horizon)

        summary = engine.summary()
        summary["horizon_seconds"] = horizon
        summary["drops_total"] = summary["dropped"]
        summary["agent_detected"] = [e.describe() for e in engine.detected]
        res = m.result(self.scenario, "serving", w.describe(), summary)
        return res


def run_serve_scenario(scenario: Scenario, workload: ServeWorkload,
                       policy=None, time_scale: float = 1.0) -> ScenarioResult:
    return ServeScenarioRunner(scenario, workload, policy=policy,
                               time_scale=time_scale).run()
