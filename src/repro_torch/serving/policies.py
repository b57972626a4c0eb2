"""Serving recovery policies: what happens to in-flight requests when a
replica leaves.  A copy of ``repro.serving.policies`` (the JAX package).

A policy maps an elastic event to a *disposition* for each in-flight request
on the departing replica:

* ``"migrate"`` — gather the slot's KV pytree and scatter it into a free
  slot on a survivor (graceful capacity changes: the KV still exists);
* ``"rebuild"`` — requeue with the full token prefix and re-prefill on a
  survivor (the KV is gone — fail-stop — but the control plane's prefix
  record reconstructs it; recompute cost, zero request loss);
* ``"drop"``   — fail the request (the restart-the-world baseline).

``ElasWaveServePolicy`` is the paper-native choice (never drop),
``DropPolicy`` the TorchFT-style baseline, and ``ChameleonServePolicy`` the
per-event selector from PAPERS.md's Chameleon: it picks a disposition per
event kind/state instead of fixing one per run.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.events import ElasticEvent, EventKind

MIGRATE, REBUILD, DROP = "migrate", "rebuild", "drop"


class ServeRecoveryPolicy:
    name = "base"

    def disposition(self, ev: ElasticEvent) -> str:
        raise NotImplementedError

    def describe(self) -> Dict:
        return {"name": self.name}


class ElasWaveServePolicy(ServeRecoveryPolicy):
    """Zero-loss: migrate KV on graceful scale-in; rebuild from the prefix
    record on fail-stop (KV on the failed replica is unrecoverable)."""
    name = "elaswave_migrate"

    def disposition(self, ev: ElasticEvent) -> str:
        return REBUILD if ev.kind == EventKind.FAIL_STOP else MIGRATE


class RebuildServePolicy(ServeRecoveryPolicy):
    """Always requeue-with-prefix (no KV movement): simpler data plane,
    pays re-prefill recompute on every capacity change."""
    name = "rebuild"

    def disposition(self, ev: ElasticEvent) -> str:
        return REBUILD


class DropPolicy(ServeRecoveryPolicy):
    """TorchFT-style: in-flight work on a departing replica is lost."""
    name = "drop"

    def disposition(self, ev: ElasticEvent) -> str:
        return DROP


class ChameleonServePolicy(ServeRecoveryPolicy):
    """Per-event policy selection (Chameleon, PAPERS.md): graceful events
    migrate; fail-stops rebuild; an explicit override map can pin choices."""
    name = "chameleon"

    def __init__(self, overrides: Dict[EventKind, str] = None):
        self.overrides = dict(overrides or {})

    def disposition(self, ev: ElasticEvent) -> str:
        if ev.kind in self.overrides:
            return self.overrides[ev.kind]
        return REBUILD if ev.kind == EventKind.FAIL_STOP else MIGRATE

    def describe(self) -> Dict:
        return {"name": self.name,
                "overrides": {k.value: v for k, v in self.overrides.items()}}


SERVE_POLICIES = {p.name: p for p in
                  (ElasWaveServePolicy(), RebuildServePolicy(), DropPolicy(),
                   ChameleonServePolicy())}
