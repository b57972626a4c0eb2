"""Serving requests, SLOs and deterministic arrival workloads: a copy of
``repro.serving.request`` (the JAX package), which is plain numpy, without
the enc-dec requests' encoder frames (enc-dec serving is not ported).

A :class:`Request` is the serving plane's unit of work: a timestamped prompt
plus a generation budget.  The control plane keeps the full token prefix
(prompt + generated) for every in-flight request, which is what makes the
recovery fabric's zero-loss guarantee possible: KV state lost to a fail-stop
can always be rebuilt by re-prefilling the prefix, and KV state threatened by
a graceful scale-in can be migrated outright (see ``serving/kvcache.py``).

Arrivals are generated deterministically (seeded exponential gaps), so
scenario replays are reproducible — the serving analogue of the training
side's seeded ``GlobalBatchSampler``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"        # waiting for admission (includes requeued)
    ACTIVE = "active"        # holds a slot, decoding
    DONE = "done"
    REJECTED = "rejected"    # SLO-aware admission turned it away
    DROPPED = "dropped"      # lost in-flight to a capacity change


@dataclasses.dataclass(frozen=True)
class SLO:
    """Latency budgets driving admission (reject/defer) and goodput."""
    ttft: float = 3.0         # seconds to first token
    per_token: float = 0.25   # seconds per decode token (steady state)


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt: np.ndarray                       # [P] int32 token ids
    max_new_tokens: int

    state: RequestState = RequestState.QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    admit_time: Optional[float] = None       # first admission
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    replica: int = -1
    slot: int = -1
    migrations: int = 0                      # KV gather/scatter moves
    prefills: int = 0                        # admissions (1 + requeues)

    @property
    def prefix(self) -> np.ndarray:
        """prompt + generated-so-far: what a re-prefill must replay."""
        gen = np.asarray(self.generated, dtype=self.prompt.dtype)
        return np.concatenate([self.prompt, gen]) if len(gen) else self.prompt

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def per_token_latency(self) -> Optional[float]:
        """Mean decode latency after the first token."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = len(self.generated) - 1
        if n <= 0:
            return 0.0
        return (self.finish_time - self.first_token_time) / n

    def meets(self, slo: SLO) -> bool:
        t, p = self.ttft, self.per_token_latency
        return (t is not None and p is not None
                and t <= slo.ttft and p <= slo.per_token)

    def record(self) -> Dict:
        return {
            "rid": self.rid, "arrival": self.arrival,
            "state": self.state.value, "prompt_len": int(len(self.prompt)),
            "generated": len(self.generated), "ttft": self.ttft,
            "per_token": self.per_token_latency,
            "migrations": self.migrations, "prefills": self.prefills,
        }


def poisson_arrivals(rate: float, horizon: float, *, prompt_len: int,
                     max_new_tokens: int, vocab_size: int,
                     seed: int = 0) -> List[Request]:
    """Deterministic request stream: seeded exponential inter-arrival gaps,
    seeded random prompts."""
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    t, rid = 0.0, 0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= horizon:
            break
        prompt = rng.integers(0, vocab_size, size=prompt_len).astype(np.int32)
        out.append(Request(rid=rid, arrival=t, prompt=prompt,
                           max_new_tokens=max_new_tokens))
        rid += 1
    return out
