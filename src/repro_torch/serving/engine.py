"""Continuous-batching serving engine on the elastic recovery fabric,
mirroring ``repro.serving.engine``.

One :class:`ServingEngine` = an admission queue + a set of serving replicas,
each holding a slot-indexed KV pool (``serving/kvcache.py``).  Scheduling is
iteration-level continuous batching: every tick admits queued requests into
free slots (SLO-aware — reject when the projected TTFT is already blown,
defer when the marginal per-token latency would blow the budget), runs the
admitted requests' prefills, and runs ONE batched decode step over every
other in-flight slot.  The simulated clock advances by a deterministic cost
model, so latency metrics are replayable; token *values* come from real
model numerics (``mode="numeric"``) or a deterministic stub
(``mode="synthetic"`` — trace-scale scheduling runs).

Elastic events from ``core/events.py`` hit :meth:`apply_event`: replica
SCALE_IN / FAIL_STOP triggers KV-cache migration or prefix rebuild instead of
request loss (policy-controlled, ``serving/policies.py``), SCALE_OUT adds a
replica, FAIL_SLOW / DVFS_SET retime one.  Replica health is tracked by the
same ``core.agent.Agent`` the training plane uses, exercising its dynamic
``add_rank``/``remove_rank`` registration.

On the card (``device=None``, the default, or ``"cuda"``) the prefills run
the flash-attention and SSD kernels and every norm the rmsnorm kernel; on
the CPU (``device="cpu"``) their plain versions.  A replica's decode runs
at a fixed width: one batched step over all its slots, in place on its
pool's caches, with only the slots being decoded writing theirs
(``rows``).  So no cache is gathered or scattered on a tick, and a slot's
numbers do not depend on how many of its neighbours are busy: cuBLAS may
pick another algorithm for another batch width, and a migrated request's
stream then stays the undisturbed run's token for token.  Logits go to
the host for sampling (``sampling.py``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

import torch

from repro_torch.core.agent import Agent, Probe
from repro_torch.core.cluster import resolve_device
from repro_torch.core.events import ElasticEvent, EventKind

from .kvcache import KVPool, migrate_slot, slot_kv_bytes
from .policies import (DROP, MIGRATE, REBUILD, ElasWaveServePolicy,
                       ServeRecoveryPolicy)
from .request import Request, RequestState, SLO
from .sampling import SamplerConfig, sample_tokens


@dataclasses.dataclass(frozen=True)
class ServeCostModel:
    """Deterministic iteration timing (simulated seconds)."""
    decode_base: float = 0.015        # fixed cost of a decode iteration
    decode_per_slot: float = 0.004    # marginal cost per batched slot
    prefill_per_token: float = 0.0015
    kv_bw_bytes: float = 2e9          # migration bandwidth (bytes/s)
    detect_seconds: float = 0.5       # fail-stop detection bound
    idle_quantum: float = 0.05

    def decode_seconds(self, n_slots: int) -> float:
        return self.decode_base + self.decode_per_slot * n_slots if n_slots \
            else 0.0

    def prefill_seconds(self, n_tokens: int) -> float:
        return self.prefill_per_token * n_tokens

    def migration_seconds(self, nbytes: int) -> float:
        return nbytes / self.kv_bw_bytes


@dataclasses.dataclass
class Replica:
    rid: int
    pool: KVPool
    slow: float = 1.0     # fail-slow multiplier (>= 1)
    freq: float = 1.0     # DVFS setpoint

    @property
    def time_factor(self) -> float:
        return self.slow / max(self.freq, 1e-6)


def _fake_token(rid: int, pos: int, vocab: int) -> int:
    """Synthetic-mode token stream: deterministic in (rid, pos) only, so it
    is invariant under migration by construction."""
    return (rid * 7919 + pos * 104729 + 17) % vocab


class ServingEngine:
    def __init__(self, cfg, *, n_replicas: int = 2, slots_per_replica: int = 4,
                 max_len: int = 64, mode: str = "numeric", params=None,
                 seed: int = 0, sampler: Optional[SamplerConfig] = None,
                 slo: Optional[SLO] = None,
                 cost: Optional[ServeCostModel] = None,
                 policy: Optional[ServeRecoveryPolicy] = None,
                 ranks_per_replica: int = 1, device=None):
        """``params``: the port's ``(stem, layers, head)`` on ``device``
        (``weights.params_from_stacked`` turns the reference's tree into
        it); None draws them from ``seed`` on the device.  ``device``:
        None means the card, and raises when none is visible."""
        assert mode in ("numeric", "synthetic"), mode
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.max_len = max_len
        self.slots_per_replica = slots_per_replica
        self.sampler = sampler or SamplerConfig()
        self.slo = slo or SLO()
        self.cost = cost or ServeCostModel()
        self.policy = policy or ElasWaveServePolicy()
        self.ranks_per_replica = max(int(ranks_per_replica), 1)
        self.seed = seed

        self.hooks = None
        self.params = None
        #: called as ``logit_hook(rids, positions, logits)`` with the host
        #: float32 logits [n, V] each sampling step reads (a probe for
        #: checks against a no-cache forward); None: not called
        self.logit_hook: Optional[Callable] = None
        if mode == "numeric":
            from repro_torch.models import registry as R
            self.hooks = R.serving_hooks(cfg, self.device)
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                params = R.init_model(gen, cfg)
            self.params = params
        self._slot_bytes = slot_kv_bytes(cfg, max_len)

        self.replicas: Dict[int, Replica] = {}
        for rid in range(n_replicas):
            self.replicas[rid] = self._make_replica(rid)
        self.agent = Agent(num_ranks=n_replicas)

        self.clock = 0.0
        self.queue: Deque[Request] = deque()
        self.requests: Dict[int, Request] = {}
        self.event_log: List[Dict] = []
        self.detected: List[ElasticEvent] = []   # agent-raised (fail-slow)
        self.deferrals = 0
        self.tokens_decoded = 0
        self.ticks = 0
        self.decode_calls = 0      # batched decode steps run (all replicas)

    # ------------------------------------------------------------------
    # replicas
    # ------------------------------------------------------------------
    def _make_replica(self, rid: int) -> Replica:
        caches = (self.hooks.init_caches(self.slots_per_replica, self.max_len)
                  if self.mode == "numeric" else None)
        pool = KVPool(self.slots_per_replica, caches,
                      slot_bytes=self._slot_bytes)
        return Replica(rid=rid, pool=pool)

    def alive_replicas(self) -> List[Replica]:
        return [self.replicas[r] for r in sorted(self.replicas)]

    @property
    def n_active(self) -> int:
        return sum(r.pool.n_active for r in self.replicas.values())

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        assert len(req.prompt) + req.max_new_tokens <= self.max_len, \
            "request does not fit the KV slot"
        self.requests[req.rid] = req
        self.queue.append(req)

    def _pick_replica(self) -> Optional[Replica]:
        """Most free slots, respecting the per-token SLO projection; ties go
        to the lowest replica id (determinism)."""
        best = None
        for rep in self.alive_replicas():
            if rep.pool.n_free == 0:
                continue
            proj = self.cost.decode_seconds(rep.pool.n_active + 1) \
                * rep.time_factor
            if proj > self.slo.per_token:
                continue
            if best is None or rep.pool.n_free > best.pool.n_free:
                best = rep
        return best

    def _admit(self) -> List[Request]:
        admitted: List[Request] = []
        while self.queue:
            req = self.queue[0]
            if req.arrival > self.clock:
                break
            prefix_len = len(req.prefix)
            # SLO admission: a request whose projected TTFT is already blown
            # can only get worse — reject it now (first admission only;
            # requeued in-flight requests are never rejected, that would be
            # a drop by another name).
            projected_ttft = (self.clock - req.arrival
                              + self.cost.prefill_seconds(prefix_len)
                              + self.cost.decode_seconds(self.n_active + 1))
            if req.prefills == 0 and projected_ttft > self.slo.ttft:
                self.queue.popleft()
                req.state = RequestState.REJECTED
                req.finish_time = self.clock
                continue
            rep = self._pick_replica()
            if rep is None:
                # defer: either no free slot anywhere, or admitting would
                # blow the per-token budget for in-flight requests
                self.deferrals += 1
                break
            self.queue.popleft()
            slots = rep.pool.free_slots()
            slot = slots[0]
            rep.pool.assign(slot, req.rid, length=0)   # length set at prefill
            req.state = RequestState.ACTIVE
            req.replica, req.slot = rep.rid, slot
            if req.admit_time is None:
                req.admit_time = self.clock
            req.prefills += 1
            admitted.append(req)
        return admitted

    # ------------------------------------------------------------------
    # numerics
    # ------------------------------------------------------------------
    def _prefill_one(self, req: Request) -> int:
        """Prefill the request's full prefix into its slot and sample the
        next token.  Returns the number of tokens prefilled."""
        rep = self.replicas[req.replica]
        prefix = req.prefix
        pos = len(prefix)                      # position of the sampled token
        if self.mode == "numeric":
            caches1 = self.hooks.init_caches(1, self.max_len)
            extras1 = self.hooks.prepare_extras(self.params, req)
            logits, caches1 = self.hooks.prefill(
                self.params, self._tokens(prefix[None, :]), caches1, extras1)
            tok = int(self._sample(logits, [req.rid], [pos])[0])
            rep.pool.write(req.slot, caches1, extras1)
        else:
            tok = _fake_token(req.rid, pos, self.cfg.vocab_size)
        rep.pool.lengths[req.slot] = pos
        req.generated.append(tok)
        self.tokens_decoded += 1
        return len(prefix)

    def _decode_replica(self, rep: Replica, skip_rids: set) -> int:
        """One batched decode step over the replica's in-flight slots
        (excluding this tick's fresh prefills).  Returns slots decoded."""
        ids = [s for s in rep.pool.active_slots()
               if rep.pool.slot_req[s] not in skip_rids]
        ids = [s for s in ids
               if not self.requests[int(rep.pool.slot_req[s])].done]
        if not ids:
            return 0
        reqs = [self.requests[int(rep.pool.slot_req[s])] for s in ids]
        self.decode_calls += 1
        positions = rep.pool.lengths[ids]            # write index per slot
        sample_pos = [int(p) + 1 for p in positions]  # token being sampled
        if self.mode == "numeric":
            # every slot of the pool, in place; only ``ids`` write caches
            toks = np.zeros((rep.pool.n_slots, 1), dtype=np.int64)
            toks[ids, 0] = [r.generated[-1] for r in reqs]
            pos_all = np.zeros(rep.pool.n_slots, dtype=np.int64)
            pos_all[ids] = positions
            logits, _ = self.hooks.decode_step(
                self.params, self._tokens(toks), rep.pool.caches,
                self._tokens(pos_all), rep.pool.extras,
                rows=self._tokens(np.asarray(ids)))
            nxt = self._sample(logits[self._tokens(np.asarray(ids))],
                               [r.rid for r in reqs], sample_pos)
        else:
            nxt = [_fake_token(r.rid, p, self.cfg.vocab_size)
                   for r, p in zip(reqs, sample_pos)]
        for s, r, t in zip(ids, reqs, nxt):
            rep.pool.lengths[s] += 1
            r.generated.append(int(t))
            self.tokens_decoded += 1
        return len(ids)

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        """Host int64 ids or positions -> a tensor on the engine's device."""
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.device)

    def _sample(self, logits: torch.Tensor, rids, positions) -> np.ndarray:
        host = logits.float().cpu().numpy()
        if self.logit_hook is not None:
            self.logit_hook(list(rids), list(positions), host)
        return sample_tokens(host, rids, positions, self.sampler)

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------
    def tick(self) -> float:
        """One continuous-batching iteration; returns simulated seconds."""
        self.ticks += 1
        if not self.replicas:
            dt = self._idle_dt()
            self.clock += dt
            return dt
        admitted = self._admit()
        fresh = {r.rid for r in admitted}
        prefill_tokens: Dict[int, int] = {}
        for req in admitted:
            prefill_tokens[req.replica] = (prefill_tokens.get(req.replica, 0)
                                           + self._prefill_one(req))
        dt = 0.0
        for rep in self.alive_replicas():
            n = self._decode_replica(rep, fresh)
            pf = prefill_tokens.get(rep.rid, 0)
            if n or pf:
                rep_dt = (self.cost.decode_seconds(n)
                          + self.cost.prefill_seconds(pf)) * rep.time_factor
                dt = max(dt, rep_dt)
        if dt == 0.0:
            dt = self._idle_dt()
        self.clock += dt
        self._timestamp_and_retire(fresh)
        self._observe_health(dt)
        return dt

    def _idle_dt(self) -> float:
        """Nothing to compute: jump to the next arrival if one is pending."""
        future = [r.arrival for r in self.queue if r.arrival > self.clock]
        if future:
            return min(future) - self.clock
        return self.cost.idle_quantum

    def _timestamp_and_retire(self, fresh: set):
        del fresh
        for rep in self.alive_replicas():
            for s in rep.pool.active_slots():
                req = self.requests[int(rep.pool.slot_req[s])]
                if req.first_token_time is None and req.generated:
                    req.first_token_time = self.clock
                if req.done:
                    req.finish_time = self.clock
                    req.state = RequestState.DONE
                    rep.pool.release(s)
                    req.replica = req.slot = -1

    def _observe_health(self, dt: float):
        """Feed the training-plane Agent the serving replicas' heartbeats —
        the same probe protocol, replicas as ranks."""
        probes = [Probe(step=self.ticks, rank=rep.rid, heartbeat=True,
                        step_seconds=dt * rep.time_factor)
                  for rep in self.alive_replicas()]
        self.detected.extend(self.agent.observe(probes))

    def run_until(self, t_end: float, max_ticks: int = 2_000_000):
        """Advance the simulated clock to ``t_end``; idle spans (no active
        slots, no due arrivals) fast-forward instead of ticking, clamped to
        ``t_end`` so elastic events are applied at their trace time."""
        while self.clock < t_end and max_ticks:
            if self.n_active == 0 and \
                    not any(r.arrival <= self.clock for r in self.queue):
                future = [r.arrival for r in self.queue]
                self.clock = min(min(future) if future else t_end, t_end)
                if self.clock >= t_end:
                    break
                continue
            self.tick()
            max_ticks -= 1

    def drain(self, max_ticks: int = 100_000):
        """Run until every submitted request has left the system."""
        while max_ticks and (self.queue or self.n_active):
            self.tick()
            max_ticks -= 1
        assert not (self.queue or self.n_active), "drain did not converge"

    # ------------------------------------------------------------------
    # elastic events
    # ------------------------------------------------------------------
    def _event_replicas(self, ev: ElasticEvent) -> List[int]:
        return sorted({r // self.ranks_per_replica for r in ev.ranks})

    def apply_event(self, ev: ElasticEvent) -> Dict[str, Any]:
        """event -> plan (policy disposition) -> apply: the serving side of
        the paper's recovery path.  Returns the per-event stats record."""
        stats = {"t": self.clock, "kind": ev.kind.value,
                 "replicas": self._event_replicas(ev),
                 "policy": self.policy.name, "migrated": 0, "rebuilt": 0,
                 "dropped": 0, "kv_bytes_moved": 0, "stall_seconds": 0.0}
        if ev.kind == EventKind.SCALE_OUT:
            for rid in stats["replicas"]:
                if rid not in self.replicas:
                    self.replicas[rid] = self._make_replica(rid)
                    self.agent.add_rank(rid)
        elif ev.kind in (EventKind.SCALE_IN, EventKind.FAIL_STOP):
            for rid in stats["replicas"]:
                if rid in self.replicas:
                    self._remove_replica(rid, ev, stats)
            if ev.kind == EventKind.FAIL_STOP:
                stats["stall_seconds"] += self.cost.detect_seconds
        elif ev.kind == EventKind.FAIL_SLOW:
            for rid in stats["replicas"]:
                if rid in self.replicas:
                    self.replicas[rid].slow = max(
                        self.replicas[rid].slow, ev.slow_factor)
        elif ev.kind == EventKind.DVFS_SET:
            for rid in stats["replicas"]:
                if rid in self.replicas:
                    self.replicas[rid].freq = ev.freq
        else:
            raise ValueError(f"unsupported serving event kind: {ev.kind}")
        self.clock += stats["stall_seconds"]
        self.event_log.append(stats)
        return stats

    def _remove_replica(self, rid: int, ev: ElasticEvent, stats: Dict):
        rep = self.replicas.pop(rid)
        self.agent.remove_rank(rid)
        disposition = self.policy.disposition(ev)
        requeue: List[Request] = []
        for s in rep.pool.active_slots():
            req = self.requests[int(rep.pool.slot_req[s])]
            action = disposition
            if action == MIGRATE:
                dst = self._pick_migration_target()
                if dst is None:
                    action = REBUILD       # no survivor capacity: rebuild
                else:
                    dslot = dst.pool.free_slots()[0]
                    stats["kv_bytes_moved"] += migrate_slot(
                        rep.pool, s, dst.pool, dslot, req.rid)
                    req.replica, req.slot = dst.rid, dslot
                    req.migrations += 1
                    stats["migrated"] += 1
                    continue
            if action == REBUILD:
                rep.pool.release(s)
                req.state = RequestState.QUEUED
                req.replica = req.slot = -1
                req.migrations += 1
                requeue.append(req)
                stats["rebuilt"] += 1
            elif action == DROP:
                rep.pool.release(s)
                req.state = RequestState.DROPPED
                req.finish_time = self.clock
                req.replica = req.slot = -1
                stats["dropped"] += 1
        # requeued in-flight requests go to the FRONT (oldest first) so the
        # rebuild is not starved by fresh arrivals
        for req in reversed(requeue):
            self.queue.appendleft(req)
        stats["stall_seconds"] += self.cost.migration_seconds(
            stats["kv_bytes_moved"])

    def _pick_migration_target(self) -> Optional[Replica]:
        best = None
        for rep in self.alive_replicas():
            if rep.pool.n_free == 0:
                continue
            if best is None or rep.pool.n_free > best.pool.n_free:
                best = rep
        return best

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        reqs = list(self.requests.values())
        done = [r for r in reqs if r.state == RequestState.DONE]
        ttfts = np.array([r.ttft for r in done if r.ttft is not None])
        ptls = np.array([r.per_token_latency for r in done
                         if r.per_token_latency is not None])
        slo_ok = [r for r in done if r.meets(self.slo)]
        horizon = max(self.clock, 1e-9)

        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else None

        return {
            "policy": self.policy.name,
            "sampler": self.sampler.describe(),
            "n_requests": len(reqs),
            "completed": len(done),
            "dropped": sum(r.state == RequestState.DROPPED for r in reqs),
            "rejected": sum(r.state == RequestState.REJECTED for r in reqs),
            "in_flight_at_end": self.n_active + self.n_queued,
            "deferrals": self.deferrals,
            "migrations": sum(r.migrations for r in reqs),
            "re_prefills": sum(max(r.prefills - 1, 0) for r in reqs),
            "tokens_decoded": self.tokens_decoded,
            "ttft_p50": pct(ttfts, 50), "ttft_p99": pct(ttfts, 99),
            "per_token_p50": pct(ptls, 50), "per_token_p99": pct(ptls, 99),
            "slo_attainment": len(slo_ok) / len(done) if done else None,
            "goodput_tokens_per_s":
                sum(len(r.generated) for r in slo_ok) / horizon,
            "kv_bytes_moved": sum(e["kv_bytes_moved"] for e in self.event_log),
            "drops_per_capacity_change": [
                {"t": e["t"], "kind": e["kind"], "replicas": e["replicas"],
                 "dropped": e["dropped"], "migrated": e["migrated"],
                 "rebuilt": e["rebuilt"],
                 "stall_seconds": e["stall_seconds"]}
                for e in self.event_log
                if e["kind"] in ("scale_in", "scale_out", "fail_stop")],
        }


# ---------------------------------------------------------------------------
# offline convenience (launch/serve.py and examples/torch_serve.py wrappers)
# ---------------------------------------------------------------------------
def offline_generate(cfg, *, batch: int = 4, prompt_len: int = 32,
                     max_new_tokens: int = 16, seed: int = 0,
                     sampler: Optional[SamplerConfig] = None, params=None,
                     device=None) -> Dict[str, Any]:
    """Batch-generate through the serving engine (single replica, offline
    SLO): the shared implementation behind ``launch/serve.py --smoke`` and
    ``examples/torch_serve.py``."""
    rng = np.random.default_rng(seed)
    engine = ServingEngine(
        cfg, n_replicas=1, slots_per_replica=batch,
        max_len=prompt_len + max_new_tokens + 1, mode="numeric",
        params=params, seed=seed, sampler=sampler or SamplerConfig(),
        slo=SLO(ttft=1e9, per_token=1e9), device=device)
    t0 = time.perf_counter()
    for b in range(batch):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=prompt_len).astype(np.int32)
        engine.submit(Request(rid=b, arrival=0.0, prompt=prompt,
                              max_new_tokens=max_new_tokens))
    engine.drain()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    seqs = np.stack([np.asarray(engine.requests[b].generated)
                     for b in range(batch)])
    return {"sequences": seqs, "wall_seconds": wall,
            "summary": engine.summary(), "engine": engine}
