"""The port's serving engine in synthetic mode, its sampler, KV pools and
scenario runner, on the CPU against the JAX package.

Synthetic mode is the engine's host logic with deterministic stub tokens,
so the port's summaries, event logs and streams must equal the reference's
exactly under every policy and event kind.  The sampler is held bit for bit
to ``repro.serving.sample_tokens`` (``jax.random.categorical`` after
``lax.top_k``) over 240 (rid, position) pairs; its uniform bits to
``jax.random.uniform`` bitwise, its Gumbel noise to ``jax.random.gumbel``
within 2e-6 absolute (each log correctly rounded, XLA's within an ulp).
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.events import ElasticEvent as JEvent  # noqa: E402
from repro.core.events import EventKind as JKind  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.scenarios import Scenario as JScenario  # noqa: E402
from repro.scenarios import ServeWorkload as JServeWorkload  # noqa: E402
from repro.scenarios import run_serve_scenario as j_run_serve  # noqa: E402
from repro import serving as JS  # noqa: E402
from repro.core.planners.rng import stream_key as j_stream_key  # noqa: E402
from repro_torch.core.events import ElasticEvent, EventKind  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.scenarios import (Scenario, ServeWorkload,  # noqa: E402
                                   run_serve_scenario)
from repro_torch import serving as S  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

TINY = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
            vocab_size=128, dropout_rate=0.0)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_uniform_bits_equal_jax_random_uniform():
    tiny = np.finfo(np.float32).tiny
    for seed, n in ((0, 1), (5, 40), (7, 1000), (11, 92416)):
        key = jax.random.key(seed)
        kd = np.asarray(jax.random.key_data(key))
        want = np.asarray(jax.random.uniform(key, (n,), jnp.float32,
                                             minval=tiny, maxval=1.0))
        got = sampling.uniform(kd, n)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        gj = np.asarray(jax.random.gumbel(key, (n,), jnp.float32))
        np.testing.assert_allclose(sampling.gumbel(kd, n), gj, rtol=0,
                                   atol=2e-6)


def test_stream_keys_equal_the_reference():
    base = jax.random.key(3)
    for pos, rid in ((0, 0), (17, 5), (1023, 99)):
        want = np.asarray(jax.random.key_data(
            j_stream_key(base, pos, JS.SAMPLE_STREAM_ID, rid)))
        got = S.sampling.stream_key(sampling.key_from_seed(3), pos,
                                    S.SAMPLE_STREAM_ID, rid)
        np.testing.assert_array_equal(got, want)


def test_top_k_order_is_lax_top_k():
    rows = [np.array([0.0, -0.0, 1.0, 1.0, -0.0, 0.0], np.float32),
            np.random.default_rng(0).integers(-3, 3, 64).astype(np.float32),
            np.random.default_rng(1).standard_normal(5000)
            .astype(np.float32)]
    for row in rows:
        for k in sorted({min(k, len(row)) for k in (1, 3, 5, 10, 40)}
                        | {len(row)}):
            vj, ij = jax.lax.top_k(jnp.asarray(row), k)
            vt, it = sampling.top_k(row, k)
            np.testing.assert_array_equal(it, np.asarray(ij))
            np.testing.assert_array_equal(vt.view(np.uint32),
                                          np.asarray(vj).view(np.uint32))


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(method="topk", temperature=0.7, top_k=8, seed=3),
    dict(method="topk", temperature=1.0, top_k=0, seed=1),
    dict(method="topk", temperature=0.7, top_k=40, seed=0),
], ids=["greedy", "top8", "full", "top40"])
def test_sample_tokens_equal_the_reference(cfg):
    rng = np.random.default_rng(len(cfg))
    logits = rng.standard_normal((240, 256)).astype(np.float32) * 2
    rids = [int(r) for r in rng.integers(0, 1000, 240)]
    pos = [int(p) for p in rng.integers(0, 4096, 240)]
    want = JS.sample_tokens(logits, rids, pos, JS.SamplerConfig(**cfg))
    got = S.sample_tokens(logits, rids, pos, S.SamplerConfig(**cfg))
    np.testing.assert_array_equal(got, want)


def test_sample_tokens_content_addressed():
    sc = S.SamplerConfig(method="topk", temperature=0.8, top_k=4, seed=1)
    logits = np.random.default_rng(0).standard_normal((2, 32))
    a = S.sample_tokens(logits, [5, 9], [3, 3], sc)
    c = S.sample_tokens(logits[::-1], [9, 5], [3, 3], sc)
    assert int(c[1]) == int(a[0])


# ---------------------------------------------------------------------------
# KV pools
# ---------------------------------------------------------------------------
def test_migrate_slot_moves_exact_arrays():
    caches = [{"k": torch.arange(3 * 8 * 4, dtype=torch.float32)
               .reshape(3, 8, 4) + 100 * layer} for layer in range(2)]
    src = S.KVPool(3, caches)
    dst = S.KVPool(3, [{"k": torch.zeros(3, 8, 4)} for _ in range(2)])
    src.assign(1, rid=7, length=5)
    moved = S.migrate_slot(src, 1, dst, 2, rid=7)
    assert moved == 2 * 8 * 4 * 4
    assert src.slot_req[1] == -1 and dst.slot_req[2] == 7
    assert int(dst.lengths[2]) == 5
    for d, c in zip(dst.caches, caches):
        assert torch.equal(d["k"][2], c["k"][1])
        assert not d["k"][:2].any()


@pytest.mark.parametrize("family,kw", [
    ("dense", TINY), ("dense", dict(TINY, num_kv_heads=2)),
    ("ssm", dict(num_layers=2)), ("moe", {}),
    ("dense", dict(dtype="bfloat16")),
])
def test_slot_kv_bytes_equal_the_reference(family, kw):
    want = JS.slot_kv_bytes(JR.tiny_config(family, **kw), 40)
    assert S.slot_kv_bytes(R.tiny_config(family, **kw), 40) == want


@pytest.mark.parametrize("arch", ["codeqwen1p5_7b", "mamba2_2p7b"])
def test_full_size_slot_kv_bytes_equal_the_reference(arch):
    from repro import configs as jconfigs
    from repro_torch import configs
    assert S.slot_kv_bytes(configs.get_config(arch), 1089) == \
        JS.slot_kv_bytes(jconfigs.get_config(arch), 1089)


# ---------------------------------------------------------------------------
# synthetic engine twins
# ---------------------------------------------------------------------------
def _engines(policy=None, n_replicas=2, slots=2, slo=None, max_len=32,
             ranks_per_replica=1):
    kw = dict(n_replicas=n_replicas, slots_per_replica=slots,
              max_len=max_len, mode="synthetic",
              ranks_per_replica=ranks_per_replica)
    jp = None if policy is None else JS.SERVE_POLICIES[policy]
    tp = None if policy is None else S.SERVE_POLICIES[policy]
    j = JS.ServingEngine(JR.tiny_config("dense", **TINY), policy=jp,
                         slo=None if slo is None else JS.SLO(*slo), **kw)
    t = S.ServingEngine(R.tiny_config("dense", **TINY), policy=tp,
                        slo=None if slo is None else S.SLO(*slo),
                        device="cpu", **kw)
    return j, t


def _submit(engines, n, prompt_len=6, max_new=4, seed=0, spacing=0.0):
    for eng, Req in zip(engines, (JS.Request, S.Request)):
        rng = np.random.default_rng(seed)
        for rid in range(n):
            prompt = rng.integers(0, 128, size=prompt_len).astype(np.int32)
            eng.submit(Req(rid=rid, arrival=rid * spacing, prompt=prompt,
                           max_new_tokens=max_new))


def _same(j, t):
    assert json.dumps(t.summary(), sort_keys=True) == \
        json.dumps(j.summary(), sort_keys=True)
    assert t.event_log == j.event_log
    assert {r: (q.generated, q.state.value, q.migrations, q.prefills)
            for r, q in t.requests.items()} == \
        {r: (q.generated, q.state.value, q.migrations, q.prefills)
         for r, q in j.requests.items()}
    assert [e.describe() for e in t.detected] == \
        [e.describe() for e in j.detected]


EVENTS = [
    ("scale_in", ((JKind.SCALE_IN, EventKind.SCALE_IN), 0, (0,), {})),
    ("fail_stop", ((JKind.FAIL_STOP, EventKind.FAIL_STOP), 0, (1,), {})),
    ("scale_out", ((JKind.SCALE_OUT, EventKind.SCALE_OUT), 0, (4,), {})),
    ("fail_slow", ((JKind.FAIL_SLOW, EventKind.FAIL_SLOW), 0, (0,),
                   {"slow_factor": 3.0})),
    ("dvfs_set", ((JKind.DVFS_SET, EventKind.DVFS_SET), 0, (1,),
                  {"freq": 0.5})),
    ("scale_in_burst", ((JKind.SCALE_IN, EventKind.SCALE_IN), 0, (0, 2),
                        {})),
]


@pytest.mark.parametrize("policy", sorted(S.SERVE_POLICIES))
@pytest.mark.parametrize("name,event", EVENTS, ids=[e[0] for e in EVENTS])
def test_synthetic_summaries_and_logs_equal(policy, name, event):
    (jk, tk), step, ranks, extra = event
    j, t = _engines(policy, n_replicas=3, slots=3)
    _submit((j, t), 12, max_new=6, spacing=0.01)
    for _ in range(3):
        j.tick()
        t.tick()
    sj = j.apply_event(JEvent(jk, step, ranks, **extra))
    st = t.apply_event(ElasticEvent(tk, step, ranks, **extra))
    assert st == sj
    j.drain()
    t.drain()
    _same(j, t)


def test_fail_stop_rebuilds_and_streams_unchanged():
    base_j, base_t = _engines()
    _submit((base_j, base_t), 4)
    base_t.drain()
    want = [base_t.requests[r].generated for r in range(4)]
    j, t = _engines()
    _submit((j, t), 4)
    for eng, ev in ((j, JEvent(JKind.FAIL_STOP, 0, (0,))),
                    (t, ElasticEvent(EventKind.FAIL_STOP, 0, (0,)))):
        eng.tick()
        eng.tick()
        stats = eng.apply_event(ev)
        assert stats["rebuilt"] == 2 and stats["dropped"] == 0
        eng.drain()
    assert [t.requests[r].generated for r in range(4)] == want
    _same(j, t)


def test_drop_with_full_survivors():
    j, t = _engines(policy="drop")
    _submit((j, t), 6)
    for eng, ev in ((j, JEvent(JKind.SCALE_IN, 0, (0,))),
                    (t, ElasticEvent(EventKind.SCALE_IN, 0, (0,)))):
        eng.tick()
        eng.tick()
        stats = eng.apply_event(ev)
        assert stats["dropped"] == 2 and stats["kv_bytes_moved"] == 0
        eng.drain()
    assert t.summary()["dropped"] == 2 and t.summary()["completed"] == 4
    _same(j, t)


def test_scale_out_registers_the_agent_rank():
    _, t = _engines(n_replicas=1)
    t.apply_event(ElasticEvent(EventKind.SCALE_OUT, 0, (3,)))
    assert sorted(t.replicas) == [0, 3] and t.agent.ranks == [0, 3]


# ---------------------------------------------------------------------------
# SLO admission
# ---------------------------------------------------------------------------
def test_blown_ttft_is_rejected_at_first_admission():
    j, t = _engines(slo=(0.01, 1.0), max_len=80)
    for eng, Req in ((j, JS.Request), (t, S.Request)):
        eng.submit(Req(rid=0, arrival=0.0, prompt=np.zeros(64, np.int32),
                       max_new_tokens=4))
        eng.tick()
    assert t.requests[0].state == S.RequestState.REJECTED
    assert t.summary()["rejected"] == 1
    _same(j, t)


def test_full_pools_defer_but_eventually_serve():
    j, t = _engines(n_replicas=1, slots=2)
    _submit((j, t), 5)
    j.tick()
    t.tick()
    assert t.n_active == 2 and t.deferrals >= 1
    j.drain()
    t.drain()
    assert t.summary()["completed"] == 5 and t.summary()["rejected"] == 0
    _same(j, t)


def test_per_token_slo_defers_admission():
    """A per-token budget that one more slot would blow defers the
    queue though slots are free."""
    j, t = _engines(n_replicas=1, slots=4, slo=(10.0, 0.025))
    _submit((j, t), 4, spacing=0.0)
    j.tick()
    t.tick()
    assert t.n_active == 2 and t.deferrals == 1
    j.drain()
    t.drain()
    _same(j, t)


# ---------------------------------------------------------------------------
# scenario runner
# ---------------------------------------------------------------------------
TRACE = [(60, 0), (60, 1), (60, 2), (60, 0)]


@pytest.mark.parametrize("policy", sorted(S.SERVE_POLICIES))
def test_serve_scenario_on_a_capacity_trace_equals_the_reference(policy):
    kw = dict(mode="synthetic", request_rate=0.15, max_new_tokens=48,
              max_len=80)
    rj = j_run_serve(JScenario.from_capacity_trace("serve_t", TRACE, dp=4,
                                                   pp=2),
                     JServeWorkload(**kw), policy=JS.SERVE_POLICIES[policy],
                     time_scale=0.02)
    rt = run_serve_scenario(Scenario.from_capacity_trace("serve_t", TRACE,
                                                         dp=4, pp=2),
                            ServeWorkload(device="cpu", **kw),
                            policy=S.SERVE_POLICIES[policy], time_scale=0.02)
    bj, bt = json.loads(rj.to_json()), json.loads(rt.to_json())
    assert bt["workload"].pop("device") == "cpu"
    assert bt == bj
    assert bt["mode"] == "serving" and bt["recoveries"]
    if policy == "drop":
        assert bt["summary"]["dropped"] > 0
    else:
        assert bt["summary"]["dropped"] == 0


def test_serving_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.ServingEngine(R.tiny_config("dense", **TINY), mode="synthetic")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeWorkload().make_engine()
