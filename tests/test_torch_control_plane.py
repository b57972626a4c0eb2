"""The port's control plane against the JAX package's, module by module.

The control plane is numpy in both packages (the port keeps its own copies);
the same seeded random inputs through each module must give identical
output: communicator ``OpStats`` (counts and seconds) and group tables,
``ClusterView`` reductions, the four planners, ``ScheduleEngine`` plans,
``migration_timing``, ``simulate_1f1b``, ``SegmentCosts``, and the
``Agent``/``ElasticController`` event streams over probe traces with misses,
flaps, slow ranks and memory pressure.  ``LiveRemap.compute_plan`` must give
the same moves, and ``LiveRemap.execute`` on CPU tensors the same bytes as
the reference's on numpy arrays.  Values are compared with ``==``: no
tolerance.
"""
import dataclasses
import enum
import random

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # container lacks hypothesis -> deterministic stub
    from _hypothesis_stub import given, settings, strategies as st

pytest.importorskip("jax")

import repro.configs.codeqwen1p5_7b as j_codeqwen  # noqa: E402
import repro.configs.mamba2_2p7b as j_mamba2  # noqa: E402
from repro.core import agent as j_agent  # noqa: E402
from repro.core import clusterview as j_cv  # noqa: E402
from repro.core import communicator as j_comm  # noqa: E402
from repro.core import controller as j_ctl  # noqa: E402
from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import events as j_events  # noqa: E402
from repro.core import migration as j_migr  # noqa: E402
from repro.core import pipeline as j_pipe  # noqa: E402
from repro.core import planners as j_pl  # noqa: E402
from repro.core import statespace as j_ss  # noqa: E402
from repro.core import zero as j_zero  # noqa: E402
from repro.core.fabric import remap as j_remap  # noqa: E402
from repro.models.registry import tiny_config as j_tiny  # noqa: E402

import repro_torch.configs.codeqwen1p5_7b as t_codeqwen  # noqa: E402
import repro_torch.configs.mamba2_2p7b as t_mamba2  # noqa: E402
from repro_torch.core import agent as t_agent  # noqa: E402
from repro_torch.core import clusterview as t_cv  # noqa: E402
from repro_torch.core import communicator as t_comm  # noqa: E402
from repro_torch.core import controller as t_ctl  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import events as t_events  # noqa: E402
from repro_torch.core import migration as t_migr  # noqa: E402
from repro_torch.core import pipeline as t_pipe  # noqa: E402
from repro_torch.core import planners as t_pl  # noqa: E402
from repro_torch.core import statespace as t_ss  # noqa: E402
from repro_torch.core import zero as t_zero  # noqa: E402
from repro_torch.core.fabric import remap as t_remap  # noqa: E402
from repro_torch.models.registry import tiny_config as t_tiny  # noqa: E402


def norm(x):
    """A plain-Python image of ``x`` that two packages' objects share:
    dataclasses -> (class name, fields), enums -> value, arrays -> lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.tolist())
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return "set", sorted(norm(v) for v in x)
    return x


def event_pair(kind: str, step: int, ranks, **kw):
    return (j_events.ElasticEvent(j_events.EventKind(kind), step, ranks, **kw),
            t_events.ElasticEvent(t_events.EventKind(kind), step, ranks, **kw))


# --------------------------------------------------------------------------
# events, communicator
# --------------------------------------------------------------------------
def test_events_and_bursts():
    for kind in j_events.EventKind:
        a = j_events.burst(kind, 3, (5, 1, 4), slow_factor=2.5, freq=1.1,
                           deadline=30.0)
        b = t_events.burst(t_events.EventKind(kind.value), 3, (5, 1, 4),
                           slow_factor=2.5, freq=1.1, deadline=30.0)
        assert norm(a) == norm(b)
        assert (a.is_shrink, a.is_grow, a.describe()) == \
            (b.is_shrink, b.is_grow, b.describe())


LAYOUTS = [(2, 2, 1), (4, 2, 1), (2, 4, 2), (4, 4, 2), (3, 3, 1), (2, 8, 4)]
POLICIES = ("edit", "partial_rebuild", "full_rebuild")


def _random_trace(dp, pp, tp, seed, steps=4):
    rng = random.Random(seed)
    n = dp * pp * tp
    trace = []
    for _ in range(steps):
        k = rng.randint(1, max(1, n // 4))
        rem = tuple(sorted(rng.sample(range(n), k)))
        adds = tuple((f"dp_stage{(r // tp) % pp}_tp{r % tp}", r)
                     for r in rem[:rng.randint(0, len(rem))])
        trace.append((rem, adds, rng.choice(POLICIES)))
    return trace


@settings(max_examples=20, deadline=None)
@given(st.sampled_from(LAYOUTS), st.integers(0, 10**6))
def test_communicator_opstats_and_tables(layout, seed):
    dp, pp, tp = layout
    ga, gb = j_comm.build_hybrid_groups(dp, pp, tp), \
        t_comm.build_hybrid_groups(dp, pp, tp)
    assert ga == gb
    a, b = j_comm.DynamicCommunicator(ga), t_comm.DynamicCommunicator(gb)
    for rem, adds, policy in _random_trace(dp, pp, tp, seed):
        assert a.affected_groups(rem) == b.affected_groups(rem)
        da = j_cv.GroupDelta(remove=rem, add=adds)
        db = t_cv.GroupDelta(remove=rem, add=adds)
        assert norm(a.price(da, policy)) == norm(b.price(db, policy))
        assert norm(a.apply(da, policy)) == norm(b.apply(db, policy))
        assert a.groups == b.groups
        assert a.links == b.links
        assert a.all_ranks() == b.all_ranks()


# --------------------------------------------------------------------------
# ClusterView, planners, engine
# --------------------------------------------------------------------------
def _random_view_arrays(rng, dp, pp):
    alive = rng.random((dp, pp)) > 0.3
    alive[0] = True                      # every stage keeps a survivor
    freq = np.round(1.0 + 0.2 * rng.random((dp, pp)), 3)
    slow = np.where(rng.random((dp, pp)) > 0.7,
                    np.round(1.0 + 2.0 * rng.random((dp, pp)), 2), 1.0)
    return alive, freq, slow


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 6), st.integers(1, 5), st.integers(0, 10**6))
def test_clusterview_reductions(dp, pp, seed):
    rng = np.random.default_rng(seed)
    alive, freq, slow = _random_view_arrays(rng, dp, pp)
    la = [(p, p) for p in range(pp)]
    dom_a = j_cv.FailureDomainMap(dp * pp, 1 + seed % 3)
    dom_b = t_cv.FailureDomainMap(dp * pp, 1 + seed % 3)
    va = j_cv.ClusterView(dp, pp, 16, 2, 32, la, alive=alive.copy(),
                          freq=freq.copy(), slow=slow.copy(), domains=dom_a)
    vb = t_cv.ClusterView(dp, pp, 16, 2, 32, la, alive=alive.copy(),
                          freq=freq.copy(), slow=slow.copy(), domains=dom_b)

    def image(v):
        return norm((v.stage_width(), v.replica_width(), v.stage_slow(),
                     v.stage_freq(), v.alive_count(), v.dead_ranks(),
                     v.rank_dp, v.rank_stage, v.rank_domain, v.describe(),
                     v.rank_of(np.arange(dp), 0)))

    assert image(va) == image(vb)
    assert norm(dom_a.sample(2, seed)) == norm(dom_b.sample(2, seed))
    assert norm(dom_a.ranks_of([0, 1])) == norm(dom_b.ranks_of([0, 1]))
    r = random.Random(seed)
    for kind in ("fail_slow", "dvfs_set", "scale_out", "fail_stop",
                 "preempt_notice"):
        ranks = tuple(sorted(r.sample(range(dp * pp), min(2, dp * pp))))
        ea, eb = event_pair(kind, 1, ranks, slow_factor=1.7, freq=1.05)
        assert norm(va.apply_elastic(ea)) == norm(vb.apply_elastic(eb))
        assert image(va) == image(vb)
    assert image(va.copy()) == image(vb.copy())


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 64), st.integers(1, 8), st.integers(1, 9))
def test_plan_dataflow(per_micro, num_micro, dp):
    dp = min(dp, per_micro)
    gb = per_micro * num_micro
    assert norm(j_pl.plan_dataflow(gb, num_micro, dp)) == \
        norm(t_pl.plan_dataflow(gb, num_micro, dp))


CONFIGS = {
    "tiny-dense": (j_tiny("dense", num_layers=8), t_tiny("dense", num_layers=8)),
    "tiny-ssm": (j_tiny("ssm", num_layers=6), t_tiny("ssm", num_layers=6)),
    "codeqwen1.5-7b": (j_codeqwen.config(), t_codeqwen.config()),
    "mamba2-2.7b": (j_mamba2.config(), t_mamba2.config()),
}
HW = {"default": ({}, {}),
      "h100-figures": ({"peak_flops": 989e12, "hbm_bw": 3.35e12,
                        "hbm_bytes": 80e9},) * 2}


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_segment_costs_and_mini_step(name, hw):
    ca, cb = CONFIGS[name]
    assert dataclasses.asdict(ca) == dataclasses.asdict(cb)
    ha, hb = j_cost.HardwareSpec(**HW[hw][0]), t_cost.HardwareSpec(**HW[hw][1])
    assert dataclasses.asdict(ha) == dataclasses.asdict(hb)
    sa = j_cost.SegmentCosts.build(ca, 128, ha)
    sb = t_cost.SegmentCosts.build(cb, 128, hb)
    for f in ("fwd_flops", "param_bytes", "opt_bytes"):
        assert norm(getattr(sa, f)) == norm(getattr(sb, f))
    L = ca.num_layers
    rng = np.random.default_rng(L)
    for _ in range(12):
        a = int(rng.integers(0, L))
        b = int(rng.integers(a, L))
        mbs, infl, dp = (int(x) for x in rng.integers(1, 5, size=3))
        freq = float(rng.choice([1.0, 1.1, 1.178]))
        assert sa.seg_fwd_flops(a, b, mbs) == sb.seg_fwd_flops(a, b, mbs)
        assert sa.seg_mem(a, b, mbs, infl, dp) == sb.seg_mem(a, b, mbs, infl,
                                                             dp)
        assert j_cost.mini_step_time(sa, a, b, mbs, freq, neighbor_ranks=dp) \
            == t_cost.mini_step_time(sb, a, b, mbs, freq, neighbor_ranks=dp)


@settings(max_examples=30, deadline=None)
@given(st.integers(2, 9), st.integers(1, 4), st.integers(0, 10**6))
def test_minimax_and_brute_force_partition(L, P, seed):
    P = min(P, L)
    rng = np.random.default_rng(seed)
    cost = rng.random(L) + 0.1
    speed = rng.random(P) + 0.5
    memv = rng.random(L)
    caps = [float(c) for c in 0.5 + rng.random(P) * L / P]

    def t(p, a, b):
        return float(cost[a:b + 1].sum() / speed[p])

    def mem(p, a, b):
        return float(memv[a:b + 1].sum())

    for fn in ("minimax_layer_partition", "brute_force_partition"):
        assert norm(getattr(j_pl, fn)(L, P, t, mem, caps)) == \
            norm(getattr(t_pl, fn)(L, P, t, mem, caps))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(0.1, 5.0), min_size=1, max_size=6),
       st.floats(1.0, 1.5), st.floats(0.0, 0.1))
def test_plan_dvfs(times, f_max, eps):
    from repro.core.planners.dvfs import plan_dvfs_stages as ja
    from repro_torch.core.planners.dvfs import plan_dvfs_stages as tb
    assert norm(ja(times, f_max)) == norm(tb(times, f_max))
    target = min(times)
    for tt in times:
        obs = (lambda f, tt=tt: tt / f)
        assert norm(j_pl.plan_dvfs(obs, 1.0, f_max, target, eps, 0.01)) == \
            norm(t_pl.plan_dvfs(obs, 1.0, f_max, target, eps, 0.01))
        feas = (lambda f, tt=tt: tt / f <= target * 1.05)
        if feas(f_max):
            assert j_pl.bisect_min_feasible(1.0, f_max, feas, 1e-3) == \
                t_pl.bisect_min_feasible(1.0, f_max, feas, 1e-3)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 12), st.integers(1, 4), st.integers(0, 10**6))
def test_plan_rng_reshard(L, P, seed):
    rng = np.random.default_rng(seed)
    old_ls = np.sort(rng.integers(0, P, size=L))
    new_ls = np.sort(rng.integers(0, P, size=L))
    old_sr = {s: int(r) for s, r in enumerate(rng.integers(0, 4, size=8))}
    new_sr = {s: int(r) for s, r in enumerate(rng.integers(0, 4, size=8))}
    assert norm(j_pl.plan_rng_reshard(old_ls, new_ls, old_sr, new_sr)) == \
        norm(t_pl.plan_rng_reshard(old_ls, new_ls, old_sr, new_sr))
    oa = np.array(list(old_sr.values()))
    na = np.array(list(new_sr.values()))
    assert norm(j_pl.plan_rng_reshard(list(old_ls), list(new_ls), oa, na)) \
        == norm(t_pl.plan_rng_reshard(list(old_ls), list(new_ls), oa, na))


def _plan_image(plan):
    return norm(dataclasses.replace(plan, plan_seconds=0.0,
                                    event=plan.event.describe()))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", range(4))
def test_schedule_engine_plan_view(name, seed):
    ca, cb = CONFIGS[name]
    rng = np.random.default_rng(seed)
    dp, pp = 2 + seed % 3, 2 + seed % 2
    L = ca.num_layers
    cuts = np.sort(rng.choice(np.arange(1, L), size=pp - 1, replace=False))
    bounds = [0, *cuts.tolist(), L]
    la = [(bounds[p], bounds[p + 1] - 1) for p in range(pp)]
    alive, freq, slow = _random_view_arrays(rng, dp, pp)
    mem_cap = [None, 80e9, 2e9][seed % 3]
    ea = j_engine.ScheduleEngine(ca, 256, j_cost.HardwareSpec(), mem_cap)
    eb = t_engine.ScheduleEngine(cb, 256, t_cost.HardwareSpec(), mem_cap)
    gb = 4 * dp * 2
    d = int(rng.integers(1, dp))
    p = int(rng.integers(0, pp))
    old_sr = {s: s % dp for s in range(gb // 2)}
    for kind in ("fail_stop", "preempt_notice", "scale_out"):
        va = j_cv.ClusterView(dp, pp, gb, 2, 256, la, alive=alive.copy(),
                              freq=freq, slow=slow, mem_cap=ea.mem_cap)
        vb = t_cv.ClusterView(dp, pp, gb, 2, 256, la, alive=alive.copy(),
                              freq=freq, slow=slow, mem_cap=eb.mem_cap)
        eva, evb = event_pair(kind, 5, (d * pp + p,))
        for use_slow in (False, True):
            pa = ea.plan_view(eva, va, failed_dp_ranks=[d],
                              old_sample_rank=old_sr, use_slow=use_slow)
            pb = eb.plan_view(evb, vb, failed_dp_ranks=[d],
                              old_sample_rank=old_sr, use_slow=use_slow)
            assert pb.plan_seconds >= 0.0
            assert _plan_image(pa) == _plan_image(pb)


# --------------------------------------------------------------------------
# migration, zero layouts, 1F1B simulator
# --------------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(st.integers(1, 10**9), st.integers(1, 10**10), st.integers(1, 8),
       st.sampled_from(["interleaved", "contiguous"]), st.booleans(),
       st.floats(0.0, 10.0), st.integers(1, 3))
def test_migration_timing(pbytes, obytes, dp, layout, blocking, window, n):
    kw = dict(layer_ids=tuple(range(n)), src_stage=1, dst_stage=0,
              param_bytes=pbytes, opt_bytes=obytes, dp=dp, zero_layout=layout,
              blocking=blocking)
    assert norm(j_migr.migration_timing(j_migr.MigrationSpec(**kw), 50e9,
                                        window)) == \
        norm(t_migr.migration_timing(t_migr.MigrationSpec(**kw), 50e9,
                                     window))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(1, 500), min_size=1, max_size=5),
       st.integers(1, 4), st.sampled_from(["interleaved", "contiguous"]))
def test_zero_migration_plan(sizes, dp, layout):
    for pos in range(len(sizes)):
        a = j_zero.migration_plan(layout, sizes, pos, dp, 1, 0, [7, 9])
        b = t_zero.migration_plan(layout, sizes, pos, dp, 1, 0, [7, 9])
        assert norm(a) == norm(b)
        assert j_zero.plan_bytes(a) == t_zero.plan_bytes(b)
    for j in range(dp):
        assert j_zero.Layout(layout, tuple(sizes), dp).owner_intervals(j) == \
            t_zero.Layout(layout, tuple(sizes), dp).owner_intervals(j)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 6), st.integers(1, 8), st.integers(0, 10**6))
def test_simulate_1f1b(P, M, seed):
    rng = np.random.default_rng(seed)
    fwd, bwd = rng.random(P) + 0.1, rng.random(P) * 2 + 0.1
    sa = [j_pipe.StageTiming(float(f), float(b), M) for f, b in zip(fwd, bwd)]
    sb = [t_pipe.StageTiming(float(f), float(b), M) for f, b in zip(fwd, bwd)]
    p2p = float(rng.random() * 0.1)
    assert norm(j_pipe.simulate_1f1b(sa, p2p)) == \
        norm(t_pipe.simulate_1f1b(sb, p2p))


# --------------------------------------------------------------------------
# Agent + ElasticController over probe traces
# --------------------------------------------------------------------------
def _probe_trace(seed, n, rounds):
    """Per round, one probe per rank (some duplicated or dropped): ranks
    that die, flap (miss then recover), run slow, or fill their memory."""
    rng = random.Random(seed)
    dead_at = {r: rng.randint(2, rounds) for r in rng.sample(range(n), 2)}
    flappy = set(rng.sample(range(n), 2))
    slow = {r: rng.choice([1.5, 2.0, 3.0]) for r in rng.sample(range(n), 1)}
    oom = set(rng.sample(range(n), 1))
    trace = []
    for t in range(rounds):
        probes = []
        for r in range(n):
            alive = t < dead_at.get(r, rounds + 1)
            if r in flappy and rng.random() < 0.4:
                alive = False
            if rng.random() < 0.05:
                continue                           # probe lost
            secs = 1.0 * slow.get(r, 1.0) * (1.0 + 0.01 * rng.random())
            mem = min(1.0, 0.5 + 0.08 * t) if r in oom else 0.3
            probes.append((t, r, alive, secs, mem))
            if rng.random() < 0.1:
                probes.append((t, r, alive, secs, mem))   # duplicate
        rng.shuffle(probes)
        trace.append(probes)
    return trace


def _ev_image(events):
    return [norm(e) for e in events]


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10**6), st.sampled_from([(2, 2), (4, 2), (3, 4)]))
def test_agent_and_controller_event_streams(seed, shape):
    dp, pp = shape
    n = dp * pp
    stage_of = {r: r % pp for r in range(n)}
    aa = j_agent.Agent(n, stage_of=stage_of)
    ab = t_agent.Agent(n, stage_of=stage_of)
    ca = j_ctl.ElasticController(j_agent.Agent(n, stage_of=stage_of),
                                 grant_timeout=3)
    cb = t_ctl.ElasticController(t_agent.Agent(n, stage_of=stage_of),
                                 grant_timeout=3)
    ca.grant(n - 1, "spare")
    cb.grant(n - 1, "spare")
    rng = random.Random(seed)
    for t, round_ in enumerate(_probe_trace(seed, n, 14)):
        pa = [j_agent.Probe(*x) for x in round_]
        pb = [t_agent.Probe(*x) for x in round_]
        assert _ev_image(aa.observe(pa)) == _ev_image(ab.observe(pb))
        eva, evb = ca.observe(pa), cb.observe(pb)
        assert _ev_image(eva) == _ev_image(evb)
        for ev in eva:                  # the executor's membership updates
            for r in ev.ranks:
                if ev.kind == j_events.EventKind.FAIL_STOP:
                    ca.agent.remove_rank(r)
                    cb.agent.remove_rank(r)
                elif ev.kind == j_events.EventKind.SCALE_OUT:
                    ca.agent.add_rank(r, stage=r % pp)
                    cb.agent.add_rank(r, stage=r % pp)
                    ca.note_join(r)
                    cb.note_join(r)
        if t == 6 and rng.random() < 0.5:
            ca.grant(0)
            cb.grant(0)
        assert aa.ranks == ab.ranks and ca.agent.ranks == cb.agent.ranks
        assert [norm(aa.state_of(r)) for r in range(n)] == \
            [norm(ab.state_of(r)) for r in range(n)]
        assert aa.max_confirm_misses() == ab.max_confirm_misses()
        assert ca.max_confirm_misses() == cb.max_confirm_misses()
        assert norm(ca.pending_grants()) == norm(cb.pending_grants())
        assert norm(ca.stuck_grants()) == norm(cb.stuck_grants())


# --------------------------------------------------------------------------
# LiveRemap: plans on interval tables, execution on tensors
# --------------------------------------------------------------------------
def _remap_case(seed):
    rng = np.random.default_rng(seed)
    kind = ["interleaved", "contiguous"][seed % 2]
    sizes = [int(s) for s in rng.integers(1, 40, size=int(rng.integers(1, 5)))]
    dp = int(rng.integers(2, 5))
    n_fail = int(rng.integers(1, dp))
    failed = sorted(int(f) for f in rng.choice(dp, size=n_fail, replace=False))
    return kind, sizes, dp, failed


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10**6))
def test_live_remap_plan_and_execute(seed):
    kind, sizes, dp, failed = _remap_case(seed)
    ja, tb = j_ss.get_table(kind, sizes, dp), t_ss.get_table(kind, sizes, dp)
    assert [ja.owner_intervals(j) for j in range(dp)] == \
        [tb.owner_intervals(j) for j in range(dp)]
    np.testing.assert_array_equal(ja.shard_index, tb.shard_index)
    total = ja.total
    rng = np.random.default_rng(seed + 1)
    flat = rng.standard_normal(total).astype(np.float32)
    surviving = [r for r in range(dp) if r not in failed]
    device_parts = {r: ja.owner_intervals(r) for r in surviving}
    # a failed rank's ring holder is its left neighbour
    host_parts = {f: ja.owner_intervals(f) for f in failed
                  if (f - 1) % dp in surviving}
    new = j_ss.get_table(kind, sizes, len(surviving))
    target = {r: new.owner_intervals(j) for j, r in enumerate(surviving)}
    rj, rt = j_remap.LiveRemap(), t_remap.LiveRemap()
    try:
        pa = rj.compute_plan(total, device_parts, host_parts, target)
    except j_remap.IntegrityError:
        with pytest.raises(t_remap.IntegrityError):
            rt.compute_plan(total, device_parts, host_parts, target)
        return
    pb = rt.compute_plan(total, device_parts, host_parts, target)
    assert norm(pa) == norm(pb)
    assert pa.overlap_matrix(dp).tolist() == pb.overlap_matrix(dp).tolist()
    shards = ja.split(flat)
    tflat = torch.from_numpy(flat.copy())
    dev_np = {r: ja.segments(r, shards[r]) for r in surviving}
    dev_t = {r: tb.segments(r, tb.shard_view(tflat, r)) for r in surviving}
    # host copies stay numpy on the port's side too (the ring is host numpy)
    host_np = {f: ja.segments(f, shards[f].copy()) for f in host_parts}
    out_a = rj.execute(pa, total, dev_np, host_np)
    out_b = rt.execute(pb, total, dev_t, host_np, device="cpu")
    assert sorted(out_a) == sorted(out_b)
    for r in out_a:
        assert isinstance(out_b[r], torch.Tensor)
        np.testing.assert_array_equal(out_b[r].numpy(), out_a[r])
    # the assembled shards are the survivors' new shards of the same vector
    want = new.split(new.gather(ja.scatter(flat)))
    for j, r in enumerate(surviving):
        np.testing.assert_array_equal(out_b[r].numpy(), want[j])


def test_live_remap_rejects_a_device_segment_off_the_target_device():
    tbl = t_ss.get_table("interleaved", [8, 8], 2)
    rt = t_remap.LiveRemap()
    plan = rt.compute_plan(16, {0: tbl.owner_intervals(0),
                                1: tbl.owner_intervals(1)}, {},
                           {0: [(0, 8)], 1: [(8, 16)]})
    flat = torch.arange(16, dtype=torch.float32)
    dev = {r: tbl.segments(r, tbl.shard_view(flat, r)) for r in (0, 1)}
    with pytest.raises(t_remap.IntegrityError, match="meta"):
        rt.execute(plan, 16, dev, {}, device="meta")


# --------------------------------------------------------------------------
# the statespace recovery half on tensors
# --------------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10**6))
def test_statespace_recovery_half(seed):
    kind, sizes, dp, _ = _remap_case(seed)
    rng = np.random.default_rng(seed)
    full = {c: rng.standard_normal(sum(sizes)).astype(np.float32)
            for c in t_ss.COMPONENTS}
    ranks = list(range(dp))
    entries = list(range(len(sizes)))
    sa = j_ss.StageState.from_full(entries, sizes, kind, ranks, full)
    sb = t_ss.StageState.from_full(entries, sizes, kind, ranks,
                                   {c: torch.from_numpy(v.copy())
                                    for c, v in full.items()})
    ta, tb = sa.table, sb.table
    for j in range(dp):
        out_a = ta.scatter_shard(j, ta.shard_view(sa.flat["mu"], j),
                                 np.zeros(ta.total, np.float32))
        out_b = tb.scatter_shard(j, tb.shard_view(sb.flat["mu"], j),
                                 torch.zeros(tb.total))
        np.testing.assert_array_equal(out_b.numpy(), out_a)
        seg_a = ta.segments(j, sa.shard(j)["nu"])
        seg_b = tb.segments(j, sb.shard(j)["nu"])
        assert list(seg_a) == list(seg_b)
        for iv in seg_a:
            np.testing.assert_array_equal(seg_b[iv].numpy(), seg_a[iv])
    new_state = {c: rng.standard_normal(int(ta.shard_sizes[0])).astype(
        np.float32) for c in t_ss.COMPONENTS}
    sa.write_shard(0, new_state)
    sb.write_shard(0, new_state)
    for c in t_ss.COMPONENTS:
        np.testing.assert_array_equal(sb.flat[c].numpy(), sa.flat[c])
    keep = ranks[1:] or ranks
    shards_a = {r: {c: v.copy() for c, v in sa.shard(r).items()}
                for r in keep}
    shards_b = {r: {c: v.clone() for c, v in sb.shard(r).items()}
                for r in keep}
    sa.replace_shards(keep, shards_a)
    sb.replace_shards(keep, shards_b)
    assert sa.dp_ranks == sb.dp_ranks
    for c in t_ss.COMPONENTS:
        np.testing.assert_array_equal(sb.flat[c].numpy(), sa.flat[c])
