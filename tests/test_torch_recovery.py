"""The port's recovery half against the JAX package's fast path, on the CPU.

Twin clusters start from the reference's exact initial weights and run the
same elastic sequence: train -> fail-stop (probes -> controller -> engine ->
executor, with a corrupted ring snapshot: the ``rebuilt`` tier) -> train ->
scale-out -> train -> fail-slow with a layer migration -> train -> drain of
the slow rank (with a corrupted snapshot: the ``rederived`` tier) -> train ->
a two-rank fail-stop burst -> train -> DVFS and OOM-risk events.

Held exactly: recovery records, the live-remap plans (moves, bytes,
modeled seconds), snapshot integrity tiers, ``layer_assignment``,
``dp_ranks``, ``per_rank_mbs`` and ``grad_weights``.  The planner's
measured wall clock (``RecoveryPlan.plan_seconds``) is pinned to 0 on both
sides so that the records' ``total`` can be held exactly too.  Held within
the bounds of the reference's ``core.invariants.KernelConsistencyChecker``:
losses, and master/mu/nu after every step.
"""
import dataclasses
import enum

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import cluster as j_cluster  # noqa: E402
from repro.core.events import ElasticEvent as JEvent, EventKind as JKind  # noqa: E402
from repro.core.fabric.snapshot import SnapshotPool as JPool  # noqa: E402
from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro.models.registry import tiny_config as j_tiny  # noqa: E402
from repro_torch.core import cluster as t_cluster  # noqa: E402
from repro_torch.core.events import (ElasticEvent as TEvent,  # noqa: E402
                                     EventKind as TKind)
from repro_torch.core.fabric.snapshot import SnapshotPool as TPool  # noqa: E402
from repro_torch.models.registry import tiny_config as t_tiny  # noqa: E402

COMPONENTS = ("master", "mu", "nu")

# the reference's elastic test config (tests/test_fast_path_numerics.py), at
# dropout 0, and the tiny ssm config at the same grid
TWINS = {
    "dense": dict(cfg=dict(num_layers=8), dp=4, pp=2,
                  kw=dict(global_batch=16, num_micro=2, seq_len=16)),
    "ssm": dict(cfg=dict(num_layers=4), dp=4, pp=2,
                kw=dict(global_batch=16, num_micro=2, seq_len=16)),
}

# (op, args); ranks are (d, p) cells, burst ranks are global d * pp + p
SEQUENCE = [
    ("train",), ("corrupt", 1, 1), ("detect_fail_stop", 1, 1), ("train",),
    ("scale_out", 1, 1), ("train",),
    ("fail_slow", 0, 0, 2.0), ("train",),
    ("corrupt", 0, 0), ("drain", 0, 0), ("train",),
    ("burst_fail_stop", (5, 6)), ("train",),
    ("event", "dvfs_set", (2,)), ("event", "oom_risk", (3,)),
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _norm(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple((f.name, _norm(getattr(x, f.name)))
                     for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


def _instrument(cl, log):
    """Log every live-remap plan and snapshot-integrity tier, and pin the
    planner's wall clock to 0."""
    plan, compute = cl.engine.plan, cl.remapper.compute_plan

    def pinned_plan(*a, **k):
        return dataclasses.replace(plan(*a, **k), plan_seconds=0.0)

    def logged_compute(*a, **k):
        out = compute(*a, **k)
        log.append(("remap", _norm(out)))
        return out

    cl.engine.plan = pinned_plan
    cl.remapper.compute_plan = logged_compute


@pytest.fixture
def tiers(monkeypatch):
    """Snapshot integrity tiers of both packages, in call order."""
    log = {"ref": [], "port": []}
    for name, cls in (("ref", JPool), ("port", TPool)):
        orig = cls.verify_and_repair

        def wrapped(self, j, *a, _orig=orig, _log=log[name], **k):
            tier, st = _orig(self, j, *a, **k)
            _log.append(tier)
            return tier, st
        monkeypatch.setattr(cls, "verify_and_repair", wrapped)
    return log


def make_twins(family, layout, dp=None, pp=None, **over):
    spec = TWINS[family]
    dp, pp = dp or spec["dp"], pp or spec["pp"]
    kw = {**spec["kw"], **over}
    ref = j_cluster.VirtualCluster(j_tiny(family, **spec["cfg"]), dp, pp,
                                   zero_layout=layout, use_pallas=False, **kw)
    cl = t_cluster.VirtualCluster(
        t_tiny(family, **spec["cfg"]), dp, pp, zero_layout=layout,
        device="cpu", init_params=(_np(ref.stem), _np(ref.layer_params),
                                   _np(ref.head)), **kw)
    return ref, cl


def assert_structure(ref, cl):
    assert cl.layer_assignment == ref.layer_assignment
    assert cl.per_rank_mbs == ref.per_rank_mbs
    assert cl.grad_weights == ref.grad_weights
    assert len(cl.stages) == len(ref.stages)
    for st, js in zip(cl.stages, ref.stages):
        assert st.entries == js.entries and st.sizes == js.sizes
        assert st.dp_ranks == js.dp_ranks
        np.testing.assert_array_equal(st.table.shard_sizes,
                                      js.table.shard_sizes)
    np.testing.assert_array_equal(cl.alive, ref.alive)
    np.testing.assert_array_equal(cl.freq, ref.freq)
    np.testing.assert_array_equal(cl.slow, ref.slow)


def assert_state_close(ref, cl, where):
    atol = KCC.PARAM_ATOL0 + 2.0 * ref.adam.lr * ref.opt_step
    for p, (st, js) in enumerate(zip(cl.stages, ref.stages)):
        for c in COMPONENTS:
            np.testing.assert_allclose(st.full(c).numpy(), js.full(c),
                                       rtol=KCC.PARAM_RTOL, atol=atol,
                                       err_msg=f"{where}: stage {p} {c}")


def assert_ring_matches_device(cl):
    for st, pool in zip(cl.stages, cl.snapshots):
        for c in COMPONENTS:
            shards = st.table.split(st.flat[c].numpy())
            for i in range(pool.n):
                np.testing.assert_array_equal(pool.host[i][c],
                                              shards[pool.backup_rank(i)])


def apply_op(c, op, pkg):
    """Apply one op of SEQUENCE to cluster ``c`` of package ``pkg``."""
    name, *args = op
    if name == "train":
        return c.train_step()
    if name == "corrupt":
        d, p = args
        c.snapshots[p].corrupt_shard(c.stages[p].dp_ranks.index(d))
        return None
    if name == "detect_fail_stop":
        c.inject_fail_stop(*args)
        return c.detect_and_recover()
    if name == "scale_out":
        return c.recover_scale_out(*args)
    if name == "fail_slow":
        return c.recover_fail_slow(*args)
    if name == "drain":
        return c.drain_rank(*args)
    Event, Kind = (JEvent, JKind) if pkg == "ref" else (TEvent, TKind)
    if name == "burst_fail_stop":
        return c.apply_event(Event(Kind.FAIL_STOP, c.step_count, args[0]))
    kind, ranks = args
    return c.apply_event(Event(Kind(kind), c.step_count, ranks, freq=1.1))


def run_twin(ref, cl, sequence):
    logs = {"ref": [], "port": []}
    _instrument(ref, logs["ref"])
    _instrument(cl, logs["port"])
    for k, op in enumerate(sequence):
        before = list(cl.layer_assignment)
        b = apply_op(ref, op, "ref")
        a = apply_op(cl, op, "port")
        where = f"op {k} {op}"
        if op[0] == "train":
            assert abs(a - b) <= KCC.LOSS_ATOL + KCC.LOSS_RTOL * abs(b), \
                (where, a, b)
            assert_state_close(ref, cl, where)
        elif a is not None or b is not None:
            assert set(a) == set(b) == set(j_cluster._recovery_record())
            assert a == b, (where, a, b)
        if op[0] == "fail_slow":
            assert cl.layer_assignment != before, "fail-slow moved no layer"
        assert_structure(ref, cl)
        if op[0] != "corrupt":          # bit rot is meant to stay until read
            assert_ring_matches_device(cl)
        assert logs["port"] == logs["ref"], where
    assert cl.recoveries == ref.recoveries
    assert cl.warnings[0].describe() == ref.warnings[0].describe()
    return logs


@pytest.mark.slow
@pytest.mark.parametrize("layout", ["interleaved", "contiguous"])
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_recovery_sequence_twin_vs_reference(family, layout, tiers):
    ref, cl = make_twins(family, layout)
    logs = run_twin(ref, cl, SEQUENCE)
    assert tiers["port"] == tiers["ref"]
    assert "rebuilt" in tiers["port"] and "rederived" in tiers["port"]
    # fail-stop (with migration), scale-out, fail-slow, drain, 2-rank burst
    assert len(cl.recoveries) == 6
    assert sum(r["degraded"] for r in cl.recoveries) == 1
    assert any(r["migration"] > 0 for r in cl.recoveries)
    assert len([e for e in logs["port"] if e[0] == "remap"]) == 5


@pytest.mark.slow
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_ring_of_one_twin_vs_reference(family, tiers):
    """dp=2: a fail-stop leaves a stage one rank wide, whose ring snapshot
    is held by the rank itself; the survivor then takes both samples of
    each micro-batch (the card's full-width recovery phase, tiny)."""
    ref, cl = make_twins(family, "interleaved", dp=2, pp=2, global_batch=4)
    run_twin(ref, cl, [
        ("train",), ("detect_fail_stop", 1, 1), ("train",),
        ("scale_out", 1, 1), ("train",), ("fail_slow", 0, 0, 2.0),
        ("train",), ("drain", 0, 0), ("train",),
        ("event", "oom_risk", (1,))])
    assert cl.per_rank_mbs == [2]
    assert [len(s.dp_ranks) for s in cl.stages] == [1, 2]
    assert cl.snapshots[0].n == 1
    assert cl.snapshots[0].holder_of(0) == cl.snapshots[0].backup_rank(0) == 0
    assert tiers["port"] == tiers["ref"] == ["verified", "verified"]


def test_snapshot_integrity_tiers_match_reference():
    """verify_and_repair on the same shards: every tier, and the repaired
    holder slot, equal to the reference's (device state as tensors)."""
    rng = np.random.default_rng(0)
    shards = [{c: rng.standard_normal(5 + j).astype(np.float32)
               for c in COMPONENTS} for j in range(3)]
    for case in ("verified", "rederived", "rebuilt", "lost"):
        a, b = JPool(3), TPool(3)
        a.bootstrap(0, shards)
        b.bootstrap(0, [{c: torch.from_numpy(v.copy()) for c, v in s.items()}
                        for s in shards])
        if case != "verified":
            a.corrupt_shard(1, "mu", 2)
            b.corrupt_shard(1, "mu", 2)
        assert a.verify_shard(1) == b.verify_shard(1)
        assert a.verify_cost_seconds(1) == b.verify_cost_seconds(1)
        dev = {c: v + 1 for c, v in shards[1].items()}
        master = shards[1]["master"] * 2
        kw_a = {"rederived": dict(device_state=dev),
                "rebuilt": dict(master_fallback=lambda: master)}.get(case, {})
        kw_b = {"rederived": dict(device_state={
                    c: torch.from_numpy(v) for c, v in dev.items()}),
                "rebuilt": dict(master_fallback=lambda: torch.from_numpy(
                    master))}.get(case, {})
        ta, sa = a.verify_and_repair(1, **kw_a)
        tb, sb = b.verify_and_repair(1, **kw_b)
        assert ta == tb == case
        if sa is not None:
            for c in COMPONENTS:
                np.testing.assert_array_equal(sb[c], sa[c])
            assert b.crc == a.crc
        assert b.verify_shard(1) == a.verify_shard(1)
    a, b = JPool(2), TPool(2)
    a.bootstrap(0, shards[:2])
    b.bootstrap(0, shards[:2])
    a.lose_rank(0)
    b.lose_rank(0)
    assert a.recover_shard(1) is b.recover_shard(1) is None
    assert a.verify_and_repair(1)[0] == b.verify_and_repair(1)[0] == "lost"
    assert a.verify_cost_seconds(1) == b.verify_cost_seconds(1) == 0.0


def test_master_shard_from_params_equals_the_masters():
    """The ``rebuilt`` tier's source: on fp32 leaves the parameters equal
    the masters bit for bit, shard by shard."""
    cl = t_cluster.VirtualCluster(t_tiny("dense", num_layers=2), 2, 2,
                                  device="cpu", global_batch=8, num_micro=2,
                                  seq_len=16)
    cl.run(1)
    for p, st in enumerate(cl.stages):
        for j, r in enumerate(st.dp_ranks):
            assert torch.equal(cl._master_shard_from_params(p, j),
                               st.shard(r)["master"])


def test_recovery_keeps_leaves_and_write_back_after_migration():
    """A migration rebuilds stage buffers; the parameter leaves (and their
    ``requires_grad``) stay the same objects and still receive the
    masters' write-back."""
    cl = t_cluster.VirtualCluster(t_tiny("dense", num_layers=4), 2, 2,
                                  device="cpu", global_batch=8, num_micro=2,
                                  seq_len=16)
    leaves = [id(x) for x in cl._leaves]
    cl.run(1)
    before = list(cl.layer_assignment)
    cl.recover_fail_slow(0, 0, 3.0)
    assert cl.layer_assignment != before
    cl.run(1)
    assert [id(x) for x in cl._leaves] == leaves
    assert all(x.requires_grad for x in cl._leaves)
    for st in cl.stages:
        full = st.full("master")
        for pos, e in enumerate(st.entries):
            s_, e_ = st.table.layer_interval(pos)
            with torch.no_grad():
                vec = cl.flattener.flatten_entry(e, cl._entry_tree(e))
            assert torch.equal(vec, full[s_:e_])
    assert_ring_matches_device(cl)


def test_remap_check_catches_corruption(monkeypatch):
    """The exact before/after check of a live remap raises on one flipped
    element (a broken remap must never resume training)."""
    cl = t_cluster.VirtualCluster(t_tiny("dense", num_layers=2), 2, 2,
                                  device="cpu", global_batch=8, num_micro=2,
                                  seq_len=16)
    cl.run(1)
    execute = cl.remapper.execute

    def corrupting(*a, **k):
        out = execute(*a, **k)
        out[min(out)][0] += 1.0
        return out
    monkeypatch.setattr(cl.remapper, "execute", corrupting)
    with pytest.raises(AssertionError, match="remap corrupted master"):
        cl.recover_fail_stop(1, 0)
