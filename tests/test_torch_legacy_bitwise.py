"""The port's seed path equals its fast path bit for bit, on the CPU.

Two clusters of the port from the same seed, ``fast_path=False``
(``core/legacy.py``: per-item gradient calls with per-leaf accumulation,
per-shard AdamW, per-entry write-back, per-rank ring loop, segment-dict
remaps, every stage rebuilt on a migration) and ``fast_path=True``, run
one elastic sequence: 3 steps -> ``recover_fail_stop(1, 1)`` -> 3 steps ->
``recover_scale_out(1, 1)`` -> 2 steps -> ``recover_fail_slow(0, 0, 2.0)``
(a layer migration) -> 1 step -> ``drain_rank(0, 0)`` -> 1 step.

Held with ``==``, no tolerance, after every operation: losses; every
rank's master/mu/nu shard and each stage's full vectors (each path through
its own gather); the parameters; the ring's host copies and their CRCs;
recovery records (the planner's measured wall clock pinned to 0) and
live-remap plans; layouts.  Float32 configs, where both paths do the same
arithmetic element for element.  Cases: the reference's elastic test
config (dense, 8 layers, dropout 0.1, dp 4, pp 2) and it in
``rng_mode="naive"`` here; it under the contiguous layout, and the moe
(capacity factor 16) and ssm families, in
``test_torch_legacy_bitwise_families.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cluster import VirtualCluster
from repro_torch.models.registry import tiny_config
from _torch_threads import torch_one_thread  # noqa: F401

COMPONENTS = ("master", "mu", "nu")
SEQUENCE = [("train",)] * 3 + [("recover_fail_stop", 1, 1)] \
    + [("train",)] * 3 + [("recover_scale_out", 1, 1)] + [("train",)] * 2 \
    + [("recover_fail_slow", 0, 0, 2.0), ("train",),
       ("drain_rank", 0, 0), ("train",)]
DENSE = dict(family="dense", cfg=dict(num_layers=8, dropout_rate=0.1), dp=4,
             pp=2, kw=dict(global_batch=16, num_micro=2, seq_len=16))
CASES = {
    "dense": DENSE,
    "naive": {**DENSE, "kw": {**DENSE["kw"], "rng_mode": "naive"}},
}


def _pin(cl, log):
    """Pin the planner's wall clock to 0 and log every live-remap plan."""
    plan, compute = cl.engine.plan, cl.remapper.compute_plan

    def pinned(*a, **k):
        out = plan(*a, **k)
        out.plan_seconds = 0.0
        return out

    def logged(*a, **k):
        out = compute(*a, **k)
        log.append((out.moves, out.total_bytes, out.est_seconds))
        return out
    cl.engine.plan, cl.remapper.compute_plan = pinned, logged


def _first_difference(a: torch.Tensor, b: torch.Tensor) -> str:
    i = int(torch.nonzero(a != b)[0])
    return f"element {i}: {a[i].item()!r} vs {b[i].item()!r}"


def assert_bitwise(seed, fast, where):
    assert seed.layer_assignment == fast.layer_assignment, where
    assert seed.per_rank_mbs == fast.per_rank_mbs, where
    assert seed.grad_weights == fast.grad_weights, where
    for p, (ss, sf) in enumerate(zip(seed.stages, fast.stages)):
        assert (ss.entries, ss.sizes, ss.dp_ranks) == \
            (sf.entries, sf.sizes, sf.dp_ranks), where
        for c in COMPONENTS:
            a, b = seed._stage_full_vec(ss, c), fast._stage_full_vec(sf, c)
            assert torch.equal(a, b), \
                f"{where}: stage {p} {c} {_first_difference(a, b)}"
            for r in ss.dp_ranks:
                assert torch.equal(ss.shard(r)[c], sf.shard(r)[c]), \
                    f"{where}: stage {p} rank {r} {c}"
    for k, (a, b) in enumerate(zip(seed._leaves, fast._leaves)):
        assert torch.equal(a, b), f"{where}: parameter leaf {k}"
    for p, (ps, pf) in enumerate(zip(seed.snapshots, fast.snapshots)):
        assert not ps.batched and pf.batched
        assert ps.crc == pf.crc, f"{where}: ring CRCs of stage {p}"
        for i in range(ps.n):
            for c in COMPONENTS:
                np.testing.assert_array_equal(ps.host[i][c], pf.host[i][c],
                                              err_msg=where)


def run_case(case):
    made = {}
    for fast in (False, True):
        made[fast] = VirtualCluster(
            tiny_config(case["family"], **case["cfg"]), case["dp"],
            case["pp"], fast_path=fast, device="cpu", **case["kw"])
    seed, fast = made[False], made[True]
    logs = {False: [], True: []}
    for f, cl in made.items():
        _pin(cl, logs[f])
    assert_bitwise(seed, fast, "start")
    for k, (name, *args) in enumerate(SEQUENCE):
        where = f"op {k} {name}{tuple(args)}"
        before = list(fast.layer_assignment)
        if name == "train":
            a, b = seed.train_step(), fast.train_step()
        else:
            a, b = (getattr(cl, name)(*args) for cl in (seed, fast))
        assert a == b, (where, a, b)
        if name == "recover_fail_slow":
            assert fast.layer_assignment != before, "fail-slow moved no layer"
        assert logs[False] == logs[True], where
        assert_bitwise(seed, fast, where)
    assert seed.losses == fast.losses and len(seed.losses) == 10
    assert len(logs[True]) == 3     # fail-stop, scale-out and drain remaps


@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_path_equals_fast_path_bitwise(case):
    run_case(CASES[case])
