"""The port's seed path (``core/legacy.py``) against the JAX package's, on the
CPU.

Both packages' seed paths (``fast_path=False``) start from the reference's
exact initial weights and run the reference's elastic trajectory test
(``tests/test_fast_path_numerics.py::TestElasticTrajectoryBitIdentical``):
tiny dense, 8 layers, dropout 0.1, dp 4, pp 2, global batch 16 in 2
micro-batches, seq 16; 3 steps -> ``recover_fail_stop(1, 1)`` -> 3 steps
-> ``recover_scale_out(1, 1)`` -> 2 steps.

Held exactly: recovery records (the planner's measured wall clock pinned
to 0 on both sides), the live-remap plans, ``layer_assignment``,
``dp_ranks``, ``per_rank_mbs`` and ``grad_weights``, and the port's ring
against its device shards.  Held within the bounds of the reference's
``core.invariants.KernelConsistencyChecker`` (the ones
``tests/test_torch_recovery.py`` holds the port's fast path to): losses,
and master/mu/nu and the parameters after every step.

The per-rank ring loop, ``SnapshotPool(batched=False)``, against the
reference's: host state, CRCs and stats bitwise under both ``compress``
settings, and equal to the port's batched pool.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.core import cluster as j_cluster  # noqa: E402
from repro.core.fabric.snapshot import SnapshotPool as JPool  # noqa: E402
from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro.models.registry import tiny_config as j_tiny  # noqa: E402
from repro.optim.adam import AdamConfig as JAdam  # noqa: E402
from repro_torch.core import cluster as t_cluster  # noqa: E402
from repro_torch.core.fabric.snapshot import SnapshotPool as TPool  # noqa: E402
from repro_torch.core.statespace import flatten_leaves, tree_leaves  # noqa: E402
from repro_torch.models.registry import tiny_config as t_tiny  # noqa: E402
from repro_torch.optim.adam import AdamConfig as TAdam  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: E402,F401
from test_torch_recovery import (COMPONENTS, _instrument, _np,  # noqa: E402
                                 apply_op, assert_ring_matches_device,
                                 assert_structure)

CFG = dict(num_layers=8, dropout_rate=0.1)
KW = dict(global_batch=16, num_micro=2, seq_len=16)
SEQUENCE = [("train",)] * 3 + [("fail_stop", 1, 1)] + [("train",)] * 3 \
    + [("scale_out", 1, 1)] + [("train",)] * 2


def _op(c, op, pkg):
    if op[0] == "fail_stop":
        return c.recover_fail_stop(*op[1:])
    return apply_op(c, op, pkg)


def _state_misses(ref, cl, where) -> list:
    """master/mu/nu of every stage (through each seed path's gather loop)
    and the parameters, against the kernel-consistency bounds."""
    atol = KCC.PARAM_ATOL0 + 2.0 * ref.adam.lr * ref.opt_step
    misses = []
    for p, (st, js) in enumerate(zip(cl.stages, ref.stages)):
        for c in COMPONENTS:
            a = cl._stage_full_vec(st, c).numpy()
            b = ref._stage_full_vec(js, c)
            if not np.allclose(a, b, rtol=KCC.PARAM_RTOL, atol=atol):
                misses.append(f"{where}: stage {p} {c} "
                              f"{np.abs(a - b).max():.3e}")
    a = flatten_leaves(tree_leaves((cl.stem, cl.layer_params, cl.head)))
    b = np.asarray(ravel_pytree((ref.stem, ref.layer_params, ref.head))[0])
    if not np.allclose(a.detach().numpy(), b, rtol=KCC.PARAM_RTOL,
                       atol=atol):
        misses.append(f"{where}: parameters")
    return misses


@pytest.fixture(scope="module")
def trajectory():
    ref = j_cluster.VirtualCluster(j_tiny("dense", **CFG), 4, 2,
                                   fast_path=False, use_pallas=False, **KW)
    cl = t_cluster.VirtualCluster(
        t_tiny("dense", **CFG), 4, 2, fast_path=False, device="cpu",
        init_params=(_np(ref.stem), _np(ref.layer_params), _np(ref.head)),
        **KW)
    logs = {"ref": [], "port": []}
    _instrument(ref, logs["ref"])
    _instrument(cl, logs["port"])
    out = dict(ref=ref, cl=cl, logs=logs, losses=([], []), recs=([], []),
               misses=[], structure=[], ring=[])
    for k, op in enumerate(SEQUENCE):
        b = _op(ref, op, "ref")
        a = _op(cl, op, "port")
        where = f"op {k} {op}"
        if op[0] == "train":
            out["losses"][0].append(b)
            out["losses"][1].append(a)
        else:
            out["recs"][0].append(b)
            out["recs"][1].append(a)
        out["misses"] += _state_misses(ref, cl, where)
        try:
            assert_structure(ref, cl)
        except AssertionError as e:
            out["structure"].append(f"{where}: {e}")
        try:
            assert_ring_matches_device(cl)
        except AssertionError as e:
            out["ring"].append(f"{where}: {e}")
    return out


def test_both_clusters_ran_the_seed_path(trajectory):
    ref, cl = trajectory["ref"], trajectory["cl"]
    assert ref.fast_path is False and cl.fast_path is False
    assert all(not p.batched for p in ref.snapshots)
    assert all(not p.batched for p in cl.snapshots)
    assert len(cl.losses) == 8 and cl.step_count == ref.step_count == 8
    assert cl.stages[1].dp_ranks == ref.stages[1].dp_ranks == [0, 2, 3, 1]


def test_losses_within_bounds(trajectory):
    ref, port = trajectory["losses"]
    assert len(ref) == len(port) == 8
    for k, (a, b) in enumerate(zip(port, ref)):
        assert abs(a - b) <= KCC.LOSS_ATOL + KCC.LOSS_RTOL * abs(b), (k, a, b)


def test_state_and_params_within_bounds_after_every_op(trajectory):
    assert trajectory["misses"] == []


def test_records_and_remap_plans_exact(trajectory):
    ref, port = trajectory["recs"]
    assert len(ref) == len(port) == 2
    for a, b in zip(port, ref):
        assert set(a) == set(b) == set(j_cluster._recovery_record())
        assert a == b
    logs = trajectory["logs"]
    assert logs["port"] == logs["ref"] and len(logs["port"]) == 2


def test_structure_exact_after_every_op(trajectory):
    assert trajectory["structure"] == []


def test_ring_matches_device_after_every_op(trajectory):
    assert trajectory["ring"] == []


# ---------------------------------------------------------------------------
# the per-rank ring loop
# ---------------------------------------------------------------------------
SIZES = (7, 5, 6)


def _pools(compress):
    rng = np.random.default_rng(11)
    shards = [{c: rng.standard_normal(n).astype(np.float32)
               for c in COMPONENTS} for n in SIZES]
    for st in shards:
        st["nu"] = np.abs(st["nu"])         # a second moment
    jcfg, tcfg = JAdam(), TAdam()
    ref = JPool(len(SIZES), jcfg, compress=compress, batched=False)
    loop = TPool(len(SIZES), tcfg, compress=compress, batched=False)
    batched = TPool(len(SIZES), tcfg, compress=compress)
    for pool in (ref, loop, batched):
        pool.bootstrap(0, [{c: v.copy() for c, v in st.items()}
                           for st in shards])
    grads = [[rng.standard_normal(n).astype(np.float32) for n in SIZES]
             for _ in range(3)]
    return ref, loop, batched, grads


@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_snapshot_loop_bitwise_vs_reference(compress):
    ref, loop, batched, grads = _pools(compress)
    assert not loop.batched and batched.batched
    for step, g in enumerate(grads):
        sj = ref.snapshot_step(step, g, step + 1)
        st = loop.snapshot_step(step, g, step + 1)
        batched.snapshot_step(step, g, step + 1)
        assert (st.grad_bytes_sent, st.state_bytes_equiv) == \
            (sj.grad_bytes_sent, sj.state_bytes_equiv)
        assert st.host_update_seconds == sj.host_update_seconds
        assert st.d2d_seconds == sj.d2d_seconds
        for i in range(len(SIZES)):
            for c in COMPONENTS:
                np.testing.assert_array_equal(loop.host[i][c], ref.host[i][c])
                np.testing.assert_array_equal(batched.host[i][c],
                                              loop.host[i][c])
        assert loop.crc == ref.crc == batched.crc
        assert loop.snap_step == ref.snap_step == [step] * len(SIZES)
    loop.corrupt_shard(1)
    assert not loop.verify_shard(1) and loop.verify_shard(2)
    assert loop.critical_path_overhead() == ref.critical_path_overhead()


def test_seed_cluster_pools_are_per_rank_and_the_fast_path_s_batched():
    """Every ring pool of a seed cluster runs the per-rank loop, before and
    after a recovery; a fast cluster's pools stay batched after one."""
    cfg = t_tiny("dense", num_layers=2)
    kw = dict(global_batch=8, num_micro=2, seq_len=16, device="cpu")
    for fast in (False, True):
        cl = t_cluster.VirtualCluster(cfg, 2, 2, fast_path=fast, **kw)
        cl.run(1)
        cl.recover_fail_stop(0, 1)
        cl.recover_scale_out(0, 1)
        assert [p.batched for p in cl.snapshots] == [fast, fast]
        assert isinstance(cl._stage_full_vec(cl.stages[0]), torch.Tensor)
