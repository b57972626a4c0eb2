"""The port's MoE layer (``repro_torch.models.moe``) and expert planner on
the CPU against the JAX package's.

Weights and inputs come from numpy with a seed and go into both packages.
The routing (top-k experts, ranks in each expert's queue, the kept set)
compares with ``==`` against the reference's own expressions; outputs and
aux loss within ``F32`` (rtol 1e-5, atol 1e-6: float32 products summed in
another order) or, in bf16, per row within ``BF16`` of the row's max
|output|: the bf16 tier's rtol (1e-2, ``flash_attention_bf16`` in
``kernels/ops.py``) for each of the expert MLP's three roundings, adding
as a random walk.  Gradients within ``GRAD`` (rtol 1e-4, atol 1e-6, the
float32 kernel tiers: the backward sums over more terms).  The planner's
outputs compare with ``==``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.planners import expert as JE  # noqa: E402
from repro.models import moe as JX  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.core.planners import expert as E_  # noqa: E402
from repro_torch.models import moe as X  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
BF16_RTOL = 1e-2 * np.sqrt(3)
B, S = 2, 16
SMALL = dict(d_model=32, num_experts=4, moe_d_ff=48)


def _cfgs(**kw):
    kw = {**SMALL, **kw}
    return JR.tiny_config("moe", **kw), R.tiny_config("moe", **kw)


def _weights(cfg, seed):
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    w = lambda *shape: (rng.standard_normal(shape) * shape[-2] ** -0.5
                        ).astype(np.float32)  # noqa: E731
    p = {"router": w(d, E), "wg": w(E, d, ff), "wu": w(E, d, ff),
         "wo": w(E, ff, d)}
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        p["shared"] = {"wg": w(d, sff), "wu": w(d, sff), "wo": w(sff, d)}
    return p


def _both(p, dtype):
    """numpy weights -> (jax tree, torch tree); the router stays float32."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def conv(tree, router=False):
        if isinstance(tree, dict):
            pairs = {k: conv(v, k == "router") for k, v in tree.items()}
            return ({k: a for k, (a, _) in pairs.items()},
                    {k: b for k, (_, b) in pairs.items()})
        a = jnp.asarray(tree, jnp.float32 if router else jdt)
        t = torch.from_numpy(tree).to(torch.float32 if router else tdt)
        return a, t
    return conv(p)


def _x(cfg, seed, batch=B, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(
        (batch, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _ref_routing(cfg, params, x):
    """The reference's routing, its own expressions (``repro.models.moe``),
    per queue: [G, n, K] expert ids and ranks, the kept mask."""
    E, K = cfg.num_experts, cfg.top_k
    Bx, Sx, d = x.shape
    if cfg.moe_row_dispatch:
        logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                            params["router"])
        n = Sx
    else:
        logits = (x.reshape(1, Bx * Sx, d).astype(jnp.float32)
                  @ params["router"])
        n = Bx * Sx
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    cap = int(max(1, round(n * K / E * cfg.capacity_factor)))
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = onehot.reshape(idx.shape[0], n * K, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos.reshape(onehot.shape) * onehot, axis=-1)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)


def _port_routing(cfg, params, x):
    Bx, Sx, d = x.shape
    E = cfg.num_experts
    logits = (x.reshape(-1, d).float() @ params["router"]).reshape(Bx, Sx, E)
    n = Sx if cfg.moe_row_dispatch else Bx * Sx
    cap = X.capacity(n, cfg)
    r = X.route(cfg, logits.reshape(-1, n, E), cap, cap)
    return r


def _rows_close(got, want, rtol):
    """Per row of the last axis: max |a - b| <= rtol * max |b| + 1e-6."""
    got = got.detach().float().numpy().reshape(-1, got.shape[-1])
    want = np.asarray(want, np.float32).reshape(got.shape)
    err = np.abs(got - want).max(axis=-1)
    scale = np.abs(want).max(axis=-1)
    assert (err <= rtol * scale + 1e-6).all(), (err / scale).max()


CASES = [(dispatch, act, shared, cf, dtype)
         for dispatch in ("global", "row")
         for act in ("silu", "relu2")
         for shared in (0, 1)
         for cf in (1.25, 16.0)
         for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("dispatch,act,shared,cf,dtype", CASES)
def test_apply_moe_matches_reference(dispatch, act, shared, cf, dtype):
    cfg_j, cfg_t = _cfgs(activation=act, num_shared_experts=shared,
                         capacity_factor=cf, dtype=dtype,
                         moe_row_dispatch=dispatch == "row")
    pj, pt = _both(_weights(cfg_t, 1), dtype)
    xj, xt = _x(cfg_t, 2, dtype=dtype)
    idx, pos, keep = _ref_routing(cfg_j, pj, xj)
    r = _port_routing(cfg_t, pt, xt)
    assert (r["gate_idx"].numpy() == idx).all()
    assert (r["pos"].numpy() == pos).all()
    assert (r["keep"].numpy() == keep).all()
    assert keep.all() == (cf == 16.0)         # 1.25 really drops tokens
    oj, aj = JX.apply_moe(pj, cfg_j, xj)
    ot, at = X.apply_moe(pt, cfg_t, xt)
    assert ot.dtype == xt.dtype and ot.shape == xt.shape
    assert at.dtype == torch.float32
    np.testing.assert_allclose(float(at), float(aj), **F32)
    if dtype == "float32":
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32)
    else:
        _rows_close(ot, oj.astype(jnp.float32), BF16_RTOL)


def test_route_maps_are_inverse():
    """Each kept pair's place names it back; dropped pairs and empty
    places point past the end; places of one expert fill from 0."""
    _, cfg = _cfgs(capacity_factor=1.25)
    pt = _both(_weights(cfg, 3), "float32")[1]
    r = _port_routing(cfg, pt, _x(cfg, 4)[1])
    dst, src = r["dst"].numpy(), r["src"].numpy()
    keep = r["keep"].numpy().reshape(-1)
    pairs = np.arange(dst.size)
    assert (src[dst[keep]] == pairs[keep]).all()
    assert (dst[~keep] == src.size).all()
    assert ((src == dst.size) | (dst[np.minimum(src, dst.size - 1)]
                                 == np.arange(src.size))).all()
    assert (src != dst.size).sum() == keep.sum()


def test_route_to_given_experts():
    """``experts`` routes to those experts: the top-k themselves give the
    same routing; others take their own probabilities as gates, and ranks
    and drops follow them."""
    _, cfg = _cfgs(capacity_factor=1.25)
    pt = _both(_weights(cfg, 13), "float32")[1]
    x = _x(cfg, 14)[1]
    logits = (x.reshape(-1, cfg.d_model) @ pt["router"]).reshape(1, -1, 4)
    cap = X.capacity(logits.shape[1], cfg)
    r = X.route(cfg, logits, cap, cap)
    same = X.route(cfg, logits, cap, cap, r["gate_idx"])
    assert all(torch.equal(r[k], same[k]) for k in r)
    other = (r["gate_idx"] + 1) % 4
    forced = X.route(cfg, logits, cap, cap, other)
    assert torch.equal(forced["gate_idx"], other)
    probs = torch.softmax(logits, -1).gather(-1, other)
    want = probs / probs.sum(-1, keepdim=True) * forced["keep"]
    assert torch.equal(forced["gate"], want)
    flat = torch.nn.functional.one_hot(other, 4).reshape(-1, 4)
    ranks = ((torch.cumsum(flat, 0) - flat) * flat).sum(-1)
    assert torch.equal(forced["pos"].reshape(-1), ranks)


@pytest.mark.parametrize("dispatch,act", [("global", "silu"),
                                          ("global", "relu2"),
                                          ("row", "silu"), ("row", "relu2")])
def test_grads_match_reference(dispatch, act):
    cfg_j, cfg_t = _cfgs(activation=act, num_shared_experts=1,
                         capacity_factor=1.25, router_aux_loss=0.5,
                         moe_row_dispatch=dispatch == "row")
    pj, pt = _both(_weights(cfg_t, 5), "float32")
    xj, xt = _x(cfg_t, 6)
    cot = np.random.default_rng(7).standard_normal(xt.shape) \
        .astype(np.float32)

    def loss_j(p, x):
        o, aux = JX.apply_moe(p, cfg_j, x)
        return jnp.sum(o * cot) + aux
    gp_j, gx_j = jax.grad(loss_j, argnums=(0, 1))(pj, xj)

    leaves = [pt["router"], pt["wg"], pt["wu"], pt["wo"],
              *pt["shared"].values(), xt]
    for t in leaves:
        t.requires_grad_(True)
    o, aux = X.apply_moe(pt, cfg_t, xt)
    (torch.sum(o * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **GRAD)
    for k in ("router", "wg", "wo") + (("wu",) if act == "silu" else ()):
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(gp_j[k]),
                                   **GRAD)
    for k, t in pt["shared"].items():
        if act == "silu" or k != "wu":
            np.testing.assert_allclose(t.grad.numpy(),
                                       np.asarray(gp_j["shared"][k]), **GRAD)
    if act == "relu2":      # nothing reads wu: no gradient, the reference's 0
        assert pt["wu"].grad is None and not np.asarray(gp_j["wu"]).any()


@pytest.mark.parametrize("dispatch", ["global", "row"])
@pytest.mark.parametrize("cf", [1.25, 16.0])
def test_rows_route_like_the_gathered_rows(dispatch, cf):
    """``rows`` routes those rows, in that order, as the reference routes
    the gathered rows alone (``cap`` from them); the other rows are zero;
    the aux loss is theirs."""
    cfg_j, cfg_t = _cfgs(num_shared_experts=1, capacity_factor=cf,
                         moe_row_dispatch=dispatch == "row")
    pj, pt = _both(_weights(cfg_t, 8), "float32")
    xj, xt = _x(cfg_t, 9, batch=5)
    rows = np.array([3, 0, 4])
    oj, aj = JX.apply_moe(pj, cfg_j, xj[rows])
    ot, at = X.apply_moe(pt, cfg_t, xt, rows=torch.from_numpy(rows))
    np.testing.assert_allclose(ot[rows].numpy(), np.asarray(oj), **F32)
    assert not ot[[1, 2]].any()
    np.testing.assert_allclose(float(at), float(aj), **F32)
    # the whole batch's routing would rank other tokens first
    if dispatch == "global" and cf == 1.25:
        full, _ = X.apply_moe(pt, cfg_t, xt)
        assert not torch.allclose(full[rows], ot[rows])


def test_bucket_layout_keeps_the_batch_capacity():
    """The expert products see [E, cap(B * S), d] whatever ``rows`` holds."""
    _, cfg = _cfgs(capacity_factor=1.25)
    pt = _both(_weights(cfg, 10), "float32")[1]
    x = _x(cfg, 11, batch=4)[1]
    seen = []
    orig = X._experts
    try:
        X._experts = lambda p, c, b: seen.append(tuple(b.shape)) \
            or orig(p, c, b)
        for rows in ([0], [2, 1], [0, 1, 2, 3]):
            X.apply_moe(pt, cfg, x, rows=torch.tensor(rows))
    finally:
        X._experts = orig
    want = (cfg.num_experts, X.capacity(4 * S, cfg), cfg.d_model)
    assert seen == [want] * 3


@pytest.mark.parametrize("act,shared", [("silu", 1), ("relu2", 0)])
def test_init_moe_shapes_match_reference(act, shared):
    cfg_j, cfg_t = _cfgs(activation=act, num_shared_experts=shared,
                         dtype="bfloat16")
    pj = JX.init_moe(jax.random.key(0), cfg_j)
    pt = X.init_moe(torch.Generator().manual_seed(0), cfg_t)
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    from repro_torch.core.statespace import tree_leaves
    leaves = tree_leaves(pt)
    assert len(flat_j) == len(leaves)
    for (_, a), t in zip(flat_j, leaves):
        assert tuple(a.shape) == tuple(t.shape)
        assert str(a.dtype) == str(t.dtype).removeprefix("torch.")
    assert pt["router"].dtype == torch.float32
    assert ("shared" in pt) == bool(shared)


# ---------------------------------------------------------------------------
# the expert planner
# ---------------------------------------------------------------------------
def _plan(plan):
    return (plan.placement, [dataclasses.astuple(m) for m in plan.moves],
            plan.max_load, plan.est_seconds)


@pytest.mark.parametrize("seed", range(6))
def test_expert_planner_matches_reference(seed):
    rng = np.random.default_rng(seed)
    E, W = int(rng.integers(4, 12)), int(rng.integers(2, 5))
    load = [float(v) for v in rng.gamma(1.5, 2.0, E)]
    workers = list(range(W))
    assert E_.lpt_placement(load, workers) == JE.lpt_placement(load, workers)
    pinned = {0: W - 1, 1: 0}
    assert E_.lpt_placement(load, workers, pinned) == \
        JE.lpt_placement(load, workers, pinned)
    old = {e: int(rng.integers(W)) for e in range(E)}
    dead = int(rng.integers(W))
    surviving = [w for w in workers if w != dead]
    holder = {e: (w + 1) % W for e, w in old.items()}
    for kw in (dict(), dict(snapshot_holder=holder),
               dict(snapshot_holder=holder, rebalance_survivors=True),
               dict(link_bw=10e9)):
        got = E_.plan_expert_reshard(load, old, surviving, 4096, **kw)
        want = JE.plan_expert_reshard(load, old, surviving, 4096, **kw)
        assert _plan(got) == _plan(want)
        assert got.loads(load, surviving) == want.loads(load, surviving)
    if E <= 7:
        assert E_.brute_force_placement(load, workers[:3]) == \
            JE.brute_force_placement(load, workers[:3])


def test_expert_planner_reference_cases():
    """The reference's own cases (tests/test_expert_planner.py), the
    port's plans equal to the reference's."""
    E, W = 8, 4
    old = {e: e % W for e in range(E)}
    holder = {e: (e % W + 1) % W for e in range(E)}
    args = ([1.0] * E, old, [0, 1, 3], 1000)
    got = E_.plan_expert_reshard(*args, snapshot_holder=holder)
    assert _plan(got) == _plan(JE.plan_expert_reshard(
        *args, snapshot_holder=holder))
    assert {m.expert for m in got.moves} == {2, 6}
    assert all(m.from_snapshot for m in got.moves) and got.est_seconds > 0
    load = [10.0, 1.0, 1.0, 1.0]
    for old in ({0: 0, 1: 0, 2: 1, 3: 1}, {0: 2, 1: 0, 2: 0, 3: 1}):
        assert _plan(E_.plan_expert_reshard(load, old, [0, 1], 10)) == \
            _plan(JE.plan_expert_reshard(load, old, [0, 1], 10))
    assert E_.plan_expert_reshard(load, {0: 2, 1: 0, 2: 0, 3: 1}, [0, 1],
                                  10).placement[0] == 1
    for E in range(3, 9):
        for W in range(2, 5):
            old = {e: e % W for e in range(E)}
            got = E_.plan_expert_reshard([1.0] * E, old, list(range(1, W)),
                                         64)
            assert _plan(got) == _plan(JE.plan_expert_reshard(
                [1.0] * E, old, list(range(1, W)), 64))
            assert {m.expert for m in got.moves} == \
                {e for e, w in old.items() if w == 0}
    loads = np.random.default_rng(12).uniform(0.1, 10.0, (30, 6))
    for row in loads:
        for W in (2, 3):
            workers = list(range(W))
            pl = E_.lpt_placement(list(row), workers)
            got = {w: 0.0 for w in workers}
            for e, w in pl.items():
                got[w] += row[e]
            opt = E_.brute_force_placement(list(row), workers)
            assert opt == JE.brute_force_placement(list(row), workers)
            assert max(got.values()) <= opt * (4 / 3 - 1 / (3 * W)) + 1e-9
