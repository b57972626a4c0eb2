"""The tree-level AdamW of the port (``repro_torch.optim.adam``:
``init_opt_state``, ``adam_update``) on the CPU against the reference's
eager ``repro.optim.adam`` and against the flat numpy oracle
``adam_update_flat_np``.

Tolerances: the ``fused_adam`` tier (rtol 1e-6, atol 1e-7) against the
reference's eager update, whose bias corrections are ``1 - b **
float32(step)`` in float32 where the port's are the kernel's (double,
rounded once); bitwise against ``adam_update_flat_np``, whose corrections
the port shares.  The mamba2 smoke config (tied): no head matrix, one
state a parameter, as many as the reference's, and the logits read the
updated embedding through a launcher step.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adam as A  # noqa: E402
from repro_torch.tree import at, leaves_with_paths  # noqa: E402
from repro_torch.weights import params_from_stacked  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

ADAM_TIER = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"w": (16, 24), "b": (24,), "blocks": [(8, 8), (5,)]}
STEPS = 3


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(fn, v) for v in shapes]
    return fn(shapes)


def _draws(seed):
    rs = np.random.default_rng(seed)
    params = _tree(lambda s: rs.standard_normal(s).astype(np.float32))
    grads = [_tree(lambda s: (rs.standard_normal(s) * 10.0 ** rs.integers(
        -4, 1, s)).astype(np.float32)) for _ in range(STEPS)]
    return params, grads


def _f32(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [True, False])
def test_update_matches_reference_and_flat_oracle(dtype, master):
    """3 steps of a tree with a ``None`` gradient on one leaf at step 2
    (zero, as the reference's gradient of a leaf no loss reads), against
    the reference's eager ``adam_update`` (the tier) and, leaf by leaf,
    ``adam_update_flat_np`` (bitwise)."""
    cfg = A.AdamConfig(lr=1e-2, master_weights=master)
    jcfg = JA.AdamConfig(lr=1e-2, master_weights=master)
    params, grads = _draws(1)
    tdt = getattr(torch, dtype)
    pj = jax.tree.map(lambda a: jnp.asarray(a, dtype=dtype), params)
    pt = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), params)
    sj, st = JA.init_opt_state(pj, jcfg), A.init_opt_state(pt, cfg)
    assert sorted(st["leaves"]["w"]) == (["master", "mu", "nu"] if master
                                         else ["mu", "nu"])
    for step, g in enumerate(grads):
        if step == 1:
            g = dict(g, b=np.zeros_like(g["b"]))
        gt = jax.tree.map(torch.from_numpy, g)
        if step == 1:
            gt["b"] = None
        # the flat oracle on each leaf's state before the step
        want = {}
        for path, p in leaves_with_paths(pt):
            s = at(st["leaves"], path)
            base = s["master"] if master else p.float()
            want[path] = A.adam_update_flat_np(
                at(g, path).reshape(-1),
                {"master": base.numpy().reshape(-1).copy(),
                 "mu": s["mu"].numpy().reshape(-1).copy(),
                 "nu": s["nu"].numpy().reshape(-1).copy()},
                step + 1, cfg)
        pj, sj = JA.adam_update(pj, jax.tree.map(jnp.asarray, g), sj, jcfg)
        pt2, st = A.adam_update(pt, gt, st, cfg)
        assert pt2 is pt and st["step"] == int(sj["step"]) == step + 1
        for path, p in leaves_with_paths(pt):
            s, w = at(st["leaves"], path), want[path]
            new_master = s["master"] if master else p.float()
            for c, got in (("mu", s["mu"]), ("nu", s["nu"])):
                np.testing.assert_array_equal(got.numpy().reshape(-1), w[c])
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(at(sj["leaves"], path)[c]),
                    **ADAM_TIER)
            # the parameter: the oracle's master rounded to its dtype
            np.testing.assert_array_equal(
                p.reshape(-1).numpy() if dtype == "float32" else
                _f32(p.reshape(-1)),
                _f32(torch.from_numpy(w["master"]).to(tdt)))
            if master:
                np.testing.assert_array_equal(new_master.numpy().reshape(-1),
                                              w["master"])
                np.testing.assert_allclose(
                    new_master.numpy(),
                    np.asarray(at(sj["leaves"], path)["master"]),
                    **ADAM_TIER)
            if dtype == "float32":
                np.testing.assert_allclose(
                    p.numpy(), np.asarray(at(pj, path)), **ADAM_TIER)


def _mamba2_smoke():
    cfg_j = jconfigs.get_smoke_config("mamba2_2p7b")
    cfg_t = configs.get_smoke_config("mamba2_2p7b")
    pj = jax.jit(JR.init_model, static_argnums=1)(jax.random.key(0), cfg_j)
    return cfg_j, cfg_t, pj, params_from_stacked(cfg_t, pj, "cpu")


@pytest.mark.parametrize("master", [True, False])
def test_tied_tree_keeps_one_state_a_parameter(master):
    """The tied tree (mamba2's smoke config) has no head matrix, as the
    reference's: one optimizer state a parameter, the reference's count of
    leaves per layer (its stacked segment leaves counted once a layer), no
    state for a head; through a launcher step the logits read the updated
    embedding, transposed."""
    cfg_j, cfg_t, pj, pt = _mamba2_smoke()
    assert cfg_t.tie_embeddings and "head" not in pj
    stem, _, head = pt
    assert sorted(head) == ["final_norm"]
    jcfg = JA.AdamConfig(lr=1e-3, master_weights=master)
    cfg = A.AdamConfig(lr=1e-3, master_weights=master)
    sj, st = JA.init_opt_state(pj, jcfg), A.init_opt_state(pt, cfg)
    per_layer = sum(a.shape[0] if p[0].key == "segments" else 1
                    for p, a in jax.tree_util.tree_flatten_with_path(
                        sj["leaves"])[0])
    assert len(leaves_with_paths(st["leaves"])) == per_layer \
        == (3 if master else 2) * len(leaves_with_paths(pt))
    assert sorted(st["leaves"][2]) == ["final_norm"]
    emb = stem["embed"]["embedding"]
    before = emb.clone()
    leaves = [t for _, t in leaves_with_paths(pt)]
    for t in leaves:
        t.requires_grad_(True)
    b = P.make_batch(P.GlobalBatchSampler(2).sample_ids(0), 16,
                     cfg_t.vocab_size, device="cpu")
    loss, st = TR.train_step(pt, st, b, R.make_train_loss(cfg_t), cfg)
    for t in leaves:
        t.requires_grad_(False)
    assert torch.isfinite(loss) and st["step"] == 1
    assert not torch.equal(emb, before)
    untied = (stem, pt[1], dict(head, head={"w": emb.T.clone()}))
    logits = T.forward(pt, cfg_t, b["tokens"])[0]
    want = T.forward(untied, dataclasses.replace(cfg_t, tie_embeddings=False),
                     b["tokens"])[0]
    assert torch.equal(logits, want)
