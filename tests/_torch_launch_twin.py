"""The launcher-step twin of ``tests/test_torch_train_launch*.py``: one
``launch.train.train_step`` of a smoke config against the reference's
un-jitted ``value_and_grad`` + ``adam_update``.  Not a test module:
nothing here is collected.

Both packages start from the reference's weights (drawn under ``jit``:
any weights do, and the un-jitted draw of the MoE and MLA smoke configs
takes seconds) through ``weights.params_from_stacked``, on the
launcher's own batch (``make_batch`` of step 0's sample ids and the
port's frames or prefix embeddings, handed to both).  The loss is held
within 1e-5 relative.  The gradients the step hands to AdamW are held
within 1e-5, absolute or of the leaf's largest gradient where that is
above 1 (the mamba2 smoke config's loss is ~30, and its float32 chunked
scans sum in another order than the reference's).  AdamW then runs on the
reference's gradients, and parameters, mu, nu and master (back through
the same converter) are held to the ``fused_adam`` tier (rtol 1e-6, atol
1e-7): AdamW's first step is ``g / (|g| + eps)``, so on a gradient
element within a few eps (1e-8) of zero it turns the gradients' own
rounding into up to ``lr`` of a parameter, which no tier of the update
could hold apart from the gradients'.  MoE routing is compared as
``tests/test_torch_moe.py`` compares it: the smoke steps must route as
the reference (no near-tie flipped on these draws, or the loss and the
gradients would miss their bounds).
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.models import registry as JR
from repro.optim import adam as JA
from repro_torch import configs
from repro_torch.data import pipeline as P
from repro_torch.launch import train as TR
from repro_torch.models import registry as R
from repro_torch.optim import adam as A
from repro_torch.tree import at, leaves_with_paths
from repro_torch.weights import params_from_stacked

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
ADAM_TIER = dict(rtol=1e-6, atol=1e-7)       # ops.TOLERANCE_TIERS fused_adam
BATCH, SEQ = 2, 16
IS_STATE = lambda x: isinstance(x, dict) and "mu" in x     # noqa: E731


def _np(t):
    return t.detach().float().numpy()


def _component(opt_leaves, c):
    """The reference's optimizer leaves' component ``c``, as a tree of the
    parameters' structure."""
    return jax.tree.map(lambda st: st[c], opt_leaves, is_leaf=IS_STATE)


def _batches(cfg_t):
    """The launcher's step-0 batch on the CPU, and the same arrays for the
    reference (its int32 tokens)."""
    ids = P.GlobalBatchSampler(BATCH).sample_ids(0)
    bt = P.make_batch(ids, SEQ, cfg_t.vocab_size, device="cpu")
    bt.update(TR.extra_inputs(cfg_t, 0, BATCH, SEQ, "cpu"))
    bj = {k: jnp.asarray(v.numpy().astype(np.int32) if v.is_floating_point()
                         is False else v.numpy()) for k, v in bt.items()}
    return bt, bj


def check_launcher_step(arch: str, monkeypatch) -> None:
    """One launcher step of ``arch``'s smoke config against the
    reference's, within the bounds above."""
    cfg_j, cfg_t = jconfigs.get_smoke_config(arch), \
        configs.get_smoke_config(arch)
    pj = jax.jit(JR.init_model, static_argnums=1)(jax.random.key(0), cfg_j)
    pt = params_from_stacked(cfg_t, pj, "cpu")
    bt, bj = _batches(cfg_t)
    adam_j, adam = JA.AdamConfig(lr=1e-3), A.AdamConfig(lr=1e-3)

    # the reference: un-jitted, as tests/test_arch_smoke.py
    opt_j = JA.init_opt_state(pj, adam_j)
    lj, gj = jax.value_and_grad(JR.make_train_loss(cfg_j))(pj, bj)
    pj2, opt_j2 = JA.adam_update(pj, gj, opt_j, adam_j)

    # the port's launcher step, its gradients seen on their way to AdamW
    seen = {}
    update = A.adam_update

    def capture(params, grads, state, cfg):
        seen["grads"] = grads
        return update(params, params_from_stacked(cfg_t, gj, "cpu"), state,
                      cfg)
    monkeypatch.setattr(A, "adam_update", capture)
    opt = A.init_opt_state(pt, adam)
    leaves = [t for _, t in leaves_with_paths(pt)]
    for t in leaves:
        t.requires_grad_(True)
    lt, opt = TR.train_step(pt, opt, bt, R.make_train_loss(cfg_t), adam)
    for t in leaves:
        t.requires_grad_(False)
    assert all(t.grad is None for t in leaves)
    assert opt["step"] == int(opt_j2["step"]) == 1
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))

    paths = [p for p, _ in leaves_with_paths(pt)]
    assert sum(at(pt, p).numel() for p in paths) == \
        sum(a.size for a in jax.tree.leaves(pj))
    want = {"param": params_from_stacked(cfg_t, pj2, "cpu"),
            "grad": params_from_stacked(cfg_t, gj, "cpu"),
            **{c: params_from_stacked(cfg_t, _component(opt_j2["leaves"], c),
                                      "cpu") for c in ("mu", "nu", "master")}}
    for path in paths:
        where = f"{arch} {'/'.join(map(str, path))}"
        g = at(seen["grads"], path)
        gw = _np(at(want["grad"], path))
        np.testing.assert_allclose(
            np.zeros(gw.shape) if g is None else _np(g), gw, rtol=GRAD_TOL,
            atol=GRAD_TOL * max(1.0, float(np.abs(gw).max())), err_msg=where)
        np.testing.assert_allclose(_np(at(pt, path)),
                                   _np(at(want["param"], path)),
                                   **ADAM_TIER, err_msg=where)
        for c in ("mu", "nu", "master"):
            np.testing.assert_allclose(
                _np(at(opt["leaves"], path)[c]), _np(at(want[c], path)),
                **ADAM_TIER, err_msg=f"{where} {c}")


