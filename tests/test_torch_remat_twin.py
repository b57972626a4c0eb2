"""Remat on the CPU against the JAX package: tiny twins of every family
(dense, moe, ssm, hybrid, MLA, enc-dec, vlm prefix) through
``make_train_loss(cfg, remat=True)`` against the reference's
``make_train_loss(cfg, remat=True)`` under ``jax.value_and_grad``
(jitted), weights carried over by ``weights.params_from_stacked``, at
dropout 0.1 (the enc-dec model has none, in both packages): the loss
within 1e-5 relative, every gradient within ``GRAD`` (rtol 1e-4, atol
2e-5, the gradient tier of ``tests/test_torch_encdec.py`` and
``tests/test_torch_vlm.py``; float32 on both sides).  The configs, batch
and dropout addressing are ``tests/test_torch_remat.py``'s.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro.models.layers import RngCtx as JRngCtx  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402
from repro_torch.weights import params_from_stacked  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402
from test_torch_remat import (FAMILIES, SAMPLE_IDS, _batch,  # noqa: E402
                              _configs, _jkey, _port_loss_and_grads)

GRAD = dict(rtol=1e-4, atol=2e-5)
LOSS_RTOL = 1e-5


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_remat_matches_reference_remat(name):
    rate = 0.1
    cfg_j, cfg = _configs(name, rate)
    pj = JR.init_model(jax.random.key(0), cfg_j)
    params = params_from_stacked(cfg, pj, "cpu")
    batch = _batch(cfg, seed=1)
    jctx = JRngCtx(step_key=_jkey(), sample_ids=jnp.asarray(SAMPLE_IDS),
                   deterministic=False)
    loss_grad = jax.jit(jax.value_and_grad(JR.make_train_loss(cfg_j,
                                                              remat=True)))
    lj, gj = loss_grad(pj, {k: jnp.asarray(v) for k, v in batch.items()},
                       jctx)
    lt, gt = _port_loss_and_grads(cfg, params, batch, remat=True)
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    want = dict(leaves_with_paths(params_from_stacked(cfg, gj, "cpu")))
    assert want.keys() == gt.keys()
    for path, g in gt.items():
        np.testing.assert_allclose(g.numpy(), want[path].numpy(),
                                   err_msg=str(path), **GRAD)
