"""The port's bf16 tiny train steps on the CPU against the JAX package's fast
path, from the reference's exact initial weights.

The float32 twins (``test_torch_cluster.py``) cannot reach the bf16
tensor-core routes: these configurations do on the card (``chip_smoke.py``
phase 4 runs them there against this CPU path).  The dense one at d_model
256 has head_dim 64 (``flash_attention_sm90``), the ssm one headdim 64,
state 64 and chunk 64 (``ssd_scan_sm90``).  Two more dense ones keep the
tiny config's 4 heads and 2 kv heads at d_model 64 (head_dim 16) and 128
(head_dim 32), the widths of ``flash_attention_bf16_mma``.

Both sides round activations and gradients to bf16, but at different
places, so the float32 kernel-consistency bounds do not apply.  The bf16
bound: losses within one bf16 spacing, 2**-7 relative; master/mu/nu
within 2**-7 relative on top of the reference's step-sign allowance
``PARAM_ATOL0 + 2*lr*opt_step`` (each Adam step moves an element by at
most ~lr, in either direction, when the two gradients differ in sign).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core.cluster import VirtualCluster as JCluster  # noqa: E402
from repro.core.invariants import KernelConsistencyChecker as KCC  # noqa: E402
from repro.models.registry import tiny_config as j_tiny  # noqa: E402
from repro_torch.core.cluster import VirtualCluster  # noqa: E402
from repro_torch.models.registry import tiny_config  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: E402,F401

#: the bf16 twins' bound (see the module docstring); chip_smoke.py declares
#: the same for the card against this CPU path
BF16_LOSS_RTOL, BF16_PARAM_RTOL = 2.0 ** -7, 2.0 ** -7
#: the bf16 tiny configurations on the tensor-core routes: name ->
#: (family, config overrides)
BF16_TWINS = {
    "dense": ("dense", dict(dtype="bfloat16", d_model=256)),
    "ssm": ("ssm", dict(dtype="bfloat16", ssm_headdim=64, ssm_state=64,
                        ssm_chunk=64, num_layers=2)),
    "dense-hd16": ("dense", dict(dtype="bfloat16")),
    "dense-hd32": ("dense", dict(dtype="bfloat16", d_model=128)),
}
#: what each twin's config must have: head_dim, or ssm (headdim, state,
#: chunk)
BF16_TWIN_WIDTHS = {"dense": 64, "ssm": (64, 64, 64), "dense-hd16": 16,
                    "dense-hd32": 32}
KW = dict(global_batch=8, num_micro=2, seq_len=128)
STEPS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("family", list(BF16_TWINS))
def test_bf16_train_step_twin_vs_reference(family):
    fam, kw = BF16_TWINS[family]
    ref = JCluster(j_tiny(fam, **kw), 2, 2, **KW)
    cfg = tiny_config(fam, **kw)
    if fam == "dense":
        assert cfg.head_dim == BF16_TWIN_WIDTHS[family]
        assert (cfg.num_heads, cfg.num_kv_heads) == (4, 2)
    else:
        assert (cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk) \
            == BF16_TWIN_WIDTHS[family]
    cl = VirtualCluster(cfg, 2, 2, device="cpu", init_params=(
        _np(ref.stem), _np(ref.layer_params), _np(ref.head)), **KW)
    for st, js in zip(cl.stages, ref.stages):
        assert st.entries == js.entries and st.sizes == js.sizes
        for c in ("master", "mu", "nu"):
            np.testing.assert_array_equal(st.flat[c].numpy(), js.flat[c])
    for step in range(STEPS):
        a, b = cl.train_step(), ref.train_step()
        assert np.isfinite(a) and abs(a - b) <= BF16_LOSS_RTOL * abs(b), \
            (step, a, b)
        atol = KCC.PARAM_ATOL0 + 2.0 * ref.adam.lr * ref.opt_step
        for st, js in zip(cl.stages, ref.stages):
            for c in ("master", "mu", "nu"):
                np.testing.assert_allclose(st.full(c).numpy(), js.full(c),
                                           rtol=BF16_PARAM_RTOL, atol=atol)
    assert cl.opt_step == ref.opt_step == STEPS
    assert cl.layer_assignment == ref.layer_assignment


def test_params_from_numpy_takes_tensor_leaves():
    """The card twins hand the CPU cluster's own trees over as tensors, so
    bf16 leaves stay bf16 (``params_to_numpy`` would give float32) and
    each leaf is a copy."""
    from repro_torch.weights import params_from_numpy, params_to_numpy
    fam, kw = BF16_TWINS["dense"]
    cfg = tiny_config(fam, **kw)
    cl = VirtualCluster(cfg, 2, 2, device="cpu", **KW)
    trees = (cl.stem, cl.layer_params, cl.head)
    leaves = jax.tree_util.tree_leaves(
        params_from_numpy(*trees, device="cpu"))
    assert torch.bfloat16 in {t.dtype for t in cl._leaves}
    for new, old in zip(leaves, cl._leaves):
        assert new.dtype == old.dtype and torch.equal(new, old)
        assert new.data_ptr() != old.data_ptr() and not new.requires_grad
    via_numpy = jax.tree_util.tree_leaves(
        params_from_numpy(*params_to_numpy(*trees), device="cpu"))
    assert {t.dtype for t in via_numpy} == {torch.float32}
