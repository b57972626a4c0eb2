"""The port's kernel corpus (``repro_torch.kernels.check``) against the JAX
package's, on the CPU.

The corpus has the reference's cases: the same labels, the same
``TOLERANCE_TIERS`` keys and tiers, the same shapes.  Each case's inputs
(the port draws them with numpy, so they differ from the reference's
``jax.random`` ones), fed through the reference's plain versions
(``repro.kernels.ref``, ``adam_update_flat_np``) and through its Pallas
kernels in interpret mode, must agree with the port's plain versions within
the case's tier; Adam bitwise against the numpy oracle.
``check_kernels(device="cpu")`` rows are all within tolerance, and the card
corpus raises without a card.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import check as j_check  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.optim.adam import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim.adam import adam_update_flat_np as j_adam  # noqa: E402

from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels.check import (case_row, check_kernels,  # noqa: E402
                                       kernel_cases)


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def reference_outputs(case, pallas: bool):
    """The reference's plain version (``pallas=False``) or Pallas kernel in
    interpret mode (``pallas=True``) on the port case's inputs."""
    x = case.inputs
    if case.name == "flash_attention":
        q, k, v = _j(x["q"]), _j(x["k"]), _j(x["v"])
        if pallas:
            return [j_ops.flash_attention(q, k, v, causal=x["causal"])]
        B, S, H, hd = q.shape
        rep = H // k.shape[2]
        kf = jnp.repeat(k, rep, axis=2).transpose(0, 2, 1, 3).reshape(
            B * H, S, hd)
        vf = jnp.repeat(v, rep, axis=2).transpose(0, 2, 1, 3).reshape(
            B * H, S, hd)
        qf = q.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
        o = j_ref.mha_reference(qf, kf, vf, causal=x["causal"])
        return [o.reshape(B, H, S, hd).transpose(0, 2, 1, 3)]
    if case.name == "rmsnorm":
        fn = j_ops.rmsnorm if pallas else j_ref.rmsnorm_reference
        return [fn(_j(x["x"]), _j(x["scale"]), eps=x["eps"])]
    if case.name == "ssd_scan":
        args = [_j(x[k]) for k in ("x", "dt", "A", "B", "C")]
        if pallas:
            return [j_ops.ssd_scan(*args, chunk=x["chunk"])[0]]
        rep = args[0].shape[2] // args[3].shape[2]
        y, _ = j_ref.ssd_reference(*args[:3], jnp.repeat(args[3], rep, 2),
                                   jnp.repeat(args[4], rep, 2))
        return [y]
    assert case.name == "fused_adam"
    cfg = JAdamConfig()
    st = {c: x[c] for c in ("master", "mu", "nu")}
    if pallas:
        return list(j_ops.fused_adam(
            _j(x["grad"]), *(_j(st[c]) for c in ("master", "mu", "nu")),
            step=x["step"], b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, lr=cfg.lr,
            weight_decay=cfg.weight_decay))
    out = j_adam(x["grad"], st, x["step"], cfg)
    return [out[c] for c in ("master", "mu", "nu")]


def test_corpus_labels_and_tiers_match_reference():
    want = [(c.name, c.label) for c in j_check.kernel_cases(seed=0)]
    got = [(c.name, c.label) for c in kernel_cases(seed=0, device="cpu")]
    assert got == want
    for name, _ in got:
        assert t_ops.TOLERANCE_TIERS[name] == j_ops.TOLERANCE_TIERS[name]


def test_corpus_shapes_match_reference():
    cases = {c.label: c for c in kernel_cases(seed=0, device="cpu")}
    for jc in j_check.kernel_cases(seed=0):
        got = [o.shape for o in cases[jc.label].run_kernel()]
        assert got == [o.shape for o in jc.run_ref()], jc.label
        assert all(o.dtype == np.float32 for o in cases[jc.label].run_ref())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
def test_port_inputs_through_reference_within_tier(seed, pallas):
    for case in kernel_cases(seed=seed, device="cpu"):
        want = [np.asarray(o, np.float32)
                for o in reference_outputs(case, pallas)]
        tier = case.tier
        for got in (case.run_kernel(), case.run_ref()):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                if case.name == "fused_adam" and not pallas:
                    # bitwise against the numpy oracle; the Pallas kernel
                    # is held to its tier, as the reference holds it
                    np.testing.assert_array_equal(g, w, err_msg=case.label)
                else:
                    np.testing.assert_allclose(g, w, rtol=tier["rtol"],
                                               atol=tier["atol"],
                                               err_msg=case.label)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_check_kernels_on_cpu_within_tolerance(seed):
    rows = check_kernels(seed=seed, device="cpu")
    assert [r["case"] for r in rows] == \
        [c.label for c in kernel_cases(seed=seed, device="cpu")]
    assert all(r["within_tolerance"] for r in rows), rows
    # the seed moves the inputs
    a, b = (kernel_cases(seed=s, device="cpu")[0].inputs["q"]
            for s in (seed, seed + 1))
    assert not torch.equal(a, b)
    assert case_row(kernel_cases(seed=seed, device="cpu")[-1])[
        "max_abs_err"] == 0.0


def test_card_corpus_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the corpus runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_cases(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_kernels(seed=0, device="cuda")
