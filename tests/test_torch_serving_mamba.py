"""The port's Mamba2 serving pieces on the CPU against the JAX package:
``ssd_decode_step``, ``_causal_conv`` with a state, the final state of the
plain SSD scan (``ops.ssd_scan`` and ``ref.ssd_chunked``, ragged tails
padded with dt = 0) against the reference's ``ssd_chunked``, the prefill
branch of ``apply_mamba`` at a ragged length, and the prefill resumed
from a carried state (the plain chunked scan from ``initial_state``).

Inputs come from numpy with a seed.  Float32; tolerance ``FWD`` (rtol
1e-4, atol 1e-5, the ``ssd_scan`` tier of ``kernels/ops.py``): the port's
scan is the sequential oracle where the reference runs the chunked form.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import mamba as JM, registry as JR  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba as M, registry as R  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

FWD = dict(rtol=1e-4, atol=1e-5)
SSM = dict(num_layers=2, vocab_size=128)


def _close(got: torch.Tensor, want, tol=FWD):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


def _ssm_cfgs():
    return (JR.tiny_config("ssm", dropout_rate=0.0, **SSM),
            R.tiny_config("ssm", dropout_rate=0.0, **SSM))


def _ssd_inputs(b, s, h, p, n, g, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, state


def test_ssd_decode_step_matches_reference():
    x, dt, A, B, C, state = _ssd_inputs(2, 1, 4, 8, 16, 2, seed=4)
    yj, sj = JM.ssd_decode_step(*map(jnp.asarray, (x, dt, A, B, C, state)))
    yt, st = M.ssd_decode_step(*map(torch.as_tensor, (x, dt, A, B, C, state)))
    _close(yt, yj)
    _close(st, sj)


@pytest.mark.parametrize("seq", [1, 5])
def test_causal_conv_with_state_matches_reference(seq):
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    oj, nj = JM._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(st))
    ot, nt = M._causal_conv(*map(torch.as_tensor, (x, w, st)))
    _close(ot, oj)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("s,chunk", [(32, 8), (29, 8), (6, 8)])
def test_plain_final_state_matches_reference_chunked(s, chunk):
    """The state after the last row, from ``ops.ssd_scan``'s plain version
    (the sequential oracle) and ``ref.ssd_chunked``, against the
    reference's ``ssd_chunked`` (a ragged tail padded with dt = 0)."""
    x, dt, A, B, C, _ = _ssd_inputs(2, s, 4, 8, 16, 2, seed=s)
    _, fj = JM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                           chunk=min(chunk, s))
    xt, dtt, At, Bt, Ct = map(torch.as_tensor, (x, dt, A, B, C))
    _, fc = ref.ssd_chunked(xt, dtt, At, Bt, Ct, min(chunk, s))
    _close(fc, fj)
    if s % min(chunk, s) == 0:
        _, fo = ops.ssd_scan(xt, dtt, At, Bt, Ct, chunk=chunk,
                             return_final_state=True)
        _close(fo, fj)
    _, fp = M._prefill_scan(xt, dtt, At, Bt, Ct, min(chunk, s))
    _close(fp, fj)


def test_ssd_scan_without_final_state_returns_none():
    x, dt, A, B, C, _ = _ssd_inputs(1, 16, 4, 8, 16, 2, seed=9)
    y, fin = ops.ssd_scan(*map(torch.as_tensor, (x, dt, A, B, C)), chunk=8)
    assert fin is None and y.shape == (1, 16, 4, 8)


def test_mamba_prefill_of_ragged_length_matches_reference():
    """apply_mamba's prefill branch at s = 13 (chunk 8: a padded tail):
    output and both states against the reference's prefill-with-state."""
    cfg_j, cfg_t = _ssm_cfgs()
    pj = JM.init_mamba(jax.random.key(5), cfg_j)
    pt = {k: (torch.as_tensor(np.array(v)) if not isinstance(v, dict)
              else {kk: torch.as_tensor(np.array(vv))
                    for kk, vv in v.items()}) for k, v in pj.items()}
    x = np.random.default_rng(6).standard_normal(
        (1, 13, cfg_t.d_model)).astype(np.float32)
    yj, sj = JM.apply_mamba(pj, cfg_j, jnp.asarray(x),
                            state=JM.init_mamba_state(cfg_j, 1))
    st = M.init_mamba_state(cfg_t, 1)
    yt, st = M.apply_mamba(pt, cfg_t, torch.as_tensor(x), state=st,
                           cache_index=0)
    _close(yt, yj)
    _close(st["ssm"], sj["ssm"])
    _close(st["conv"], sj["conv"])


def test_mamba_prefill_resumed_from_a_state_raises():
    """A prefill resumed from a carried (nonzero) state at cache_index 3,
    s = 11 (chunk 8: a padded tail): output and both states against the
    reference's prefill-with-state from the same state, within ``FWD``;
    ``rows`` limits the state writes."""
    cfg_j, cfg_t = _ssm_cfgs()
    pj = JM.init_mamba(jax.random.key(7), cfg_j)
    pt = {k: (torch.as_tensor(np.array(v)) if not isinstance(v, dict)
              else {kk: torch.as_tensor(np.array(vv))
                    for kk, vv in v.items()}) for k, v in pj.items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 11, cfg_t.d_model)).astype(np.float32)
    zero = M.init_mamba_state(cfg_t, 2)
    carried = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
               for k, v in zero.items()}
    yj, sj = JM.apply_mamba(pj, cfg_j, jnp.asarray(x), state={
        k: jnp.asarray(v) for k, v in carried.items()})
    st = {k: torch.from_numpy(v.copy()) for k, v in carried.items()}
    yt, out = M.apply_mamba(pt, cfg_t, torch.as_tensor(x), state=st,
                            cache_index=torch.tensor([3, 3]))
    assert out is st
    _close(yt, yj)
    _close(st["ssm"], sj["ssm"])
    _close(st["conv"], sj["conv"])
    # rows=[1]: row 1's states advance as above, row 0's stay as carried
    st = {k: torch.from_numpy(v.copy()) for k, v in carried.items()}
    M.apply_mamba(pt, cfg_t, torch.as_tensor(x), state=st, cache_index=3,
                  rows=[1])
    for k in ("ssm", "conv"):
        np.testing.assert_array_equal(st[k][0].numpy(), carried[k][0])
        _close(st[k][1], np.asarray(sj[k])[1])
