"""The port's SSM slice on the CPU against the JAX package: the SSD oracle and
chunked scan, the ``ops.ssd_scan`` wrapper (forward and gradients against
``jax.vjp`` of the reference wrapper, whose Pallas kernel runs in interpret
mode), the Mamba2 block and the whole ssm model, and the mixed-dtype mamba
parameters through ``weights`` and ``EntryFlattener``.

Inputs come from numpy with a seed and go through both packages.  Float32
throughout, where the point is the algorithm; each comparison states its
tolerance.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import mamba as JM, registry as JR  # noqa: E402
from repro.models.layers import RngCtx as JRngCtx  # noqa: E402
from repro.models.transformer import softmax_xent as j_xent  # noqa: E402
from repro_torch.core.statespace import (EntryFlattener, flatten_leaves,  # noqa: E402
                                         tree_leaves)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba as M, registry as R  # noqa: E402
from repro_torch.models.layers import RngCtx  # noqa: E402
from repro_torch.models.transformer import softmax_xent  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402

TIER = ops.TOLERANCE_TIERS["ssd_scan"]          # rtol 1e-4, atol 1e-5
FWD = dict(rtol=1e-4, atol=1e-5)      # fp32 block forward, other sum order
GRAD = dict(rtol=1e-4, atol=2e-5)     # as the dense model's grads


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ssd_inputs(b, s, h, p, n, g, seed=0):
    """x, dt (softplus, >= 0), A (< 0), B, C as float32 numpy arrays."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    B = rs.standard_normal((b, s, g, n)).astype(np.float32)
    C = rs.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_reference_vs_jax(with_state):
    x, dt, A, B, C = _ssd_inputs(2, 12, 4, 8, 6, 4, seed=1)
    st = np.random.default_rng(2).standard_normal((2, 4, 8, 6)) \
        .astype(np.float32) if with_state else None
    yj, fj = jref.ssd_reference(*map(jnp.asarray, (x, dt, A, B, C)),
                                initial_state=None if st is None
                                else jnp.asarray(st))
    yt, ft = ref.ssd_reference(*map(torch.from_numpy, (x, dt, A, B, C)),
                               initial_state=None if st is None
                               else torch.from_numpy(st))
    _close(yt, yj, TIER)
    _close(ft, fj, TIER)


@pytest.mark.parametrize("s,chunk,g,with_state", [
    (16, 8, 1, False),       # whole chunks
    (20, 8, 1, False),       # zero-pad path
    (24, 8, 2, False),       # groups broadcast over heads
    (20, 8, 2, True),        # pad path resuming from a state
])
def test_ssd_chunked_vs_jax(s, chunk, g, with_state):
    x, dt, A, B, C = _ssd_inputs(2, s, 4, 8, 6, g, seed=s + g)
    st = np.random.default_rng(3).standard_normal((2, 4, 8, 6)) \
        .astype(np.float32) if with_state else None
    yj, fj = JM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                            initial_state=None if st is None
                            else jnp.asarray(st))
    yt, ft = M.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)),
                           chunk=chunk, initial_state=None if st is None
                           else torch.from_numpy(st))
    assert yt.shape == (2, s, 4, 8) and ft.shape == (2, 4, 8, 6)
    _close(yt, yj, TIER)
    _close(ft, fj, TIER)
    # the chunked scan and the sequential oracle are the same function
    rep = 4 // g
    yo, fo = jref.ssd_reference(
        *map(jnp.asarray, (x, dt, A, np.repeat(B, rep, 2),
                           np.repeat(C, rep, 2))),
        initial_state=None if st is None else jnp.asarray(st))
    _close(yt, yo, TIER)
    _close(ft, fo, TIER)


@pytest.fixture
def one_thread():
    """CPU ``torch.exp`` split across threads has returned results many
    ulps off in some processes; one thread keeps it correctly rounded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ssd_chunked_precision_late_in_a_long_chunk(one_thread):
    """At mamba2's chunk 256 with dt ~ 1 and |A| up to 16, cum reaches
    ~-3e3 late in a chunk.  The reference's float32 chunked scan takes the
    decay exponents as cum_i - cum_j and misses the ssd_scan tier against a
    float64 evaluation; the port sums each segment directly and holds it."""
    x, dt, A, B, C = _ssd_inputs(1, 512, 4, 8, 16, 1, seed=0)
    A = -np.linspace(1.0, 16.0, 4).astype(np.float32)
    y64, _ = M.ssd_chunked(*(torch.from_numpy(a).double()
                             for a in (x, dt, A, B, C)), chunk=256)
    y32, _ = M.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)),
                           chunk=256)
    _close(y32, y64, TIER)
    yj, _ = JM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=256)
    assert not np.allclose(np.asarray(yj), y64.numpy(), **TIER)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_reference_float64_witness(g, one_thread):
    """On float64 operands the oracle keeps a float64 state: it is the
    float64 chunked scan to rounding within one chunk, where that scan
    carries no float32 state (rtol 1e-10, atol 1e-12), and the
    float32 oracle lies within the ``ssd_scan`` tier of it scaled by the sum
    of |terms| (the oracle on |x|, |B|, |C|), the witness gate of the card
    run."""
    x, dt, A, B, C = _ssd_inputs(1, 64, 4, 8, 16, g, seed=g)
    rep = 4 // g
    d = [torch.from_numpy(a).double() for a in
         (x, dt, A, np.repeat(B, rep, 2), np.repeat(C, rep, 2))]
    y64, f64 = ref.ssd_reference(*d)
    assert y64.dtype == f64.dtype == torch.float64
    yc, _ = M.ssd_chunked(*(torch.from_numpy(a).double()
                            for a in (x, dt, A, B, C)), chunk=64)
    torch.testing.assert_close(y64, yc, rtol=1e-10, atol=1e-12)
    terms = ref.ssd_reference(d[0].abs(), d[1], d[2], d[3].abs(),
                              d[4].abs())[0]
    y32 = ref.ssd_reference(*(t.float() for t in d))[0]
    assert y32.dtype == torch.float32
    err = (y32.double() - y64).abs()
    assert bool((err <= TIER["atol"] + TIER["rtol"] * terms).all())


@pytest.mark.parametrize("s,chunk,g", [(16, 8, 1), (16, 16, 2), (12, 32, 2)])
def test_ssd_scan_forward_and_grads_vs_jax(s, chunk, g):
    """Forward against the reference wrapper (Pallas in interpret mode); the
    gradients of x, dt, A, B and C against ``jax.vjp`` of it (its custom
    VJP differentiates the sequential oracle; the port's, the chunked
    scan)."""
    x, dt, A, B, C = _ssd_inputs(2, s, 4, 8, 6, g, seed=chunk + g)
    gy = np.random.default_rng(4).standard_normal((2, s, 4, 8)) \
        .astype(np.float32)
    yj, vjp = jax.vjp(lambda *a: jops.ssd_scan(*a, chunk=chunk)[0],
                      *map(jnp.asarray, (x, dt, A, B, C)))
    gj = vjp(jnp.asarray(gy))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, A, B, C)]
    yt, state = ops.ssd_scan(*ts, chunk=chunk)
    assert state is None and yt.shape == x.shape and yt.dtype == torch.float32
    _close(yt.detach(), yj, TIER)
    gt = torch.autograd.grad(yt, ts, torch.from_numpy(gy))
    for name, a, b in zip("x dt A B C".split(), gt, gj):
        assert a.shape == b.shape, name
        _close(a, b, TIER)


def test_ssd_scan_bf16_within_declared_tier():
    x, dt, A, B, C = _ssd_inputs(1, 16, 4, 8, 6, 1, seed=5)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, B, C)]
    yt, _ = ops.ssd_scan(bf[0], torch.from_numpy(dt), torch.from_numpy(A),
                         bf[1], bf[2], chunk=8)
    assert yt.dtype == torch.bfloat16
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, B, C)]
    yj, _ = jops.ssd_scan(jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1],
                          jb[2], chunk=8)
    _close(yt.float(), yj, ops.TOLERANCE_TIERS["ssd_scan_bf16"])


def test_ssd_scan_value_errors():
    x, dt, A, B, C = map(torch.from_numpy, _ssd_inputs(1, 16, 4, 8, 6, 1))
    with pytest.raises(ValueError, match="initial_state"):
        ops.ssd_scan(x, dt, A, B, C, chunk=8,
                     initial_state=torch.zeros(1, 4, 8, 6))
    B3, C3 = (torch.zeros(1, 16, 3, 6) for _ in range(2))
    with pytest.raises(ValueError, match="h=4.*g=3"):
        ops.ssd_scan(x, dt, A, B3, C3, chunk=8)
    with pytest.raises(ValueError, match="s=16.*chunk=6"):
        ops.ssd_scan(x, dt, A, B, C, chunk=6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_vs_jax(with_state):
    rs = np.random.default_rng(6)
    x = rs.standard_normal((2, 9, 5)).astype(np.float32)
    w = rs.standard_normal((4, 5)).astype(np.float32)
    st = rs.standard_normal((2, 3, 5)).astype(np.float32) if with_state \
        else None
    oj, nj = JM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    ot, nt = M._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            None if st is None else torch.from_numpy(st))
    _close(ot, oj, FWD)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def _ssm(split, num_layers=2, dtype="float32"):
    cfg_j = JR.tiny_config("ssm", mamba_split_proj=split,
                           num_layers=num_layers, dtype=dtype)
    cfg_t = R.tiny_config("ssm", mamba_split_proj=split,
                          num_layers=num_layers, dtype=dtype)
    ks = jax.random.split(jax.random.key(11), num_layers + 2)
    stem = JR.init_stem(ks[0], cfg_j)
    layers = [JR.init_layer(ks[1 + i], cfg_j, i) for i in range(num_layers)]
    head = JR.init_head(ks[-1], cfg_j)
    ported = params_from_numpy(_np(stem), _np(layers), _np(head), "cpu")
    return cfg_j, cfg_t, (stem, layers, head), ported


@pytest.mark.parametrize("split", [False, True])
def test_apply_mamba_forward_and_grads_vs_jax(split):
    cfg_j, cfg_t, (_, layers, _), (_, tlayers, _) = _ssm(split, 1)
    rs = np.random.default_rng(7)
    x = rs.standard_normal((2, 16, cfg_j.d_model)).astype(np.float32)
    gy = rs.standard_normal((2, 16, cfg_j.d_model)).astype(np.float32)
    pj = layers[0]["mamba"]
    yj, vjp = jax.vjp(lambda p, a: JM.apply_mamba(p, cfg_j, a)[0], pj,
                      jnp.asarray(x))
    gpj, gxj = vjp(jnp.asarray(gy))
    pt = tlayers[0]["mamba"]
    leaves = tree_leaves(pt)
    tx = torch.from_numpy(x).requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    yt, new_state = M.apply_mamba(pt, cfg_t, tx)
    assert new_state is None
    _close(yt.detach(), yj, FWD)
    grads = torch.autograd.grad(yt, leaves + [tx], torch.from_numpy(gy))
    _close(grads[-1], gxj, GRAD)
    # per-leaf grads, in ravel_pytree order
    _close(flatten_leaves(grads[:-1]), ravel_pytree(gpj)[0], GRAD)


def _loss(cfg, stem, layers, head, toks, *, torch_side):
    if torch_side:
        x = R.apply_stem(stem, cfg, toks)
        for lid in range(cfg.num_layers):
            x, aux = R.apply_layer(layers[lid], cfg, lid, x, None, RngCtx())
            assert float(aux) == 0.0
        return softmax_xent(R.apply_head(head, cfg, x)[:, :-1], toks[:, 1:])
    x = JR.apply_stem(stem, cfg, toks)
    B, S, _ = x.shape
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    for lid in range(cfg.num_layers):
        x, _ = JR.apply_layer(layers[lid], cfg, lid, x, pos, JRngCtx())
    return j_xent(JR.apply_head(head, cfg, x)[:, :-1], toks[:, 1:])


@pytest.mark.parametrize("split", [False, True])
def test_ssm_model_loss_and_grads_vs_jax(split):
    """Mixer-only mamba blocks (ln1, no MLP) through the per-layer API."""
    cfg_j, cfg_t, jparams, tparams = _ssm(split)
    assert sorted(tparams[1][0]) == ["ln1", "mamba"]
    toks = np.random.default_rng(8).integers(
        0, cfg_j.vocab_size, (2, 16)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda *p: _loss(cfg_j, *p, jnp.asarray(toks), torch_side=False),
        argnums=(0, 1, 2))(*jparams)
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = _loss(cfg_t, *tparams, torch.from_numpy(toks), torch_side=True)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _close(flatten_leaves(grads), ravel_pytree(jgrads)[0], GRAD)


def test_mamba_params_round_trip_and_flatten_exactly():
    """A bf16 mamba layer mixes bf16 leaves with float32 A_log, D, dt_bias
    and norm scales: both directions of ``weights`` are exact, and the
    flattener orders and casts them as ``ravel_pytree`` does."""
    _, cfg_t, (stem, layers, head), (tstem, tlayers, thead) = _ssm(
        False, dtype="bfloat16")
    dtypes = {k: v.dtype for k, v in tlayers[0]["mamba"].items()
              if k != "out_norm"}
    assert dtypes["in_proj"] == torch.bfloat16
    assert dtypes["A_log"] == dtypes["D"] == dtypes["dt_bias"] \
        == torch.float32
    back = params_to_numpy(tstem, tlayers, thead)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves((stem, layers,
                                                              head))):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    # numpy has no bf16: bf16 leaves come back as float32 holding bf16
    # values, and cast to bf16 without rounding
    again = params_from_numpy(*back, device="cpu")
    for a, b in zip(tree_leaves(again), tree_leaves((tstem, tlayers,
                                                      thead))):
        assert torch.equal(a.to(b.dtype), b) and torch.equal(a, b.float())
    fl = EntryFlattener()
    np.testing.assert_array_equal(fl.flatten_entry(0, tlayers[0]).numpy(),
                                  np.asarray(ravel_pytree(layers[0])[0]))
    vec = np.random.default_rng(9).standard_normal(
        ravel_pytree(layers[0])[0].size).astype(np.float32)
    fl.write_entry(0, torch.from_numpy(vec))
    want = ravel_pytree(layers[0])[1](jnp.asarray(vec))
    for a, b in zip(tree_leaves(tlayers[0]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_mamba_serving_functions_raise():
    """The serving functions run (held to the reference in
    test_torch_serving_models.py), a prefill resumed from a carried state
    too (here the zero state: the fresh prefill's output and states); what
    the port still leaves out raises: a scan through ``ops.ssd_scan`` from
    a given initial state."""
    cfg = R.tiny_config("ssm")
    st = M.init_mamba_state(cfg, 2)
    assert st["ssm"].shape == (2, cfg.ssm_heads, cfg.ssm_headdim,
                               cfg.ssm_state) and not st["ssm"].any()
    assert st["conv"].shape == (2, cfg.conv_kernel - 1,
                                cfg.d_inner + 2 * cfg.ssm_state)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    y, new = M.ssd_decode_step(torch.ones(2, 1, h, p), torch.ones(2, 1, h),
                               -torch.ones(h), torch.ones(2, 1, 1, n),
                               torch.ones(2, 1, 1, n), st["ssm"])
    assert y.shape == (2, 1, h, p) and torch.all(new == 1.0)
    params = M.init_mamba(torch.Generator().manual_seed(0), cfg)
    xin = torch.randn(2, 8, cfg.d_model,
                      generator=torch.Generator().manual_seed(1))
    fresh = M.init_mamba_state(cfg, 2)
    y0, _ = M.apply_mamba(params, cfg, xin, state=fresh, cache_index=0)
    y1, out = M.apply_mamba(params, cfg, xin, state=st,
                            cache_index=torch.tensor([4, 4]))
    assert out is st
    _close(y1, y0, FWD)
    _close(st["ssm"], fresh["ssm"], FWD)
    _close(st["conv"], fresh["conv"], FWD)
    x = torch.zeros(1, 8, h, p)
    with pytest.raises(ValueError, match="initial_state"):
        ops.ssd_scan(x, torch.ones(1, 8, h), -torch.ones(h),
                     torch.zeros(1, 8, 1, n), torch.zeros(1, 8, 1, n),
                     chunk=8, initial_state=torch.zeros(1, h, p, n))
