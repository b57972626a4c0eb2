"""The port's content-addressed threefry RNG and dropout against ``jax.random``
and the JAX package's ``dropout``, bit for bit, on the CPU.

Keys (``key_from_seed``, ``fold_in``, ``stream_key``) are compared with
``jax.random.key_data``; the plain masks (``ref.bernoulli_keep``) with
``jax.random.bernoulli`` over 240 (key, shape, rate) tuples; ``dropout``'s
output and gradient with ``jax.jit`` of ``repro.models.layers.dropout`` and
of its ``jax.grad``, as integers (no tolerance).  The dropout kernel's
dispatch is tested with its launch recorded: a CUDA tensor launches
``threefry_dropout`` with the op's key and the sample ids, or raises.
"""
import importlib.util
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.planners import rng as j_rng  # noqa: E402
from repro.models.layers import RngCtx as JRngCtx  # noqa: E402
from repro.models.layers import dropout as j_dropout  # noqa: E402
from repro_torch.core.planners import rng  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import threefry as tf  # noqa: E402
from repro_torch.models.layers import RngCtx, dropout  # noqa: E402

# (key, counter, output) of threefry2x32 with 20 rounds (Salmon et al.'s
# Random123 known-answer vectors, as jax's own tests use them)
KNOWN_ANSWERS = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


def _bits(a: np.ndarray) -> np.ndarray:
    """A float array's bit patterns (bf16 via its float32 widening)."""
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize("key,count,want", KNOWN_ANSWERS)
def test_threefry2x32_known_answers(key, count, want):
    y0, y1 = tf.threefry2x32(key, np.array([count[0]], np.uint32),
                             np.array([count[1]], np.uint32))
    assert (int(y0[0]), int(y1[0])) == want
    t = [torch.tensor([v], dtype=torch.int64) for v in (*key, *count)]
    z0, z1 = ref.threefry2x32_reference(*t)
    assert (int(z0), int(z1)) == want


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, 2 ** 31,
                                  2 ** 32 - 1, 2 ** 32 + 5, 2 ** 40 + 3, -1,
                                  -5])
def test_key_from_seed_matches_jax(seed):
    np.testing.assert_array_equal(tf.key_from_seed(seed),
                                  _kd(jax.random.key(seed)))


# (seed, step, layer, op, sample id)
STREAMS = [(0, 0, 0, 0, 0), (0, 1, 2, 1, 7), (1, 3, 0, 1, 12),
           (42, 7, 31, 0, 100003), (7, 2 ** 20, 5, 1, 2 ** 31 - 1),
           (2 ** 31 - 1, 9, 63, 0, 300007), (12345, 100, 1, 1, 65536),
           (3, 4294967295, 2, 0, 1)]


@pytest.mark.parametrize("seed,step,layer,op,sid", STREAMS)
def test_fold_in_chain_and_stream_key_match_jax(seed, step, layer, op, sid):
    base = tf.key_from_seed(seed)
    jk = jax.random.fold_in(jax.random.key(seed), np.uint32(step))
    k = tf.fold_in(base, step)
    np.testing.assert_array_equal(k, _kd(jk))
    for d in (layer, op, np.int32(sid)):
        jk = jax.random.fold_in(jk, d)
        k = tf.fold_in(k, int(d))
        np.testing.assert_array_equal(k, _kd(jk))
    np.testing.assert_array_equal(
        rng.stream_key(base, step, layer, sid),
        _kd(j_rng.stream_key(jax.random.key(seed), np.uint32(step), layer,
                             np.int32(sid))))


SHAPES = [(16, 64), (7, 9, 3), (1,), (131,)]      # odd numels among them
KEYS_PER_CASE = 20


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_bernoulli_masks_match_jax(rate, shape):
    """20 keys a case, 12 cases: 240 (key, shape, rate) tuples."""
    base = jax.random.fold_in(jax.random.key(len(shape)), int(rate * 10))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.arange(KEYS_PER_CASE, dtype=jnp.int32))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bernoulli(k, 1.0 - rate, shape))(jkeys))
    keys = torch.from_numpy(_kd(jkeys).astype(np.int64))
    p, _ = tf.dropout_scalars(rate, torch.float32)
    got = ref.bernoulli_keep(keys, shape, p).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ref.random_bits(keys, shape).numpy().astype(np.uint32),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(jkeys)))


def test_counter_hi_word_past_two_to_the_32():
    """Indices >= 2**32 put their high word in the counter's first word."""
    key = tf.fold_in(tf.key_from_seed(5), 3)
    idx = np.arange(2 ** 32 - 3, 2 ** 32 + 3, dtype=np.int64)
    y0, y1 = tf.threefry2x32(key, (idx >> 32).astype(np.uint32),
                             (idx & tf.MASK).astype(np.uint32))
    keys = torch.tensor([[int(key[0]), int(key[1])]], dtype=torch.int64)
    got = ref.threefry_bits(keys, torch.from_numpy(idx))[0].numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), y0 ^ y1)
    assert (idx >> 32).tolist() == [0, 0, 0, 1, 1, 1]


@pytest.mark.parametrize("rate,dtype,want", [
    (0.1, torch.float32, (np.float32(0.9), np.float32(1) / np.float32(0.9))),
    (0.1, torch.bfloat16, (np.float32(0.9),
                           np.float32(1) / np.float32(0.8984375))),
    (0.5, torch.bfloat16, (np.float32(0.5), np.float32(2.0)))])
def test_dropout_scalars(rate, dtype, want):
    assert tf.dropout_scalars(rate, dtype) == tuple(float(w) for w in want)


def _ref_dropout(shape, dtype, rate, op_id, seed=0):
    """Inputs, jitted reference output and gradient, and the step key."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal(shape).astype(np.float32)
    w = rs.standard_normal(shape).astype(np.float32)
    sids = rs.integers(0, 2 ** 31 - 1, size=shape[0]).astype(np.int32)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    step_key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 3),
                                  1)

    def f(x, k, s):
        return j_dropout(x, rate, JRngCtx(step_key=k, sample_ids=s,
                                          deterministic=False), op_id=op_id)
    y = jax.jit(f)(jx, step_key, jnp.asarray(sids))
    g = jax.jit(jax.grad(lambda x, k, s: jnp.sum(f(x, k, s) * jw)))(
        jx, step_key, jnp.asarray(sids))
    return (x, w, sids, _kd(step_key), np.asarray(y.astype(jnp.float32)),
            np.asarray(g.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(2, 16, 64), (3, 7, 33), (1, 5)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_and_gradient_bitwise_vs_jitted_reference(dtype, rate, shape):
    op_id = 1
    x, w, sids, key, y_ref, g_ref = _ref_dropout(shape, dtype, rate, op_id)
    td = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    ctx = RngCtx(step_key=key, sample_ids=torch.from_numpy(sids),
                 deterministic=False)
    y = dropout(tx, rate, ctx, op_id=op_id)
    y.backward(torch.from_numpy(w).to(td))
    np.testing.assert_array_equal(_bits(y.detach().float().numpy()),
                                  _bits(y_ref))
    np.testing.assert_array_equal(_bits(tx.grad.float().numpy()),
                                  _bits(g_ref))
    # the mask is the plain bernoulli of each sample's folded key
    p, r = tf.dropout_scalars(rate, td)
    keep = ref.bernoulli_keep(
        ref.sample_keys(tf.fold_in(key, op_id), torch.from_numpy(sids)),
        shape[1:], p)
    assert torch.equal(y.detach() != 0, keep)


def test_true_division_is_not_the_reference_scale():
    """torch's ``x / (1 - rate)`` rounds differently from the jitted
    reference's reciprocal product, in float32 and bf16: the port must not
    use it."""
    x, _, sids, key, y_ref, _ = _ref_dropout((1, 64, 64), "float32", 0.1, 0)
    keep = y_ref != 0
    div = np.where(keep, (torch.from_numpy(x) / 0.9).numpy(), 0.0)
    assert (_bits(div) != _bits(y_ref)).sum() > 0
    xb, _, _, _, yb_ref, _ = _ref_dropout((1, 64, 64), "bfloat16", 0.1, 0)
    tb = torch.from_numpy(xb).to(torch.bfloat16)
    divb = np.where(yb_ref != 0, (tb / 0.9).float().numpy(), 0.0)
    assert (_bits(divb) != _bits(yb_ref)).sum() > 0


def test_rng_ctx_folds_layers_as_the_reference():
    base = tf.key_from_seed(9)
    jk = jax.random.fold_in(jax.random.key(9), np.uint32(4))
    ctx = RngCtx(step_key=tf.fold_in(base, 4), deterministic=False)
    jctx = JRngCtx(step_key=jk, deterministic=False)
    np.testing.assert_array_equal(ctx.layer(3).step_key,
                                  _kd(jctx.layer(3).step_key))
    det = RngCtx(step_key=base)
    assert det.layer(3) is det
    x = torch.ones(2, 4)
    assert dropout(x, 0.1, det) is x
    assert dropout(x, 0.0, ctx.layer(3)) is x


def test_verify_equivalence_and_rank_dependent_fold(monkeypatch):
    base = tf.key_from_seed(0)
    assert rng.verify_equivalence(base, 5, range(4), [0, 1, 100003])
    # a copy of the module whose stream key folds in the calling rank (a
    # counter that moves on every call): the check must fail
    spec = importlib.util.spec_from_file_location("rng_copy", rng.__file__)
    bad = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "rng_copy", bad)   # for its dataclass
    spec.loader.exec_module(bad)
    rank = iter(range(10 ** 6))

    def rank_dependent(base_key, step, layer_id, sample_id):
        return tf.fold_in(rng.stream_key(base_key, step, layer_id,
                                         sample_id), next(rank))
    bad.stream_key = rank_dependent
    assert not bad.verify_equivalence(base, 5, range(4), [0, 1, 100003])
    assert rng.verify_equivalence(base, 5, range(4), [0, 1, 100003])


# ---------------------------------------------------------------------------
# dispatch: a CUDA tensor launches the kernel or raises
# ---------------------------------------------------------------------------
ENTRY = "repro_threefry_dropout"


@pytest.fixture
def recorded_launches(monkeypatch):
    """Every tensor counts as a CUDA tensor; launch nothing, record
    (counter, entry, args) of each launch; the plain version fails if
    reached."""
    calls = []
    monkeypatch.setattr(ops, "on_card", lambda t: True)
    monkeypatch.setattr(tf, "_require_card", lambda *ts: None)
    monkeypatch.setattr(tf, "_stream", lambda t: 0)

    def plain(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")
    monkeypatch.setattr(ref, "dropout_reference", plain)
    monkeypatch.setattr(_build, "launch", lambda kernel, entry, *args:
                        calls.append((kernel, entry, args)))
    return calls


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_forward_and_backward_launch_the_kernel(recorded_launches, dtype,
                                                code):
    x = torch.zeros(3, 5, 7, dtype=dtype, requires_grad=True)
    sids = torch.tensor([4, 9, 2 ** 31 - 1], dtype=torch.int32)
    key = tf.fold_in(tf.key_from_seed(1), 2)
    ctx = RngCtx(step_key=key, sample_ids=sids, deterministic=False)
    y = dropout(x, 0.1, ctx, op_id=1)
    y.backward(torch.ones_like(y))
    (k1, e1, fwd), (k2, e2, bwd) = recorded_launches
    assert (k1, e1) == (k2, e2) == ("threefry_dropout", ENTRY)
    assert len(fwd) == len(bwd) == len(_build.SIGNATURES[ENTRY])
    op_key = tf.fold_in(key, 1)
    p, r = tf.dropout_scalars(0.1, dtype)
    for args in (fwd, bwd):
        assert args[2] == sids.data_ptr()
        assert args[3:] == (3, 35, int(op_key[0]), int(op_key[1]), p, r,
                            code, 0)
    assert fwd[0] == x.data_ptr()


def test_kernel_requires_card_and_int32_ids():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.threefry_dropout_cuda(x, (1, 2), torch.zeros(2, dtype=torch.int32),
                                 0.9, 1.0)


def test_failed_launch_raises_and_counts_nothing(monkeypatch):
    monkeypatch.setattr(tf, "_require_card", lambda *ts: None)
    monkeypatch.setattr(tf, "_stream", lambda t: 0)
    called = []

    class Library:
        def __getattr__(self, entry):
            return lambda *args: called.append(entry) or 700  # illegal addr

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    with pytest.raises(RuntimeError, match=ENTRY):
        tf.threefry_dropout_cuda(torch.zeros(2, 8), (1, 2),
                                 torch.zeros(2, dtype=torch.int32), 0.9, 1.0)
    with pytest.raises(ValueError, match="int32"):
        tf.threefry_dropout_cuda(torch.zeros(2, 8), (1, 2),
                                 torch.zeros(2, dtype=torch.int64), 0.9, 1.0)
    assert called == [ENTRY]
    assert set(_build.LAUNCHES.values()) == {0}
