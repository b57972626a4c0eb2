"""A Mamba2 prefill resumed from a carried state, through the whole model.

``transformer.forward(..., caches, cache_index=k)`` with S > 1 on the tiny
ssm config, against the reference's ``transformer.forward`` from the same
stacked weights (``weights.params_from_stacked``) and the same caches: a
prompt prefilled as two parts, the second resumed at ``cache_index`` k
(the port's plain chunked scan from ``initial_state``, as the reference's
route), logits and both states after each part.  And the port against
itself: the two parts give the whole prefill's logits and states.

Token ids come from numpy with a seed.  Float32; tolerance ``FWD`` (rtol
1e-4, atol 1e-5, the ``ssd_scan`` tier of ``kernels/ops.py``): the whole
prefill runs the SSD kernel's plain version, the resumed one the chunked
form, in other sum orders.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import registry as JR, transformer as JT  # noqa: E402
from repro_torch.models import registry as R, transformer as T  # noqa: E402
from repro_torch.weights import params_from_stacked  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

FWD = dict(rtol=1e-4, atol=1e-5)
MAX_LEN = 24
SSM = dict(num_layers=2, vocab_size=128, dropout_rate=0.0)
PROMPT = 13


def _close(got: torch.Tensor, want, tol=FWD):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


@pytest.fixture(scope="module")
def twins():
    cfg_j = JR.tiny_config("ssm", **SSM)
    cfg_t = R.tiny_config("ssm", **SSM)
    params_j = JT.init_params(jax.random.key(3), cfg_j)
    params_t = params_from_stacked(cfg_t, params_j, "cpu")
    tokens = np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, size=(2, PROMPT)).astype(np.int32)
    return cfg_j, cfg_t, params_j, params_t, tokens


def _layer_states(caches_j, layer):
    return jax.tree.map(lambda a: np.asarray(a[layer]), caches_j[0][0])


# k = 5 leaves a ragged second part (8 rows at chunk 8: one chunk; the
# first part a 5-row chunk); k = 3 a 10-row second part, padded to 16
@pytest.mark.parametrize("k", [3, 5])
def test_forward_resumed_prefill_matches_reference(twins, k):
    cfg_j, cfg_t, params_j, params_t, tokens = twins
    cj = JT.init_caches(cfg_j, 2, MAX_LEN)
    ct = T.init_caches(cfg_t, 2, MAX_LEN)
    for lo, hi in ((0, k), (k, PROMPT)):
        part = tokens[:, lo:hi]
        lj, cj, _ = JT.forward(params_j, cfg_j, jnp.asarray(part), caches=cj,
                               cache_index=lo)
        lt, ct, _ = T.forward(params_t, cfg_t, torch.as_tensor(part),
                              caches=ct, cache_index=lo)
        assert lt.shape == (2, hi - lo, cfg_t.vocab_size)
        _close(lt, lj)
        for layer, c in enumerate(ct):
            want = _layer_states(cj, layer)
            assert set(c) == set(want) == {"ssm", "conv"}
            for key in c:
                _close(c[key], want[key])


@pytest.mark.parametrize("k", [3, 5, 8])
def test_resumed_prefill_gives_the_whole_prefill(twins, k):
    _, cfg_t, _, params_t, tokens = twins
    whole = T.init_caches(cfg_t, 2, MAX_LEN)
    lw, whole, _ = T.forward(params_t, cfg_t, torch.as_tensor(tokens),
                             caches=whole, cache_index=0)
    split = T.init_caches(cfg_t, 2, MAX_LEN)
    l0, split, _ = T.forward(params_t, cfg_t, torch.as_tensor(tokens[:, :k]),
                             caches=split, cache_index=0)
    l1, split, _ = T.forward(params_t, cfg_t, torch.as_tensor(tokens[:, k:]),
                             caches=split, cache_index=k)
    _close(torch.cat([l0, l1], dim=1), lw.numpy())
    for a, b in zip(split, whole):
        for key in ("ssm", "conv"):
            _close(a[key], b[key].numpy())
