"""The port's serving model paths on the CPU against the JAX package: the
cached attention branch, the whole-model prefill and decode with caches
(dense MHA and GQA, ssm), ``params_from_stacked``, and the serving hooks'
limits.  The Mamba2 state branches alone: test_torch_serving_mamba.py.

Both packages start from the reference's stacked ``init_params`` tree
(``weights.params_from_stacked``); token ids and SSD inputs come from numpy
with a seed.  Float32 throughout.  Tolerances: logits, caches and states
``FWD`` (rtol 1e-4, atol 1e-5, the ``ssd_scan`` and ``flash_attention``
tiers of ``kernels/ops.py``): the port's prefill attention is the flash
kernel's plain version over the prompt where the reference masks the whole
cache, and the port's prefill scan is the sequential oracle where the
reference runs the chunked form, so the sums run in other orders.  In
bf16: the cached attention's output bitwise (q·k rounded to bf16 as the
reference rounds it), and the whole model's logits per row within ``BF16``:
the bf16 tier's rtol (1e-2, ``flash_attention_bf16``) for each of the
2L + 1 roundings of the residual stream, adding as a random walk, times the
row's max |logit|.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.weights import params_from_stacked  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

FWD = dict(rtol=1e-4, atol=1e-5)
MAX_LEN = 24
BF16_LAYERS = 2
BF16 = dict(rtol=1e-2 * np.sqrt(2 * BF16_LAYERS + 1), atol=1e-4)

FAMILIES = {
    "dense-gqa": ("dense", dict(num_layers=2, d_model=32, num_heads=4,
                                num_kv_heads=2, d_ff=64, vocab_size=128)),
    "dense-mha": ("dense", dict(num_layers=2, d_model=32, num_heads=2,
                                num_kv_heads=2, d_ff=64, vocab_size=128)),
    "ssm": ("ssm", dict(num_layers=2, vocab_size=128)),
}


def _np(t):
    return np.asarray(t)


def _close(got: torch.Tensor, want, tol=FWD):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def twins(request):
    family, kw = FAMILIES[request.param]
    cfg_j = JR.tiny_config(family, dropout_rate=0.0, **kw)
    cfg_t = R.tiny_config(family, dropout_rate=0.0, **kw)
    params_j = JT.init_params(jax.random.key(0), cfg_j)
    params_t = params_from_stacked(cfg_t, params_j, "cpu")
    return request.param, cfg_j, cfg_t, params_j, params_t


def _layer_cache(caches_j, cfg, layer):
    """Layer ``layer``'s cache of the reference's stacked caches (one
    segment: a leading repeats axis)."""
    assert len(cfg.block_pattern()) == 1 and len(cfg.block_pattern()[0][0]) == 1
    return jax.tree.map(lambda a: _np(a[layer]), caches_j[0][0])


def _check_caches(caches_t, caches_j, cfg):
    for layer, c in enumerate(caches_t):
        want = _layer_cache(caches_j, cfg, layer)
        assert set(c) == set(want)
        for k in c:
            _close(c[k], want[k])


def test_params_from_stacked_layout(twins):
    name, cfg_j, cfg_t, params_j, (stem, layers, head) = twins
    assert len(layers) == cfg_t.num_layers
    for i, layer in enumerate(layers):
        want = jax.tree.map(lambda a: _np(a[i]), params_j["segments"][0][0])
        got = jax.tree.map(lambda t: t.numpy(), layer)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(stem["embed"]["embedding"].numpy(),
                                  _np(params_j["embed"]["embedding"]))
    if cfg_t.tie_embeddings:
        assert head["head"]["w"].data_ptr() == \
            stem["embed"]["embedding"].data_ptr()
    else:
        np.testing.assert_array_equal(head["head"]["w"].numpy(),
                                      _np(params_j["head"]["w"]))


def test_prefill_logits_and_caches(twins):
    _, cfg_j, cfg_t, params_j, params_t = twins
    tokens = np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, size=(2, 11)).astype(np.int32)
    lj, cj = JT.prefill(params_j, cfg_j, jnp.asarray(tokens),
                        JT.init_caches(cfg_j, 2, MAX_LEN))
    lt, ct = T.prefill(params_t, cfg_t, torch.as_tensor(tokens),
                       T.init_caches(cfg_t, 2, MAX_LEN))
    assert lt.shape == (2, 1, cfg_t.vocab_size)
    _close(lt, lj)
    _check_caches(ct, cj, cfg_t)


def test_decode_steps_at_per_row_positions(twins):
    """Two rows prefilled to different lengths, then three batched decode
    steps at their own positions: logits and caches after each step."""
    _, cfg_j, cfg_t, params_j, params_t = twins
    rng = np.random.default_rng(2)
    lens = (5, 9)
    cj_rows, ct_rows = [], []
    for n in lens:
        tok = rng.integers(0, cfg_t.vocab_size, size=(1, n)).astype(np.int32)
        cj_rows.append(JT.prefill(params_j, cfg_j, jnp.asarray(tok),
                                  JT.init_caches(cfg_j, 1, MAX_LEN))[1])
        ct_rows.append(T.prefill(params_t, cfg_t, torch.as_tensor(tok),
                                 T.init_caches(cfg_t, 1, MAX_LEN))[1])
    cj = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=1), *cj_rows)
    ct = [{k: torch.cat([a[k], b[k]]) for k in a} for a, b in zip(*ct_rows)]
    pos = np.array(lens)
    for _ in range(3):
        tok = rng.integers(0, cfg_t.vocab_size, size=(2, 1)).astype(np.int32)
        lj, cj = JT.decode_step(params_j, cfg_j, jnp.asarray(tok), cj,
                                jnp.asarray(pos, jnp.int32))
        lt, ct = T.decode_step(params_t, cfg_t, torch.as_tensor(tok), ct,
                               torch.as_tensor(pos))
        _close(lt, lj)
        _check_caches(ct, cj, cfg_t)
        pos = pos + 1


def test_decode_rows_write_only_their_caches(twins):
    """``rows`` keeps the other rows' caches as they were and gives the
    decoded row the logits of a full-batch step."""
    _, _, cfg_t, _, params_t = twins
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg_t.vocab_size, size=(2, 7)).astype(np.int32)
    _, caches = T.prefill(params_t, cfg_t, torch.as_tensor(tok),
                          T.init_caches(cfg_t, 2, MAX_LEN))
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    step = torch.as_tensor(rng.integers(0, cfg_t.vocab_size, size=(2, 1)))
    pos = torch.tensor([7, 7])
    full, _ = T.decode_step(params_t, cfg_t, step,
                            [{k: v.clone() for k, v in c.items()}
                             for c in before], pos)
    part, caches = T.decode_step(params_t, cfg_t, step, caches, pos,
                                 rows=torch.tensor([1]))
    torch.testing.assert_close(part[1], full[1], rtol=0, atol=0)
    for c, b in zip(caches, before):
        for k in c:
            torch.testing.assert_close(c[k][0], b[k][0], rtol=0, atol=0)
            assert not torch.equal(c[k][1], b[k][1])


@pytest.mark.parametrize("scale", [1.0, 4.0, 8.0])
def test_bf16_cached_attention_rounds_like_the_reference(scale):
    """bf16 q, k, v over a cache at three per-row offsets: the port's
    cached branch equals the reference's bit for bit (q·k rounded once to
    bf16, then the float32 softmax).  ``scale`` sets |q·k|, so that a
    float32 q·k would land a bf16 ulp or more away."""
    rng = np.random.default_rng(4)
    B, H, Hkv, hd, T_ = 3, 4, 2, 32, 40
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32) * scale
    k = rng.standard_normal((B, T_, Hkv, hd)).astype(np.float32) * scale
    v = rng.standard_normal((B, T_, Hkv, hd)).astype(np.float32)
    off = np.array([5, 17, 39])
    want = JL._sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    True, q_offset=jnp.asarray(off, jnp.int32))
    got = L._sdpa(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)),
                  True, q_offset=torch.as_tensor(off))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_bf16_prefill_and_decode_logits():
    """Tiny dense GQA in bf16 from the same stacked weights: the prefill
    and four batched decode steps' logits within ``BF16`` of each row's
    max |logit|."""
    kw = dict(num_layers=BF16_LAYERS, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, vocab_size=128, dtype="bfloat16")
    cfg_j = JR.tiny_config("dense", dropout_rate=0.0, **kw)
    cfg_t = R.tiny_config("dense", dropout_rate=0.0, **kw)
    params_j = JT.init_params(jax.random.key(0), cfg_j)
    params_t = params_from_stacked(cfg_t, params_j, "cpu")
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg_t.vocab_size, size=(2, 9)).astype(np.int32)
    lj, cj = JT.prefill(params_j, cfg_j, jnp.asarray(tok),
                        JT.init_caches(cfg_j, 2, MAX_LEN))
    lt, ct = T.prefill(params_t, cfg_t, torch.as_tensor(tok),
                       T.init_caches(cfg_t, 2, MAX_LEN))
    pos = np.array([9, 9])
    for step in range(5):
        got = lt.float().numpy().reshape(2, -1)
        want = np.asarray(lj.astype(jnp.float32)).reshape(2, -1)
        for row in range(2):
            err = np.abs(got[row] - want[row]).max()
            bound = BF16["rtol"] * np.abs(want[row]).max() + BF16["atol"]
            assert err <= bound, (step, row, err, bound)
        tok = rng.integers(0, cfg_t.vocab_size, size=(2, 1)).astype(np.int32)
        lj, cj = JT.decode_step(params_j, cfg_j, jnp.asarray(tok), cj,
                                jnp.asarray(pos, jnp.int32))
        lt, ct = T.decode_step(params_t, cfg_t, torch.as_tensor(tok), ct,
                               torch.as_tensor(pos))
        pos = pos + 1


# the moe and hybrid families serve since the MoE slice: their cases build
# the hooks and run a tiny engine beside the reference's (MLA serves since
# the MLA slice: tests/test_torch_mla_model.py::test_engine_twin_vs_reference)
MOE_SERVE = {"moe": dict(num_layers=2, d_model=32, num_heads=2,
                         num_kv_heads=1, d_ff=64, moe_d_ff=32,
                         vocab_size=128),
             "hybrid": dict(vocab_size=128)}


@pytest.mark.parametrize("family,kw,match", [
    ("moe", {}, "MoE"),
    ("hybrid", {}, "MoE"),
    ("audio", {}, "enc-dec"),
    ("vlm", {}, "prefix embeddings"),
])
def test_serving_hooks_raise_for_unported_families(family, kw, match):
    if family in MOE_SERVE:
        _moe_engine_twin(family)
        return
    with pytest.raises(NotImplementedError, match=match):
        R.serving_hooks(R.tiny_config(family, **kw), "cpu")


def _moe_engine_twin(family):
    """Greedy streams and summaries of a tiny MoE engine (1 replica x 4
    slots, 3 requests) equal the reference's from the same weights; at the
    default capacity factor a decode step of 3 live slots has 2 places an
    expert (E 4, top-2; 3 at all 4 slots), so routing only the live rows
    matters."""
    from repro import serving as JS
    from repro_torch import serving as S
    kw = dict(MOE_SERVE[family], dropout_rate=0.0)
    cfg_j, cfg_t = JR.tiny_config(family, **kw), R.tiny_config(family, **kw)
    R.serving_hooks(cfg_t, "cpu")
    pj = JT.init_params(jax.random.key(0), cfg_j)
    pt = params_from_stacked(cfg_t, pj, "cpu")
    engines = []
    for mod, params, cfg, extra in ((JS, pj, cfg_j, {}),
                                    (S, pt, cfg_t, {"device": "cpu"})):
        eng = mod.ServingEngine(cfg, n_replicas=1, slots_per_replica=4,
                                max_len=16, mode="numeric", seed=0,
                                params=params, **extra)
        rng = np.random.default_rng(0)
        for rid in range(3):
            eng.submit(mod.Request(rid=rid, arrival=0.0, max_new_tokens=4,
                                   prompt=rng.integers(0, 128, size=6)
                                   .astype(np.int32)))
        eng.drain()
        engines.append(eng)
    ref, eng = engines
    assert [eng.requests[r].generated for r in range(3)] == \
        [ref.requests[r].generated for r in range(3)]
    assert all(len(eng.requests[r].generated) == 4 for r in range(3))
    assert eng.summary() == ref.summary()


def test_chunked_attention_still_raises():
    """No longer raises (the name is kept from before the chunked path was
    ported): the serving hooks on the chunked attention path (chunks of 4
    and 8 over an 11-token prompt): the prefill's logits and caches, then
    three batched decode steps at per-row positions, against the
    reference's chunked model from the same weights."""
    kw = dict(FAMILIES["dense-gqa"][1], dropout_rate=0.0, attn_chunked=True,
              attn_chunk_q=4, attn_chunk_kv=8)
    cfg_j, cfg_t = JR.tiny_config("dense", **kw), R.tiny_config("dense", **kw)
    params_j = JT.init_params(jax.random.key(0), cfg_j)
    params_t = params_from_stacked(cfg_t, params_j, "cpu")
    hooks = R.serving_hooks(cfg_t, "cpu")
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg_t.vocab_size, size=(2, 11)).astype(np.int32)
    lj, cj = JT.prefill(params_j, cfg_j, jnp.asarray(tok),
                        JT.init_caches(cfg_j, 2, MAX_LEN))
    lt, ct = hooks.prefill(params_t, torch.as_tensor(tok),
                           hooks.init_caches(2, MAX_LEN), None)
    _close(lt, np.asarray(lj)[:, -1])
    _check_caches(ct, cj, cfg_t)
    pos = np.array([11, 6])
    for _ in range(3):
        tok = rng.integers(0, cfg_t.vocab_size, size=(2, 1)).astype(np.int32)
        lj, cj = JT.decode_step(params_j, cfg_j, jnp.asarray(tok), cj,
                                jnp.asarray(pos, jnp.int32))
        lt, ct = hooks.decode_step(params_t, torch.as_tensor(tok), ct,
                                   torch.as_tensor(pos), None)
        _close(lt, np.asarray(lj)[:, -1])
        _check_caches(ct, cj, cfg_t)
        pos = pos + 1


def test_configs_cover_the_ported_archs():
    assert configs.ARCH_IDS == ["mamba2_2p7b", "codeqwen1p5_7b",
                                "llama4_scout_17b_a16e",
                                "jamba_1p5_large_398b", "deepseek_v3_671b",
                                "llama3_405b", "deepseek_67b",
                                "nemotron_4_15b"]
    assert configs.get_config("llama4-scout-17b-a16e").num_experts == 16
    assert configs.get_smoke_config("jamba-1.5-large-398b").family == \
        "hybrid"
    assert configs.get_config("codeqwen1.5-7b").num_layers == 32
    assert configs.get_smoke_config("mamba2-2.7b").family == "ssm"
    assert configs.get_config("deepseek-v3-671b").use_mla
    for arch in ("whisper_base", "internvl2-76b"):
        with pytest.raises(KeyError, match=arch):
            configs.get_config(arch)


@pytest.mark.parametrize("arch", ["codeqwen1p5_7b", "mamba2_2p7b",
                                  "llama4_scout_17b_a16e",
                                  "jamba_1p5_large_398b", "deepseek_v3_671b",
                                  "llama3_405b", "deepseek_67b",
                                  "nemotron_4_15b"])
def test_full_size_cache_shapes_on_meta(arch):
    """The full configs' caches as shapes only (the meta device), equal to
    the reference's ``cache_shapes`` leaf for leaf."""
    from repro import configs as jconfigs
    cfg_t, cfg_j = configs.get_config(arch), jconfigs.get_config(arch)
    caches = T.init_caches(cfg_t, 2, 1024, device="meta")
    shapes = JT.cache_shapes(cfg_j, 2, 1024)
    assert len(caches) == cfg_t.num_layers
    where = [(si, i) for si, (pat, rep) in enumerate(cfg_j.block_pattern())
             for _ in range(rep) for i in range(len(pat))]
    for layer, c in enumerate(caches):
        si, i = where[layer]
        want = jax.tree.map(lambda a: (a.shape[2:], a.dtype.name),
                            shapes[si][i])
        for k, v in c.items():
            assert v.device.type == "meta"
            assert (tuple(v.shape[1:]), str(v.dtype)[6:]) == \
                (tuple(want[k][0]), want[k][1])
            assert v.shape[0] == 2


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e",
                                  "jamba_1p5_large_398b"])
def test_new_configs_equal_the_reference(arch):
    """The MoE slice's two configs, published and smoke, field for field
    the reference's, by id and by alias."""
    import dataclasses
    from repro import configs as jconfigs
    alias = {"llama4_scout_17b_a16e": "llama4-scout-17b-a16e",
             "jamba_1p5_large_398b": "jamba-1.5-large-398b"}[arch]
    for name in (arch, alias):
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_smoke_config,
                           jconfigs.get_smoke_config)):
            assert dataclasses.asdict(get(name)) == \
                dataclasses.asdict(jget(name))
