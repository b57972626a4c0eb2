"""The port's MLA model (deepseek-v3's latent attention) on the CPU against
the JAX package: the whole model's forward, prefill and decode, the flat
ZeRO order of an MLA layer, a tiny serving engine, and the four configs of
the slice that brought MLA, the chunked path and the dense published
configs, field for field.

Weights come from the reference (``jax.random`` init) through
``repro_torch.weights``; tokens from numpy with a seed.  Float32 within
``FWD``, the ``flash_attention`` tier of ``kernels/ops.py``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.core.statespace import EntryFlattener  # noqa: E402
from repro_torch.kernels.ops import TOLERANCE_TIERS  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.weights import params_from_numpy, params_from_stacked  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

FWD = dict(TOLERANCE_TIERS["flash_attention"])
MLA = dict(use_mla=True, q_lora_rank=32, kv_lora_rank=32, qk_rope_dim=16,
           qk_nope_dim=16, v_head_dim=24)
MAX_LEN = 16
NEW_ARCHS = {"deepseek_v3_671b": "deepseek-v3-671b",
             "deepseek_67b": "deepseek-67b", "llama3_405b": "llama3-405b",
             "nemotron_4_15b": "nemotron-4-15b"}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


@pytest.mark.parametrize("arch", sorted(NEW_ARCHS))
def test_configs_equal_the_reference(arch):
    """Published and smoke configs, field for field the reference's, by
    id and by alias."""
    for name in (arch, NEW_ARCHS[arch]):
        for get, jget in ((C.get_config, JC.get_config),
                          (C.get_smoke_config, JC.get_smoke_config)):
            assert dataclasses.asdict(get(name)) == \
                dataclasses.asdict(jget(name))


def test_whole_model_forward_prefill_and_decode():
    """deepseek-v3's smoke config (MLA with q_lora, a dense layer, then
    MoE; capacity factor 16 so that no token drops) from the reference's
    stacked weights: the forward's logits, the prefill's, and three
    batched decode steps' against the reference."""
    cfg_j = dataclasses.replace(JC.get_smoke_config("deepseek_v3_671b"),
                                capacity_factor=16.0)
    cfg_t = dataclasses.replace(C.get_smoke_config("deepseek_v3_671b"),
                                capacity_factor=16.0)
    pj = JT.init_params(jax.random.key(0), cfg_j)
    pt = params_from_stacked(cfg_t, pj, "cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg_t.vocab_size, (2, 11)).astype(np.int32)
    want, _, aux_j = JT.forward(pj, cfg_j, jnp.asarray(toks))
    got, _, aux_t = T.forward(pt, cfg_t, torch.as_tensor(toks))
    _close(got, want, FWD)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    lj, cj = JT.prefill(pj, cfg_j, jnp.asarray(toks[:, :8]),
                        JT.init_caches(cfg_j, 2, MAX_LEN))
    lt, ct = T.prefill(pt, cfg_t, torch.as_tensor(toks[:, :8]),
                       T.init_caches(cfg_t, 2, MAX_LEN))
    _close(lt, lj, FWD)
    for i in range(8, 11):
        lj, cj = JT.decode_step(pj, cfg_j, jnp.asarray(toks[:, i:i + 1]),
                                cj, i)
        lt, ct = T.decode_step(pt, cfg_t, torch.as_tensor(toks[:, i:i + 1]),
                               ct, i)
        _close(lt, lj, FWD)
        _close(lt[:, 0], want[:, i], dict(rtol=5e-4, atol=5e-4))


def test_mla_layer_flattens_in_the_reference_order():
    """An MLA layer's entry (the cluster's flat ZeRO vector) bitwise the
    reference's ``ravel_pytree``, and its gradient vector in the same
    order."""
    cfg_j = JC.get_smoke_config("deepseek_v3_671b")
    cfg_t = C.get_smoke_config("deepseek_v3_671b")
    for lid in (0, 1):          # the dense MLA layer, then an MoE one
        lj = JR.init_layer(jax.random.key(lid), cfg_j, lid)
        _, (lt,), _ = params_from_numpy({}, [jax.tree.map(np.asarray, lj)],
                                        {}, "cpu")
        assert sorted(lt["attn"]) == sorted(lj["attn"]) == [
            "kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
        np.testing.assert_array_equal(
            EntryFlattener().flatten_entry(lid, lt).numpy(),
            np.asarray(ravel_pytree(lj)[0]))


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_engine_twin_vs_reference(family):
    """Greedy streams and summaries of a tiny MLA engine (1 replica x 4
    slots, 3 requests; MLA + MoE blocks, or MLA + MLP blocks) equal the
    reference's from the same weights."""
    from repro import serving as JS
    from repro_torch import serving as S
    kw = dict(MLA, capacity_factor=16.0, num_layers=2, d_model=32,
              num_heads=2, num_kv_heads=1, d_ff=64, moe_d_ff=32,
              vocab_size=128, dropout_rate=0.0)
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


@pytest.mark.parametrize("arch", sorted(NEW_ARCHS))
def test_launcher_serves_the_smoke_configs(arch, capsys):
    """``launch/serve.py --smoke`` serves each new config's smoke size on
    the CPU (deepseek-v3's: MLA and MoE blocks)."""
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--tokens", "4"])
    assert out["summary"]["completed"] == 4
    assert out["sequences"].shape == (4, 4)
    assert "serving" in capsys.readouterr().out
