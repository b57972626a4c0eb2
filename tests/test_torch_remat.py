"""Remat (``make_train_loss(cfg, remat=True)``: each block under
``torch.utils.checkpoint``) on the CPU.

* Tiny twins of every family (dense, moe, ssm, hybrid, MLA, enc-dec,
  vlm prefix), at dropout 0 and 0.1: the loss and every gradient with
  remat are **bitwise** those without, and each block's forward ran twice
  (the recompute), once without.  Dropout is content-addressed, so the
  recompute draws the same masks with no RNG state stashed.
* ``forward`` refuses remat with caches (remat is a training option).

``tests/test_torch_remat_twin.py`` holds the same configs against the
reference's remat.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import RngCtx  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

RATES = (0.0, 0.1)
MLA = dict(use_mla=True, q_lora_rank=32, kv_lora_rank=32, qk_rope_dim=16,
           qk_nope_dim=16, v_head_dim=24)
FAMILIES = {"dense": ("dense", {}), "moe": ("moe", {}), "ssm": ("ssm", {}),
            "hybrid": ("hybrid", {}), "mla": ("moe", MLA),
            "encdec": ("audio", {}), "vlm": ("vlm", {})}
B, S = 2, 16
SAMPLE_IDS = np.array([3, 100003], np.int32)


def _configs(name, rate):
    family, kw = FAMILIES[name]
    return (JR.tiny_config(family, dropout_rate=rate, **kw),
            R.tiny_config(family, dropout_rate=rate, **kw))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    if cfg.frontend_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_embeds, cfg.d_model)).astype(np.float32)
    return batch


def _jkey():
    return jax.random.fold_in(jax.random.key(0), np.uint32(5))


def _port_loss_and_grads(cfg, params, batch, remat):
    """(loss, {path: gradient}) of the port's loss at dropout addressed by
    ``_jkey()`` and ``SAMPLE_IDS``."""
    ctx = RngCtx(step_key=np.asarray(jax.random.key_data(_jkey())),
                 sample_ids=torch.from_numpy(SAMPLE_IDS), deterministic=False)
    leaves = leaves_with_paths(params)
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss = R.make_train_loss(cfg, remat=remat)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}, ctx)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    finally:
        for _, t in leaves:
            t.requires_grad_(False)
    return loss.detach(), dict(zip([p for p, _ in leaves], grads))


@pytest.fixture
def block_calls(monkeypatch):
    """Counts each block's forward, through the names the models call."""
    calls = []
    for mod, name in ((T, "apply_block"), (E, "apply_encoder_block"),
                      (E, "apply_decoder_block")):
        inner = getattr(mod, name)

        def counted(*a, _inner=inner, _name=name, **k):
            calls.append(_name)
            return _inner(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_remat_is_bitwise(name, rate, block_calls):
    _, cfg = _configs(name, rate)
    params = R.init_model(torch.Generator().manual_seed(0), cfg)
    batch = _batch(cfg)
    blocks = cfg.encoder_layers + cfg.decoder_layers if cfg.is_encdec \
        else cfg.num_layers
    out = {}
    for remat in (False, True):
        del block_calls[:]
        out[remat] = _port_loss_and_grads(cfg, params, batch, remat)
        assert len(block_calls) == blocks * (2 if remat else 1), remat
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1), (float(l0), float(l1))
    assert g0.keys() == g1.keys()
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path
    assert all(torch.count_nonzero(g) > 0 for g in g0.values())


def test_remat_refuses_caches():
    cfg = R.tiny_config("dense", num_layers=2)
    params = R.init_model(torch.Generator().manual_seed(0), cfg)
    caches = T.init_caches(cfg, 1, 8)
    with pytest.raises(ValueError, match="remat"):
        T.forward(params, cfg, torch.zeros(1, 4, dtype=torch.int64),
                  caches=caches, cache_index=0, remat=True)
