"""The cells of ``launch/steps.py`` on tiny configs against the JAX
package's ``repro.launch.steps``.

* ``build_cell`` for train, prefill and decode, decoder-only (dense, ssm,
  vlm) and enc-dec, on a (2, 4) and a (2, 2, 2) mesh where the tiny
  widths divide: the same ``kind`` and ``donate``, the arg shapes' shapes
  and dtypes, and the arg and out specs leaf by leaf (each stacked leaf's
  without its leading axis, ``tests/_torch_stacked.py``); compared with
  ``==``.
* ``cell.fn`` on the CPU from the reference's weights
  (``weights.params_from_stacked``), against the reference's cell
  function (jitted): the train step's loss within 1e-5 relative, its mu
  and nu within ``GRAD`` (rtol 1e-4, atol 2e-6: mu and nu are the first
  step's 0.1 g and 0.05 g**2), its new parameters and master within
  (rtol 1e-5, atol 1e-6) wherever the reference's gradient is above 1e-6
  (AdamW's first step is g / (|g| + eps): nearer zero the gradients' own
  rounding moves a parameter by up to ``lr``, so there they are held to
  ``2 lr``, lr = 3e-4); a prefill's logits and caches and a decode step's
  logits (after a prefill of all but the last token) within ``FWD`` (rtol
  1e-4, atol 1e-5, the ``flash_attention`` tier), and the decode's
  logits the full forward's at the last position.
* ``remat=False`` changes no bit of a train step.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.launch import steps as JST  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adam as A  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402
from repro_torch.weights import params_from_stacked  # noqa: E402

import _torch_stacked as ST  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: F401,E402

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=2e-6)
PARAM = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
SMALL_GRAD = 1e-6
LR = A.AdamConfig().lr
MESHES = {"2x4": (("data", "model"), (2, 4)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
FAMILIES = ("dense", "ssm", "vlm", "audio")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SEQ, BATCH = 16, 4


def _cfgs(family):
    return JR.tiny_config(family), R.tiny_config(family)


def _mesh(name):
    axes, sizes = MESHES[name]
    m = MeshShape(axes, sizes)
    return m, ST.FakeMesh(m.shape)


def _ref_arg(cfg, kind, i, tree, strip, keep):
    """Argument ``i`` of a reference cell (specs or shapes) in the port's
    layout: the params, the AdamW state or the caches, else as it is."""
    if i == 0:
        return ST.params_to_port(cfg, tree, strip, keep)
    if i == 1 and kind == "train":
        return {"leaves": ST.params_to_port(cfg, tree["leaves"], strip,
                                            keep),
                "step": keep(tree["step"])}
    if i == 1:
        return ST.caches_to_port(cfg, tree, strip)
    return ST._map(keep, tree)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_build_cell_matches_reference(family, shape, mesh):
    cfg_j, cfg = _cfgs(family)
    m, fm = _mesh(mesh)
    cell = build_cell(cfg, shape, SEQ, BATCH, m)
    ref = JST.build_cell(cfg_j, shape, SEQ, BATCH, fm)
    assert cell.kind == ref.kind and cell.donate == ref.donate
    assert len(cell.arg_shapes) == len(ref.arg_shapes) \
        == len(cell.arg_pspecs) == len(ref.arg_pspecs)
    for i, (got, want) in enumerate(zip(cell.arg_pspecs, ref.arg_pspecs)):
        ST.assert_same(ST.specs(got), ST.specs(_ref_arg(
            cfg, cell.kind, i, want, ST.strip_spec, ST.keep_spec)),
            f"arg {i} specs")
    for i, (got, want) in enumerate(zip(cell.arg_shapes, ref.arg_shapes)):
        want = _ref_arg(cfg, cell.kind, i, want, ST.strip_shape,
                        ST.keep_shape)
        if i == 1 and cell.kind == "train":
            assert got["step"] == 0 and tuple(want.pop("step").shape) == ()
            got = got["leaves"]
            want = want["leaves"]
        ST.assert_same(ST.shapes(got), ST.shapes(want), f"arg {i} shapes")
    assert all(t.device.type == "meta" for a in cell.arg_shapes
               for _, t in leaves_with_paths(a) if isinstance(t, torch.Tensor))
    # out specs: the params' and AdamW state's (train) or the caches'
    outs = ref.out_pspecs
    conv = lambda i: _ref_arg(cfg, cell.kind, i, outs[i],   # noqa: E731
                              ST.strip_spec, ST.keep_spec)
    want = (conv(0), conv(1), ST.keep_spec(outs[2])) \
        if cell.kind == "train" else (ST.keep_spec(outs[0]), conv(1))
    ST.assert_same(ST.specs(cell.out_pspecs), ST.specs(want), "out specs")


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)


def _frames(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, cfg.max_source_positions, cfg.d_model)).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_train_cell_step_matches_reference(family):
    cfg_j, cfg = _cfgs(family)
    m, fm = _mesh("2x4")
    cell, ref = build_cell(cfg, "train_4k", SEQ, BATCH, m), \
        JST.build_cell(cfg_j, "train_4k", SEQ, BATCH, fm)
    pj = jax.jit(JR.init_model, static_argnums=1)(jax.random.key(0), cfg_j)
    params = params_from_stacked(cfg, pj, "cpu")
    opt = A.init_opt_state(params, A.AdamConfig())
    rng = np.random.default_rng(1)
    batch = {"tokens": _tokens(cfg, 2)}
    batch["labels"] = batch["tokens"]
    if cfg.is_encdec:
        batch["frames"] = _frames(cfg, 3)
    if cfg.frontend_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_embeds, cfg.d_model)).astype(np.float32)
    nj, oj, lj = jax.jit(ref.fn)(pj, JA.init_opt_state(pj, JA.AdamConfig()),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    out_p, out_o, lt = cell.fn(params, opt, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    assert out_p is params and out_o["step"] == 1
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    conv = lambda tree: dict(leaves_with_paths(   # noqa: E731
        params_from_stacked(cfg, tree, "cpu")))
    comp = {c: conv(jax.tree.map(lambda st: st[c], oj["leaves"],
                                 is_leaf=lambda x: isinstance(x, dict)
                                 and "mu" in x))
            for c in ("mu", "nu", "master")}
    new = conv(nj)
    state = dict(leaves_with_paths(out_o["leaves"]))
    for path, p in leaves_with_paths(params):
        for c in ("mu", "nu"):
            np.testing.assert_allclose(_np(state[path + (c,)]),
                                       _np(comp[c][path]),
                                       err_msg=f"{path} {c}", **GRAD)
        big = np.abs(_np(comp["mu"][path])) / 0.1 > SMALL_GRAD
        for got, want in ((_np(p), _np(new[path])),
                          (_np(state[path + ("master",)]),
                           _np(comp["master"][path]))):
            np.testing.assert_allclose(got[big], want[big],
                                       err_msg=str(path), **PARAM)
            assert np.all(np.abs(got - want) <= 2 * LR + 1e-6), path


def _ref_caches(cfg, caches) -> list:
    """The reference's stacked caches, one numpy dict a layer."""
    if cfg.is_encdec:
        n = cfg.decoder_layers or cfg.num_layers
        return [{k: np.asarray(v[i]) for k, v in caches.items()}
                for i in range(n)]
    out = []
    for (pat, rep), seg in zip(cfg.block_pattern(), caches):
        for r in range(rep):
            out.extend({k: np.asarray(v[r]) for k, v in seg[i].items()}
                       for i in range(len(pat)))
    return out


@pytest.mark.parametrize("family", ("dense", "ssm", "audio"))
def test_serving_cells_match_reference(family):
    """The prefill cell over the whole prompt; the decode cell's step at
    the last position after a prefill of the rest into its caches."""
    cfg_j, cfg = _cfgs(family)
    m, fm = _mesh("2x2x2")
    cells = {k: (build_cell(cfg, k, SEQ, BATCH, m),
                 JST.build_cell(cfg_j, k, SEQ, BATCH, fm))
             for k in ("prefill_32k", "decode_32k")}
    pj = jax.jit(JR.init_model, static_argnums=1)(jax.random.key(0), cfg_j)
    params = params_from_stacked(cfg, pj, "cpu")
    tok = _tokens(cfg, 4)
    init_j, init = (JE.init_decoder_caches, E.init_decoder_caches) \
        if cfg.is_encdec else (JT.init_caches, T.init_caches)

    def zeros_j():
        return init_j(cfg_j, BATCH, SEQ)

    def zeros():
        return init(cfg, BATCH, SEQ)

    extra_j = extra = ()
    if cfg.is_encdec:
        frames = _frames(cfg, 5)
        extra_j, extra = (jnp.asarray(frames),), (torch.from_numpy(frames),)
        enc_j = JE.encode(pj, cfg_j, jnp.asarray(frames))
        enc = E.encode(params, cfg, torch.from_numpy(frames))
    cell, ref = cells["prefill_32k"]
    lj, cj = jax.jit(ref.fn)(pj, zeros_j(), jnp.asarray(tok), *extra_j)
    lt, ct = cell.fn(params, zeros(), torch.from_numpy(tok), *extra)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **FWD)
    want = _ref_caches(cfg, cj)
    assert len(want) == len(ct)
    for layer, (c, w) in enumerate(zip(ct, want)):
        assert c.keys() == w.keys()
        for k in c:
            np.testing.assert_allclose(_np(c[k]), w[k],
                                       err_msg=f"{layer} {k}", **FWD)
    # the decode cell: all but the last token prefilled into its caches
    cell, ref = cells["decode_32k"]
    pre_j, pre = cells["prefill_32k"][1].fn, cells["prefill_32k"][0].fn
    _, cj = jax.jit(pre_j)(pj, zeros_j(), jnp.asarray(tok[:, :-1]), *extra_j)
    _, ct = pre(params, zeros(), torch.from_numpy(tok[:, :-1]), *extra)
    idx = SEQ - 1
    enc_args_j, enc_args = ((enc_j,), (enc,)) if cfg.is_encdec else ((), ())
    lj, _ = jax.jit(ref.fn)(pj, cj, jnp.asarray(tok[:, -1:]), *enc_args_j,
                            jnp.int32(idx))
    lt, _ = cell.fn(params, ct, torch.from_numpy(tok[:, -1:]), *enc_args,
                    torch.tensor(idx, dtype=torch.int32))
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **FWD)
    # and the decode's logits are the full forward's at the last position
    if not cfg.is_encdec:
        full, _, _ = T.forward(params, cfg, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(lt[:, 0]), _np(full[:, -1]), **FWD)


def test_train_cell_without_remat_is_the_same_step():
    """``remat=False`` (the reference's option) changes no bit of the
    step."""
    cfg = dataclasses.replace(R.tiny_config("dense"), num_layers=2)
    m, _ = _mesh("2x4")
    tok = torch.from_numpy(_tokens(cfg, 6))
    out = []
    for remat in (True, False):
        params = R.init_model(torch.Generator().manual_seed(0), cfg)
        opt = A.init_opt_state(params, A.AdamConfig())
        cell = build_cell(cfg, "train_4k", SEQ, BATCH, m, remat=remat)
        p, o, loss = cell.fn(params, opt, {"tokens": tok, "labels": tok})
        out.append([loss] + [t for _, t in leaves_with_paths(
            (p, o["leaves"]))])
    assert all(torch.equal(a, b) for a, b in zip(*out))
