"""The cells' specs and shapes (``launch/steps.build_cell``) at the
published configs' full size against the JAX package's rules, nothing
allocated: for all ten configs on both production meshes, (16, 16) and
(2, 16, 16), at every shape of ``cfg.shapes`` not in ``cfg.skip_shapes``,
the AdamW state's specs and shapes (a train cell), the batch's specs and
shapes, the caches' specs and shapes (prefill, decode) and the tokens'
specs equal the reference's, each stacked leaf's without its leading axis
(``tests/_torch_stacked.py``).  ``opt_state_shapes`` and ``cache_shapes``
at full size are meta tensors.  Compared with ``==``.
"""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adam import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim.adam import opt_state_shapes as j_opt_state_shapes  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.steps import build_cell, shape_kind  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.optim.adam import AdamConfig, opt_state_shapes  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

import _torch_stacked as ST  # noqa: E402

MESHES = ST.MESHES
_meshes = ST.meshes


@pytest.fixture(scope="module")
def ref_param_shapes():
    return {a: JR.model_param_shapes(jconfigs.get_config(a))
            for a in configs.ARCH_IDS}


def _ref_cell_pieces(jcfg, kind, seq, batch, fm, params_sh):
    """The reference's specs and shapes of a cell, from its own rules and
    shape functions (its ``build_cell`` without the step function)."""
    pspec_params = JS.param_pspecs(jcfg, fm, params_sh)
    if kind == "train":
        batch_sh = JST._batch_shapes(jcfg, batch, seq)
        return dict(
            opt=JST._opt_pspecs_like(params_sh, pspec_params, None),
            opt_sh=j_opt_state_shapes(params_sh, JAdamConfig()),
            batch=JS.batch_pspecs(jcfg, fm, batch_sh), batch_sh=batch_sh)
    caches_sh = jax.eval_shape(
        lambda: JE.init_decoder_caches(jcfg, batch, seq)) if jcfg.is_encdec \
        else JT.cache_shapes(jcfg, batch, seq)
    return dict(caches=JS.cache_pspecs(jcfg, fm, caches_sh),
                caches_sh=caches_sh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cell_specs_match_reference(arch, mesh, ref_param_shapes):
    """Every non-skipped shape of ``cfg.shapes``: the AdamW state's specs
    and shapes (a train cell), the batch's specs and shapes, the caches'
    specs and shapes (prefill, decode), the tokens' specs, as the
    reference's."""
    m, fm = _meshes(MESHES[mesh])
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    skip = {name for name, _ in cfg.skip_shapes}
    params_sh = ref_param_shapes[arch]
    for name, seq, batch in cfg.shapes:
        if name in skip:
            continue
        kind = shape_kind(name)
        cell = build_cell(cfg, name, seq, batch, m)
        ref = _ref_cell_pieces(jcfg, kind, seq, batch, fm, params_sh)
        what = f"{arch} {name} on {mesh}"
        assert cell.kind == kind
        if kind == "train":
            _, opt_specs, batch_specs = cell.arg_pspecs
            want = {"leaves": ST.params_to_port(
                cfg, ref["opt"]["leaves"], ST.strip_spec, ST.keep_spec),
                "step": ST.keep_spec(ref["opt"]["step"])}
            ST.assert_same(ST.specs(opt_specs), ST.specs(want),
                           f"{what}: AdamW")
            assert cell.out_pspecs[1] is opt_specs
            ST.assert_same(ST.specs(batch_specs), {
                (k,): tuple(v) for k, v in ref["batch"].items()},
                f"{what}: batch")
            ST.assert_same(ST.shapes(cell.arg_shapes[2]), ST.shapes(
                {k: ST.keep_shape(v) for k, v in ref["batch_sh"].items()}),
                f"{what}: batch shapes")
            opt_sh = cell.arg_shapes[1]
            want_sh = ST.params_to_port(cfg, ref["opt_sh"]["leaves"],
                                        ST.strip_shape, ST.keep_shape)
            ST.assert_same(ST.shapes(opt_sh["leaves"]), ST.shapes(want_sh),
                           f"{what}: AdamW shapes")
            assert opt_sh["step"] == 0
            continue
        caches = cell.arg_pspecs[1]
        ST.assert_same(ST.specs(caches), ST.specs(ST.caches_to_port(
            cfg, ref["caches"], ST.strip_spec)), f"{what}: caches")
        ST.assert_same(ST.shapes(cell.arg_shapes[1]), ST.shapes(
            ST.caches_to_port(cfg, ref["caches_sh"], ST.strip_shape)),
            f"{what}: cache shapes")
        n_tok = seq if kind == "prefill" else 1
        assert tuple(cell.arg_pspecs[2]) == tuple(
            JS._spec(fm, (batch, n_tok), JS.dp_axes(fm), None))


def test_opt_state_shapes_allocate_nothing():
    cfg = configs.get_config("llama3_405b")
    st = opt_state_shapes(R.model_param_shapes(cfg), AdamConfig())
    leaves = leaves_with_paths(st["leaves"])
    assert st["step"] == 0 and leaves
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for _, t in leaves)
    assert {p[-1] for p, _ in leaves} == {"mu", "nu", "master"}


def test_cache_shapes_allocate_nothing():
    """The largest cache of the published cells (decode_32k: 128 x
    32768 positions of llama3-405b's 126 layers, ~34 TB in bf16) is meta
    tensors."""
    from repro_torch.models import transformer as T
    cfg = configs.get_config("llama3_405b")
    caches = T.cache_shapes(cfg, 128, 32768)
    assert len(caches) == cfg.num_layers
    assert all(t.device.type == "meta" for c in caches for t in c.values())
