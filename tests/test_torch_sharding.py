"""The port's placement rules (``parallel/sharding.py``) and meta-device
shapes against the JAX package's, at the published configs' full size
(nothing allocated).

* ``_fit`` / ``_spec``: the cases of ``tests/test_sharding_lowering.py``.
* For all ten published configs on both production meshes, (16, 16) and
  (2, 16, 16): every parameter leaf's spec equals the reference's
  ``param_pspecs`` spec without its stacked leading ``None``
  (``tests/test_torch_cell_specs.py`` holds the cells' AdamW, batch and
  cache specs).
* ``registry.model_param_shapes``: meta tensors, every leaf's shape and
  dtype the reference's ``jax.eval_shape`` of its init, and their sum the
  reference's; ``cfg.param_count()`` leaves out the norm scales past two
  a block and the encoder's position table, exactly.

Specs and shapes are control-plane output: compared with ``==``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_mesh_shape  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

import _torch_stacked as ST  # noqa: E402


MESHES = ST.MESHES
_meshes = ST.meshes


@pytest.fixture(scope="module")
def ref_param_shapes():
    return {a: JR.model_param_shapes(jconfigs.get_config(a))
            for a in configs.ARCH_IDS}


class TestFit:
    def test_divisible(self):
        m = MeshShape(("data", "model"), (16, 16))
        assert S._fit(m, 64, "model") == "model"
        assert S._fit(m, 63, "model") is None

    def test_suffix_fallback(self):
        m = MeshShape(("pod", "data", "model"), (2, 16, 16))
        # 16 divides by ("data",) but not ("pod","data")=32
        assert S._fit(m, 16, ("pod", "data")) == "data"
        assert S._fit(m, 64, ("pod", "data")) == ("pod", "data")

    def test_odd_vocab_unsharded(self):
        m = MeshShape(("data", "model"), (16, 16))
        # whisper vocab 51865 is odd -> cannot shard on 16
        assert S._fit(m, 51865, "model") is None

    @pytest.mark.parametrize("multi_pod", [False, True])
    def test_spec_matches_reference(self, multi_pod):
        """``_spec`` over a grid of sizes and axis requests, an axis used
        twice dropped the second time, as the reference's."""
        m, fm = _meshes(multi_pod)
        DP = S.dp_axes(m)
        assert DP == JS.dp_axes(fm)
        asks = (None, "model", DP, "data", ("pod", "data") if multi_pod
                else ("data",))
        for sizes in ((64, 32), (16, 48), (51865, 4096), (2, 1), (96, 96)):
            for a in asks:
                for b in asks:
                    assert tuple(S._spec(m, sizes, a, b)) == tuple(
                        JS._spec(fm, sizes, a, b)), (sizes, a, b)

    def test_no_duplicate_axis_in_spec(self):
        m = production_mesh_shape(True)
        for fam in ("dense", "moe", "hybrid"):
            cfg = R.tiny_config(fam)
            specs = S.param_pspecs(cfg, m, R.model_param_shapes(cfg))
            for _, s in S.spec_leaves(specs):
                used = [n for e in s if e is not None
                        for n in ((e,) if isinstance(e, str) else e)]
                assert len(used) == len(set(used)), s


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_param_shapes_match_reference(arch, ref_param_shapes):
    cfg = configs.get_config(arch)
    port = R.model_param_shapes(cfg)
    leaves = leaves_with_paths(port)
    assert all(t.device.type == "meta" for _, t in leaves)
    ref = ST.params_to_port(cfg, ref_param_shapes[arch], ST.strip_shape,
                            ST.keep_shape)
    ST.assert_same(ST.shapes(port), ST.shapes(ref), f"{arch} shapes")
    n = sum(t.numel() for _, t in leaves)
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree.leaves(ref_param_shapes[arch]))
    blocks = cfg.encoder_layers + cfg.decoder_layers if cfg.is_encdec \
        else cfg.num_layers
    uncounted = sum(t.numel() for p, t in leaves
                    if p[-1] in ("scale", "enc_pos")) \
        - 2 * cfg.d_model * blocks
    assert n == cfg.param_count() + uncounted


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, ref_param_shapes):
    m, fm = _meshes(MESHES[mesh])
    cfg = configs.get_config(arch)
    port = S.param_pspecs(cfg, m, R.model_param_shapes(cfg))
    ref = JS.param_pspecs(jconfigs.get_config(arch), fm,
                          ref_param_shapes[arch])
    ST.assert_same(ST.specs(port),
                   ST.specs(ST.params_to_port(cfg, ref, ST.strip_spec,
                                              ST.keep_spec)),
                   f"{arch} on {mesh}")
    # the rules shard something on every config (not all None)
    assert any(any(e is not None for e in s)
               for s in ST.specs(port).values())
