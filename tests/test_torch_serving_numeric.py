"""The port's serving engine in numeric mode on the CPU against the JAX
package: the tiny dense and ssm models from the same weights
(``weights.params_from_stacked``), greedy and seeded top-k streams token
for token, across a mid-stream ``SCALE_IN`` with migration (the port of
``tests/test_serving.py::TestMigrationBitExact``), a ``FAIL_STOP`` rebuild
and the drop policy; then ``offline_generate``, the launcher's smoke path
and ``examples/torch_serve.py``.

The reference re-traces its prefill for every prefix length, so each twin
is three requests of a few tokens.  Tokens and summaries are compared
exactly; the logits behind them are the model-level twins'
(``test_torch_serving_models.py``, rtol 1e-4, atol 1e-5).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.events import ElasticEvent as JEvent  # noqa: E402
from repro.core.events import EventKind as JKind  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro import serving as JS  # noqa: E402
from repro_torch.core.events import ElasticEvent, EventKind  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch import serving as S  # noqa: E402
from repro_torch.weights import params_from_stacked  # noqa: E402

from _torch_threads import torch_one_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {
    "dense": dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
                  d_ff=64, vocab_size=128, dropout_rate=0.0),
    "ssm": dict(num_layers=2, vocab_size=128, dropout_rate=0.0),
}
SAMPLERS = {"greedy": {},
            "topk": dict(method="topk", temperature=0.7, top_k=8, seed=3)}
N_REQ = 3


@pytest.fixture(scope="module")
def models():
    out = {}
    for fam, kw in FAMILIES.items():
        cfg_j = JR.tiny_config(fam, **kw)
        cfg_t = R.tiny_config(fam, **kw)
        pj = JT.init_params(jax.random.key(0), cfg_j)
        out[fam] = (cfg_j, cfg_t, pj, params_from_stacked(cfg_t, pj, "cpu"))
    return out


def _engine(models, fam, sampler, ref: bool, policy=None):
    cfg_j, cfg_t, pj, pt = models[fam]
    kw = dict(n_replicas=2, slots_per_replica=3, max_len=16, mode="numeric",
              seed=0)
    if ref:
        eng = JS.ServingEngine(
            cfg_j, params=pj, sampler=JS.SamplerConfig(**SAMPLERS[sampler]),
            policy=None if policy is None else JS.SERVE_POLICIES[policy],
            **kw)
        Req = JS.Request
    else:
        eng = S.ServingEngine(
            cfg_t, params=pt, sampler=S.SamplerConfig(**SAMPLERS[sampler]),
            policy=None if policy is None else S.SERVE_POLICIES[policy],
            device="cpu", **kw)
        Req = S.Request
    rng = np.random.default_rng(0)
    for rid in range(N_REQ):
        prompt = rng.integers(0, 128, size=6).astype(np.int32)
        eng.submit(Req(rid=rid, arrival=0.0, prompt=prompt,
                       max_new_tokens=4))
    return eng


def _streams(eng):
    return [list(eng.requests[r].generated) for r in range(N_REQ)]


def _disturbed(eng, kind, ref: bool):
    eng.tick()                      # admit + prefill everywhere
    eng.tick()                      # one batched decode step
    ev = (JEvent(getattr(JKind, kind), 0, (0,)) if ref
          else ElasticEvent(getattr(EventKind, kind), 0, (0,)))
    stats = eng.apply_event(ev)
    eng.drain()
    return stats


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_scale_in_migration_is_invisible_to_tokens(models, fam, sampler):
    """A mid-stream SCALE_IN migrates every in-flight request (zero drops);
    the port's streams equal its undisturbed run's and the reference's,
    and the summaries (kv_bytes_moved included) equal the reference's."""
    base = _engine(models, fam, sampler, ref=False)
    base.drain()
    want = _streams(base)
    assert all(len(s) == 4 for s in want)

    ref = _engine(models, fam, sampler, ref=True)
    sj = _disturbed(ref, "SCALE_IN", ref=True)
    eng = _engine(models, fam, sampler, ref=False)
    st = _disturbed(eng, "SCALE_IN", ref=False)
    assert st == sj
    assert st["migrated"] == 2 and st["dropped"] == 0
    assert st["kv_bytes_moved"] == 2 * S.slot_kv_bytes(eng.cfg, 16) > 0
    assert sorted(eng.replicas) == [1]
    assert _streams(eng) == want == _streams(ref)
    assert json.dumps(eng.summary(), sort_keys=True) == \
        json.dumps(ref.summary(), sort_keys=True)


@pytest.mark.parametrize("fam,sampler,kind,policy", [
    ("dense", "greedy", "FAIL_STOP", None),
    ("ssm", "topk", "FAIL_STOP", None),
    ("dense", "topk", "SCALE_IN", "drop"),
    ("ssm", "greedy", "SCALE_IN", "drop"),
])
def test_rebuild_and_drop_equal_the_reference(models, fam, sampler, kind,
                                              policy):
    ref = _engine(models, fam, sampler, ref=True, policy=policy)
    sj = _disturbed(ref, kind, ref=True)
    eng = _engine(models, fam, sampler, ref=False, policy=policy)
    st = _disturbed(eng, kind, ref=False)
    assert st == sj
    if policy == "drop":
        assert st["dropped"] == 2
    else:
        assert st["rebuilt"] == 2 and st["dropped"] == 0
    assert _streams(eng) == _streams(ref)
    assert eng.event_log == ref.event_log
    assert json.dumps(eng.summary(), sort_keys=True) == \
        json.dumps(ref.summary(), sort_keys=True)


def test_migrated_slot_equals_its_source(models):
    """The pool copy migration makes is exact: every cache tensor of the
    destination slot equals the source slot's, bit for bit."""
    eng = _engine(models, "ssm", "greedy", ref=False)
    eng.tick()
    eng.tick()
    src = eng.replicas[0].pool
    slots = src.active_slots()
    before = [src.read(s)[0] for s in slots]
    rids = [int(src.slot_req[s]) for s in slots]
    eng.apply_event(ElasticEvent(EventKind.SCALE_IN, 0, (0,)))
    dst = eng.replicas[1].pool
    for rid, cache in zip(rids, before):
        slot = eng.requests[rid].slot
        got = dst.read(slot)[0]
        for g, w in zip(got, cache):
            for k in g:
                assert torch.equal(g[k], w[k])


def test_offline_generate_and_launcher_smoke(capsys, tmp_path):
    cfg = R.tiny_config("dense", **FAMILIES["dense"])
    out = S.offline_generate(cfg, batch=2, prompt_len=5, max_new_tokens=3,
                             seed=0, device="cpu")
    assert out["sequences"].shape == (2, 3)
    assert out["summary"]["completed"] == 2
    args = ["--arch", "mamba2_2p7b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--tokens", "3",
            "--temperature", "0.8"]
    res = launch_serve.main(args)
    assert res["sequences"].shape == (2, 3)
    assert "generated 6 tokens" in capsys.readouterr().out
    # --dryrun runs the full config's decode_32k cell on meta DTensors
    # (python -m repro_torch.launch.dryrun) and writes its artifact
    out = tmp_path / "codeqwen1p5_7b__decode_32k__single.json"
    with pytest.raises(SystemExit) as e:
        launch_serve.main(["--arch", "codeqwen1p5_7b", "--dryrun",
                           "--out-dir", str(tmp_path)])
    assert e.value.code == 0
    art = json.loads(out.read_text())
    assert art["status"] == "ok" and art["kind"] == "decode"


def _example():
    spec = importlib.util.spec_from_file_location(
        "_example_torch_serve", ROOT / "examples" / "torch_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_serves_on_the_cpu(capsys):
    out = _example().main(["--device", "cpu", "--batch", "2",
                           "--prompt-len", "4", "--tokens", "2"])
    assert out["summary"]["completed"] == 2
    assert "serving codeqwen-smoke" in capsys.readouterr().out


def test_example_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _example().main(["--batch", "1", "--tokens", "1"])
