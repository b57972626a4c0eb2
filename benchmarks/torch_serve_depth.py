#!/usr/bin/env python3
"""How far mamba2-2.7b's cached decode lands from its full-sequence forward,
by depth and dtype, on one card.

    python3 benchmarks/torch_serve_depth.py [--engine]

For 1, 8 and 64 layers at mamba2-2.7b's published widths (random weights
from seed 0), in bf16 and at 8 and 64 layers in float32: one sequence of
1024 + 32 seeded tokens through a full-sequence forward (the prefill path
over every position), then the first 1024 prefilled into a cache and the
rest decoded a step at a time, at batch width 1 and as row 2 of a width-4
batch (``rows=``, the engine's fixed-width decode).  Prints, per step, the
decode's logits against the forward's row as max |a - b| / max |b|; in
bf16 at 1 and 8 layers also the CPU's decode of the same model against the
card's forward.  Then (``--engine``: only this) phase 11's gate run of
``chip_smoke.py``: the 64-layer bf16 draw cut to its first 8 layers,
through the engine (2 replicas x 4 slots, 8 requests of 1024 + 64
tokens, greedy), each request's sampled logits rows against the bf16
full-sequence forward and against the float32 forward of the same
weights cast up, the bf16 forward against the float32 one, the engine's
excess over it (phase 11's gate holds this to ``SERVE_LOGIT_RTOL``), and
the same engine run with the weights in float32 against the float32
forward;
per request the worst row of each, with its max |logit| and the top-2
margin.  A JSON line with each case's worst comes last.  The card's name
and power limit come first.  Needs a card and nvcc.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import mamba2_2p7b  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

PROMPT, NEW = 1024, 32
CASES = (("bfloat16", 1), ("bfloat16", 8), ("bfloat16", 64),
         ("float32", 8), ("float32", 64))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def decode_ratios(params, cfg, toks, full, device, width, row) -> list:
    """Prefill ``PROMPT`` tokens into row ``row`` of a width-``width``
    cache, decode the rest; each step's logits against ``full``."""
    dev = torch.device(device)
    one = T.init_caches(cfg, 1, PROMPT + NEW + 1, device=dev)
    lg, one = T.prefill(params, cfg, torch.as_tensor([toks[:PROMPT]],
                                                     device=dev), one)
    out = [rel(lg[0, -1], full[PROMPT - 1])]
    caches = T.init_caches(cfg, width, PROMPT + NEW + 1, device=dev)
    for c, c1 in zip(caches, one):
        for k in c:
            c[k][row] = c1[k][0]
    del one
    for i in range(NEW - 1):
        tk = torch.zeros(width, 1, dtype=torch.int64, device=dev)
        tk[row, 0] = toks[PROMPT + i]
        pos = torch.zeros(width, dtype=torch.int64, device=dev)
        pos[row] = PROMPT + i
        lg, caches = T.decode_step(params, cfg, tk, caches, pos,
                                   rows=torch.tensor([row], device=dev))
        out.append(rel(lg[row, -1], full[PROMPT + i]))
    return out


def engine_rows(worst: dict) -> None:
    """Phase 11's mamba2 gate run, each sampled row against the bf16 and
    float32 forwards (see the module's docstring)."""
    full = mamba2_2p7b.config()
    params = R.init_model(torch.Generator(device="cuda").manual_seed(0),
                          full)
    depth = cs.SERVE_GATE_LAYERS["ssm"]
    cfg = dataclasses.replace(full, num_layers=depth)
    cut = (params[0], params[1][:depth], params[2])
    del params
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cut32 = cs.float32_params(cut)
    kw = dict(n_requests=8, prompt_len=1024, max_new=64, late=range(4, 8),
              late_at=4.0, slots=4)
    runs = {"bf16": cs.serve_run(cfg, cut, cs.SamplerConfig(), "cuda", **kw),
            "float32": cs.serve_run(cfg32, cut32, cs.SamplerConfig(), "cuda",
                                    **kw)}
    for rid, req in sorted(runs["bf16"]["engine"].requests.items()):
        seq = [int(t) for t in req.prompt] + req.generated[:-1]
        fb = cs.full_forward_logits(cut, cfg, seq).float().cpu()
        ff = cs.full_forward_logits(cut32, cfg32, seq).float().cpu()
        req32 = runs["float32"]["engine"].requests[rid]
        seq32 = [int(t) for t in req32.prompt] + req32.generated[:-1]
        ff32 = ff if seq32 == seq else cs.full_forward_logits(
            cut32, cfg32, seq32).float().cpu()
        rows = {k: [] for k in ("engine vs bf16 forward",
                                "engine vs float32 forward",
                                "bf16 forward vs float32 forward",
                                "engine's excess over the bf16 forward",
                                "float32 engine vs float32 forward")}
        for pos in range(len(req.prompt), len(seq) + 1):
            e = torch.as_tensor(runs["bf16"]["logits"][(rid, pos)])
            e32 = torch.as_tensor(runs["float32"]["logits"][(rid, pos)])
            rows["engine vs bf16 forward"].append(rel(e, fb[pos - 1]))
            rows["engine vs float32 forward"].append(rel(e, ff[pos - 1]))
            rows["bf16 forward vs float32 forward"].append(
                rel(fb[pos - 1], ff[pos - 1]))
            rows["engine's excess over the bf16 forward"].append(
                rows["engine vs float32 forward"][-1]
                - rows["bf16 forward vs float32 forward"][-1])
            rows["float32 engine vs float32 forward"].append(
                rel(e32, ff32[pos - 1]))
        at = int(np.argmax(rows["engine vs bf16 forward"]))
        pos = len(req.prompt) + at
        top = np.sort(ff[pos - 1].numpy())[-2:]
        print(f"request {rid}: generated {req.generated[:24]}... "
              f"(float32 engine's equal: {req32.generated == req.generated}"
              f"); worst engine-vs-bf16-forward row at position {pos}, "
              f"max |logit| {float(fb[pos - 1].abs().max()):.1f}, float32 "
              f"top-2 margin {float(top[1] - top[0]):.3f}; worst per row: "
              + "; ".join(f"{k} {max(v):.4e} (that row {v[at]:.4e})"
                          for k, v in rows.items()), flush=True)
        for k, v in rows.items():
            key = f"8-layer engine {k}"
            worst[key] = max(worst.get(key, 0.0), max(v))


def main() -> None:
    cs.phase_device()
    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    if "--engine" in sys.argv[1:]:
        engine_rows(worst)
        print(json.dumps({"serve_depth_worst_step": worst}), flush=True)
        return
    for dtype, layers in CASES:
        cfg = dataclasses.replace(mamba2_2p7b.config(), num_layers=layers,
                                  dtype=dtype)
        params = R.init_model(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, PROMPT + NEW).tolist()
        t = torch.as_tensor([toks], device="cuda")
        full = T.forward(params, cfg, t, caches=T.init_caches(
            cfg, 1, len(toks), device="cuda"), cache_index=0)[0][0]
        runs = [(f"width {w}", decode_ratios(params, cfg, toks, full, "cuda",
                                             w, row))
                for w, row in ((1, 0), (4, 2))]
        if dtype == "bfloat16" and layers <= 8:
            cpu = tuple(cs.params_from_numpy(*params, "cpu"))
            runs.append(("CPU width 1", decode_ratios(cpu, cfg, toks, full,
                                                      "cpu", 1, 0)))
            del cpu
        for label, r in runs:
            print(f"{dtype} {layers} layers, {label}: decode vs forward, "
                  f"max |a - b| / max |b| per step: "
                  + " ".join(f"{x:.4f}" for x in r), flush=True)
            worst[f"{dtype} {layers} layers {label}"] = max(r)
        del params, full
        torch.cuda.empty_cache()
    engine_rows(worst)
    print(json.dumps({"serve_depth_worst_step": worst}), flush=True)


if __name__ == "__main__":
    main()
