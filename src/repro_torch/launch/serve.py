"""Serving launcher of the port: batched generation through the elastic
serving engine on a reduced config, mirroring ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1p5_7b \
        --smoke [--device cpu]

The smoke path is a thin wrapper over
:func:`repro_torch.serving.offline_generate` — the same continuous-batching
engine the elastic runs drive, so every family (enc-dec included:
``--arch whisper_base`` draws each request's frames) serves through one
code path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1p5_7b \
        --dryrun [--shape decode_32k] [--multi-pod]

``--dryrun`` runs the full config's serving cell ``--shape`` on meta
DTensors over a fake process group of the production mesh
(``python -m repro_torch.launch.dryrun``) and writes its artifact.
"""
from __future__ import annotations

import argparse


def add_generation_args(ap: argparse.ArgumentParser):
    """Generation flags shared with examples/torch_serve.py."""
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 enables seeded top-k sampling")
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")


def run_smoke(arch: str, args) -> dict:
    """Generate through the serving engine; returns offline_generate's dict."""
    from repro_torch import configs
    from repro_torch.serving import SamplerConfig, offline_generate

    cfg = configs.get_smoke_config(arch)
    sampler = (SamplerConfig() if args.temperature <= 0 else
               SamplerConfig(method="topk", temperature=args.temperature,
                             top_k=args.top_k, seed=args.seed))
    print(f"serving {cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"decode={args.tokens} sampler={sampler.describe()}")
    out = offline_generate(cfg, batch=args.batch, prompt_len=args.prompt_len,
                           max_new_tokens=args.tokens, seed=args.seed,
                           sampler=sampler, device=args.device)
    s = out["summary"]
    total = s["tokens_decoded"]
    print(f"generated {total} tokens in {out['wall_seconds']:.2f}s wall "
          f"({total / out['wall_seconds']:.0f} tok/s aggregate)")
    for b in range(args.batch):
        print(f"  [{b}] {out['sequences'][b][:16].tolist()}...")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--shape", default="decode_32k",
                    choices=["prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out-dir", default=None,
                    help="--dryrun's artifact directory (default "
                         "artifacts/dryrun_torch/)")
    add_generation_args(ap)
    args = ap.parse_args(argv)

    if args.dryrun:
        from repro_torch.launch.train import run_dryrun
        raise SystemExit(run_dryrun(args.arch, args.shape, args.multi_pod,
                                    args.out_dir))
    return run_smoke(args.arch, args)


if __name__ == "__main__":
    main()
