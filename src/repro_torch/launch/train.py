"""Training launcher of the port: real single-host training of a whole
model, mirroring ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_2p7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_2p7b \
        --steps 3 --seq 512 --batch 2

A step draws the global batch of ``GlobalBatchSampler`` (``make_batch``;
an enc-dec config adds ``frames`` [batch, seq, d_model], a vlm config
``prefix_embeds`` [batch, frontend_embeds, d_model]), runs the whole-model
loss (``registry.make_train_loss``) forward and backward, and updates
every parameter in place with the tree-level AdamW (``optim/adam.py``,
the fused-AdamW kernel once a parameter on the card).  Every tree lives
on the device: weights, gradients and the float32 master, mu and nu.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_405b \
        --dryrun [--multi-pod]

``--dryrun`` runs the full config's ``train_4k`` cell on meta DTensors
over a fake process group of the production mesh
(``python -m repro_torch.launch.dryrun``, as the reference calls its dry
run) and writes its artifact (``artifacts/dryrun_torch/``).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.optim import adam as A
from repro_torch.tree import leaves_with_paths, map_params

# the seed of the extra inputs' generator at a step: (9, step), as the
# reference folds its key 9 with the step
EXTRA_SEED = 9
ADAM = A.AdamConfig(lr=1e-3)


def extra_inputs(cfg, step: int, batch: int, seq: int, device) -> dict:
    """An enc-dec config's ``frames`` [batch, seq, d_model] or a vlm
    config's ``prefix_embeds`` [batch, frontend_embeds, d_model] (float32,
    standard normal), else nothing.  Drawn on the host from a generator
    seeded from ``(9, step)`` and moved to ``device``, so that the card
    and the CPU train on the same inputs (the numbers are the port's own,
    not jax's)."""
    shape = (batch, seq, cfg.d_model) if cfg.is_encdec else \
        (batch, cfg.frontend_embeds, cfg.d_model) if cfg.frontend_embeds \
        else None
    if shape is None:
        return {}
    gen = torch.Generator().manual_seed((EXTRA_SEED << 32) + step)
    x = torch.randn(shape, generator=gen, dtype=torch.float32).to(device)
    return {"frames" if cfg.is_encdec else "prefix_embeds": x}


def train_step(params, opt, batch: dict, loss_fn: Callable,
               adam: A.AdamConfig):
    """One step in place: ``loss_fn(params, batch)`` forward and backward
    (every parameter requires its gradient), ``adam_update``, gradients
    dropped.  Returns (the loss, detached, on the device; the new optimizer
    state)."""
    loss = loss_fn(params, batch)
    loss.backward()
    grads = map_params(lambda t: t.grad, params)
    params, opt = A.adam_update(params, grads, opt, adam)
    for _, t in leaves_with_paths(params):
        t.grad = None
    return loss.detach(), opt


def train_steps(cfg, params, opt, first: int, n: int, *, seq: int,
                batch: int, device, ckpt=None,
                log: Callable = print) -> Tuple[List[float], dict]:
    """Steps ``first .. first + n - 1`` of ``cfg`` in place from ``params``
    and the AdamW state ``opt``, on ``device`` (a resolved device); a
    checkpoint without blocking at every ``step % 10 == 9`` when ``ckpt``
    (a ``CheckpointManager``) is given.  Prints a step line every 5 steps
    and at the last.  Returns (the losses, the new state)."""
    from repro_torch.data.pipeline import GlobalBatchSampler, make_batch
    from repro_torch.models import registry as R

    loss_fn = R.make_train_loss(cfg)
    sampler = GlobalBatchSampler(batch)
    leaves = [t for _, t in leaves_with_paths(params)]
    for t in leaves:
        t.requires_grad_(True)
    losses = []
    try:
        t0 = time.time()
        for step in range(first, first + n):
            b = make_batch(sampler.sample_ids(step), seq, cfg.vocab_size,
                           device=device)
            b.update(extra_inputs(cfg, step, batch, seq, device))
            loss, opt = train_step(params, opt, b, loss_fn, ADAM)
            losses.append(loss)
            if step % 5 == 0 or step == first + n - 1:
                log(f"step {step:4d} loss={float(loss):.4f} "
                    f"({(time.time() - t0) / (step - first + 1) * 1e3:.0f} "
                    f"ms/step)")
            if ckpt and step % 10 == 9:
                ckpt.save(step, params, opt, blocking=False)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return [float(x) for x in losses], opt


def train(cfg, *, steps: int, seq: int, batch: int, device=None,
          ckpt_dir: Optional[str] = None, log: Callable = print,
          params=None) -> List[float]:
    """Train ``cfg`` for ``steps`` steps on ``device`` (None: the card;
    raises without one) from ``params`` (None: ``registry.init_model`` from
    seed 0 on the device), with AdamW at lr 1e-3; save a checkpoint
    without blocking at every ``step % 10 == 9`` under ``ckpt_dir``.
    Prints the reference's lines.  Returns the losses."""
    from repro_torch.core.cluster import resolve_device
    from repro_torch.models import registry as R

    dev = resolve_device(device)
    log(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    if params is None:
        params = R.init_model(torch.Generator(dev).manual_seed(0), cfg)
    opt = A.init_opt_state(params, ADAM)
    ckpt = None
    if ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        ckpt = CheckpointManager(ckpt_dir)
    losses, _ = train_steps(cfg, params, opt, 0, steps, seq=seq, batch=batch,
                            device=dev, ckpt=ckpt, log=log)
    if ckpt:
        ckpt.wait()
        log(f"checkpoints: {sorted(p.name for p in ckpt.dir.glob('step_*'))}")
    return losses


def run_dryrun(arch: str, shape: str, multi_pod: bool,
               out_dir: Optional[str] = None) -> int:
    """``python -m repro_torch.launch.dryrun`` on one cell of ``arch``
    (the multi mesh under ``multi_pod``; its artifact in ``out_dir``, by
    default the dry run's own) in a subprocess, as the reference's
    launchers call theirs; returns its exit code."""
    import subprocess
    import sys
    return subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "multi" if multi_pod else "single"]
        + (["--out-dir", str(out_dir)] if out_dir else []))


def main(argv=None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config")
    ap.add_argument("--dryrun", action="store_true",
                    help="count the full config's train_4k cell on meta "
                         "DTensors over the 16x16 mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out-dir", default=None,
                    help="--dryrun's artifact directory (default "
                         "artifacts/dryrun_torch/)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.dryrun:
        raise SystemExit(run_dryrun(args.arch, "train_4k", args.multi_pod,
                                    args.out_dir))
    from repro_torch import configs
    cfg = configs.get_smoke_config(args.arch) if args.smoke else \
        configs.get_config(args.arch)
    return train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
                 device=args.device, ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
