"""End-to-end elastic training on the PyTorch/CUDA port.

The counterpart of ``examples/elastic_train.py`` (the JAX package) on
``repro_torch``: trains a configurable decoder-only model on the
deterministic corpus while a scripted fault schedule (fail-stop at 1/3 of
the run, fail-slow at 2/3) exercises the full ElasWave recovery path:
Agent detection -> ScheduleEngine multi-dim plan -> communicator edit ->
live remap -> layer migration -> dataflow/DVFS/RNG application.  It runs on
the card (the hand-written kernels) unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_elastic_train.py \
        [--steps 200] [--dmodel 256] [--layers 8] [--report-every 10] \
        [--device cuda|cpu]

At the default size this is a ~10M-param float32 model; --dmodel 896
--layers 12 gives ~100M.
"""
import argparse
import time

import numpy as np

from repro_torch.core.cluster import VirtualCluster
from repro_torch.models.config import ModelConfig


def elastic_train(steps: int = 200, dmodel: int = 256, layers: int = 8,
                  vocab: int = 2048, seq: int = 64, global_batch: int = 16,
                  report_every: int = 10, device: str = "cuda") -> dict:
    """Trains for ``steps`` steps on dp 4, pp 2 with a fail-stop of rank
    (dp 2, stage 0) at ``steps // 3``, found by the probes, and a fail-slow
    (x1.4) of rank (dp 0, stage 1) at ``2 * steps // 3``.  Prints as the
    reference's example does and returns the losses and the two recovery
    records."""
    heads = dmodel // 64 or 2
    cfg = ModelConfig(name="elastic-demo", family="dense",
                      num_layers=layers, d_model=dmodel, num_heads=heads,
                      num_kv_heads=max(heads // 2, 1), d_ff=dmodel * 4,
                      vocab_size=vocab, dropout_rate=0.05, dtype="float32",
                      rope_theta=10000.0)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params, "
          f"{steps} steps, global_batch={global_batch}")

    cl = VirtualCluster(cfg, dp=4, pp=2, global_batch=global_batch,
                        num_micro=2, seq_len=seq, seed=0, device=device)
    fail_stop_at = steps // 3
    fail_slow_at = 2 * steps // 3
    recoveries = []
    t0 = time.time()
    for step in range(steps):
        if step == fail_stop_at:
            print(f"-- step {step}: FAIL-STOP injected at rank (dp=2, stage=0)")
            cl.inject_fail_stop(2, 0)
            rec = cl.detect_and_recover()
            recoveries.append(rec)
            print(f"   recovered: MTTR={rec['total']:.3f}s "
                  f"(comm={rec['communicator']:.3f}s remap={rec['remap']:.4f}s "
                  f"migration={rec['migration']:.3f}s) rng_moves={rec['rng_moves']}")
        if step == fail_slow_at:
            print(f"-- step {step}: FAIL-SLOW injected (1.4x) at (dp=0, stage=1)")
            cl.inject_fail_slow(0, 1, 1.4)
            rec = cl.recover_fail_slow(0, 1, 1.4)
            recoveries.append(rec)
            print(f"   rebalanced: migration stall={rec['migration']:.3f}s")
        loss = cl.train_step()
        if step % report_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"step {step:4d}  loss={loss:.4f}  "
                  f"({dt / (step + 1) * 1e3:.0f} ms/step)")
    first, last = cl.losses[0], np.mean(cl.losses[-10:])
    print(f"\nloss {first:.4f} -> {last:.4f} "
          f"({'converging OK' if last < first else 'NOT converging'})")
    print(f"recoveries: {len(cl.recoveries)}; "
          f"final step time (simulated cluster): {cl.simulate_step_time():.3e}s")
    return {"losses": list(cl.losses), "recoveries": recoveries}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dmodel", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--report-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu")
    args = ap.parse_args()
    elastic_train(steps=args.steps, dmodel=args.dmodel, layers=args.layers,
                  vocab=args.vocab, seq=args.seq,
                  global_batch=args.global_batch,
                  report_every=args.report_every, device=args.device)


if __name__ == "__main__":
    main()
