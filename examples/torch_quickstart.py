"""Quickstart on the PyTorch/CUDA port: train a small model, inject a
failure, watch ElasWave recover within the step — loss trajectory unchanged.

The counterpart of ``examples/quickstart.py`` (the JAX package) on
``repro_torch``.  It runs on the card (the hand-written kernels) unless
``--device cpu`` is given (their plain versions).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""
import argparse

import numpy as np

from repro_torch.core.cluster import VirtualCluster
from repro_torch.models import registry as R


def quickstart(device: str = "cuda", num_layers: int = 8,
               steps: int = 8) -> dict:
    """A fault-free run and an elastic run of ``steps`` steps each (tiny
    dense model, dp 4, pp 2, dropout 0.1), the elastic one losing rank
    (dp 1, stage 1) after ``steps // 2`` steps.  Prints as the reference's
    quickstart does and returns both runs' losses, the recovery record and
    ``max |loss_faultfree - loss_elastic|``."""
    cfg = R.tiny_config("dense", num_layers=num_layers, dropout_rate=0.1)
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.2f}M params)")

    def cluster():
        return VirtualCluster(cfg, dp=4, pp=2, global_batch=16, num_micro=2,
                              seq_len=16, seed=0, device=device)

    print("\n== fault-free run (DP=4, PP=2, ZeRO-1 interleaved) ==")
    base_losses = cluster().run(steps)
    for i, l in enumerate(base_losses):
        print(f"  step {i}: loss={l:.6f}")

    fail_after = steps // 2
    print(f"\n== elastic run: rank (dp=1, stage=1) fails after step "
          f"{fail_after - 1} ==")
    el = cluster()
    losses = el.run(fail_after)
    rec = el.recover_fail_stop(1, 1)
    print(f"  RECOVERY: total={rec['total']:.3f}s "
          f"(detect={rec['detect']:.2f}s plan={rec['plan'] * 1e3:.1f}ms "
          f"communicator={rec['communicator']:.3f}s "
          f"remap={rec['remap'] * 1e3:.3f}ms migration={rec['migration']:.3f}s)")
    losses += el.run(steps - fail_after)
    for i, l in enumerate(losses):
        mark = " <- post-failure" if i >= fail_after else ""
        print(f"  step {i}: loss={l:.6f}{mark}")

    dev = float(np.abs(np.array(base_losses) - np.array(losses)).max())
    print(f"\nmax |loss_faultfree - loss_elastic| = {dev:.2e}")
    print("computation consistency:", "OK" if dev < 1e-4 else "VIOLATED")
    return {"base_losses": base_losses, "losses": losses, "recovery": rec,
            "deviation": dev}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu")
    quickstart(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
