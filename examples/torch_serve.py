"""Batched serving example of the port: continuous-batching generation with
KV caches (or Mamba2 states) on a reduced config of a ported architecture,
on the card by default.

    PYTHONPATH=src python examples/torch_serve.py [--arch codeqwen1p5_7b] \
        [--tokens 32] [--temperature 0.8] [--device cpu]

Thin wrapper over :func:`repro_torch.serving.offline_generate`; the elastic
parts (SLO admission, KV-cache migration across replicas) are exercised by
``tests/test_torch_serving*.py`` and ``chip_smoke.py``'s serving phase.
"""
import argparse

from repro_torch import configs
from repro_torch.launch.serve import add_generation_args, run_smoke


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1p5_7b",
                    choices=configs.ARCH_IDS)
    add_generation_args(ap)
    args = ap.parse_args(argv)
    return run_smoke(args.arch, args)


if __name__ == "__main__":
    main()
