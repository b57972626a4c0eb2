"""Published model configs the port runs.  ``get_config(arch_id)`` returns
the exact published config; ``get_smoke_config(arch_id)`` a reduced
same-family config for CPU smoke runs.  The reference's other eight
architectures (``repro.configs.ARCH_IDS``) wait for the slices that port
their blocks, and their ids raise."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "mamba2_2p7b",
    "codeqwen1p5_7b",
]

_ALIASES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "codeqwen1.5-7b": "codeqwen1p5_7b",
}


def _module(arch_id: str):
    name = _ALIASES.get(arch_id, arch_id)
    if name not in ARCH_IDS:
        raise KeyError(f"{arch_id!r} is not a config of the port (ported: "
                       f"{', '.join(ARCH_IDS)})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
