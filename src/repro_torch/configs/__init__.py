"""Published model configs the port runs.  ``get_config(arch_id)`` returns
the exact published config; ``get_smoke_config(arch_id)`` a reduced
same-family config for CPU smoke runs.  The reference's other six
architectures (``repro.configs.ARCH_IDS``) wait for the slices that port
what they need, and their ids raise: deepseek-v3-671b waits for MLA (its
latent attention); llama3-405b, deepseek-67b and nemotron-4-15b, whose
dense blocks the port already runs, for the slice that adds their configs
and card checks; internvl2-76b for the VLM front end (prefix embeddings);
whisper-base for the enc-dec model."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "mamba2_2p7b",
    "codeqwen1p5_7b",
    "llama4_scout_17b_a16e",
    "jamba_1p5_large_398b",
]

_ALIASES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "codeqwen1.5-7b": "codeqwen1p5_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
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
