"""Architecture registry: full configs and reduced smoke variants.

Every architecture of the JAX package's registry.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ("qwen3-14b", "moonshot-v1-16b-a3b", "llama3-8b", "glm4-9b",
            "command-r-35b", "grok-1-314b", "llama4-maverick-400b-a17b",
            "recurrentgemma-2b", "xlstm-125m", "whisper-tiny",
            "llama-3.2-vision-11b")

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}"
                                   ).config()


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family variant (2 layers, narrow widths)."""
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}"
                                   ).smoke_config()
