"""Architecture registry of the port: ``get_config(name)``, ``get_reduced``.

The port carries every architecture of the JAX package: the dense GQA
configs, the two MoE ones (qwen3-moe-235b-a22b; deepseek-v2-236b with
MLA attention, shared experts and a dense first layer), whisper-small
(encoder-decoder), zamba2-2.7b (Mamba2 + a shared attention block) and
rwkv6-3b (RWKV6).  ``all_arch_ids`` lists them, and ``shapes`` holds the
input-shape grid.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

# canonical dashed ids -> module names (the JAX package's table)
ALIASES: Dict[str, str] = {
    "gemma2-2b": "gemma2_2b", "llama3-405b": "llama3_405b",
    "gemma2-27b": "gemma2_27b", "gemma2-9b": "gemma2_9b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v2-236b": "deepseek_v2_236b", "whisper-small": "whisper_small",
    "chameleon-34b": "chameleon_34b", "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-3b": "rwkv6_3b",
}


def _module(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod not in ALIASES.values():
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_arch_ids() -> List[str]:
    return list(ALIASES.keys())
