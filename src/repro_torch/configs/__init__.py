"""Architecture registry of the port: ``get_config(name)``, ``get_reduced``.

The port carries the dense GQA configs and the two MoE ones,
qwen3-moe-235b-a22b and deepseek-v2-236b (MLA attention, shared experts,
a dense first layer): the families its ``LM`` runs.  Every other
architecture of the JAX package resolves by name and raises
``NotImplementedError`` naming the ROADMAP item that ports its family;
``all_arch_ids`` lists them all, and ``shapes`` holds the input-shape
grid.
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

PORTED = ("gemma2_2b", "gemma2_9b", "gemma2_27b", "llama3_405b",
          "chameleon_34b", "qwen3_moe_235b_a22b", "deepseek_v2_236b")

WAITING: Dict[str, str] = {
    "whisper_small": "the encoder-decoder family (ROADMAP Queue 1 item 7e)",
    "zamba2_2p7b": "the hybrid SSM family (ROADMAP Queue 1 item 7f)",
    "rwkv6_3b": "the RWKV SSM family (ROADMAP Queue 1 item 7g)",
}


def _module(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod in WAITING:
        raise NotImplementedError(f"{name}: not ported yet; it needs {WAITING[mod]}")
    if mod not in PORTED:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_arch_ids() -> List[str]:
    return list(ALIASES.keys())
