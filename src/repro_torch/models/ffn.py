"""Dense gated FFN (SwiGLU / GeGLU), mirroring ``repro/models/ffn.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def ffn_init(gen: Optional[torch.Generator], d: int, ff: int, dtype):
    return {"w_gate": dense_init(gen, d, ff, dtype),
            "w_up": dense_init(gen, d, ff, dtype),
            "w_down": dense_init(gen, ff, d, dtype)}


def ffn_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``act`` "gelu" is jax.nn.gelu's default, the tanh approximation."""
    gate = x @ p["w_gate"]
    gate = F.gelu(gate, approximate="tanh") if act == "gelu" else F.silu(gate)
    return (gate * (x @ p["w_up"])) @ p["w_down"]
