"""Dense gated FFN (SwiGLU), mirroring ``repro/models/ffn.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def ffn_init(gen: torch.Generator, d: int, ff: int, dtype):
    return {"w_gate": dense_init(gen, d, ff, dtype),
            "w_up": dense_init(gen, d, ff, dtype),
            "w_down": dense_init(gen, ff, d, dtype)}


def ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
