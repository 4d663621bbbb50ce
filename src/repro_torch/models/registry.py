"""Model registry of the port: config -> model object, and counts."""
from __future__ import annotations

from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> LM:
    """The dense LM on CUDA (``device="cpu"`` to stay on the host), without
    weights until ``.init(seed)`` or ``.load(tree)``.  Whisper, zamba,
    rwkv, MoE and MLA configs raise ``NotImplementedError`` naming the
    ROADMAP item that ports them."""
    return LM(cfg, device=device)


def count_params(model: LM) -> int:
    return sum(p.numel() for p in model.parameters())
