"""Model registry of the port: config -> model object, and exact counts."""
from __future__ import annotations

from typing import Any

from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import tree_leaves_with_path


def build_model(cfg: ModelConfig, device: DeviceLike = None, *, mesh: Any = None,
                ep: Any = None) -> LM:
    """The LM on CUDA (``device="cpu"`` to stay on the host), without
    weights until ``.init(seed)`` or ``.load(tree)``: the dense family
    and the MoE family (qwen3-moe; deepseek-v2 with MLA, shared experts
    and a dense first layer).  ``mesh=None`` runs the MoE blocks through
    the local oracle; a ``Topology`` or ``ProcessMesh`` through the
    expert-parallel island (``ep``: its axes, by default pod over model).
    Whisper, zamba and rwkv configs raise ``NotImplementedError`` naming
    the ROADMAP item that ports them."""
    return LM(cfg, device=device, mesh=mesh, ep=ep)


def param_shapes(model: LM) -> Any:
    """The parameter tree as meta tensors: shapes and dtypes, no
    allocation (the model needs no weights)."""
    return model.init_tree(None)


def count_params(model: LM) -> int:
    return sum(t.numel() for _, t in tree_leaves_with_path(param_shapes(model)))


def count_active_params(model: LM) -> int:
    """Active params/token: MoE counts top_k (+shared) experts, not all."""
    cfg = model.cfg
    total = count_params(model)
    if not cfg.is_moe:
        return total
    expert_size = 3 * cfg.d_model * cfg.moe_dff
    n_moe_layers = cfg.n_layers - cfg.first_dense_layers
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * expert_size
    return total - inactive
