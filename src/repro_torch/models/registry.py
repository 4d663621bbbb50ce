"""Model registry of the port: config -> model object (family dispatch),
and exact counts."""
from __future__ import annotations

from typing import Any

from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import TreeModel
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.zamba import ZambaModel
from repro_torch.optim.adamw import tree_leaves_with_path


def build_model(cfg: ModelConfig, device: DeviceLike = None, *, mesh: Any = None,
                ep: Any = None, shard_mesh: Any = None) -> TreeModel:
    """The model of ``cfg``'s family on CUDA (``device="cpu"`` to stay on
    the host), without weights until ``.init(seed)`` or ``.load(tree)``,
    as the reference's ``build_model`` dispatches: the encoder-decoder
    family -> ``WhisperModel``, the hybrid -> ``ZambaModel``, else ``LM``
    (the dense and MoE families and rwkv6).  ``mesh=None`` runs the MoE
    blocks through the local oracle; a ``Topology`` or ``ProcessMesh``
    through the expert-parallel island (``ep``: its axes, by default pod
    over model).  ``shard_mesh`` (every family; a production mesh by
    shape, :func:`repro_torch.launch.mesh.make_production_mesh`) is the
    reference's sharding mesh: it names the activation specs the model
    reports while a counter is active, and changes no computation.
    ``device="meta"`` builds a model of meta tensors (no memory) for the
    dry run's counts."""
    if cfg.is_encoder_decoder or cfg.family == "hybrid":
        if mesh is not None or ep is not None:
            raise ValueError(f"{cfg.name}: mesh= and ep= are for the MoE family "
                             f"(its island); the sharding mesh is shard_mesh=")
        return (WhisperModel if cfg.is_encoder_decoder else ZambaModel)(
            cfg, device, shard_mesh=shard_mesh)
    return LM(cfg, device=device, mesh=mesh, ep=ep, shard_mesh=shard_mesh)


def param_shapes(model: TreeModel) -> Any:
    """The parameter tree as meta tensors: shapes and dtypes, no
    allocation (the model needs no weights)."""
    return model.init_tree(None)


def count_params(model: TreeModel) -> int:
    return sum(t.numel() for _, t in tree_leaves_with_path(param_shapes(model)))


def count_active_params(model: TreeModel) -> int:
    """Active params/token: MoE counts top_k (+shared) experts, not all."""
    cfg = model.cfg
    total = count_params(model)
    if not cfg.is_moe:
        return total
    expert_size = 3 * cfg.d_model * cfg.moe_dff
    n_moe_layers = cfg.n_layers - cfg.first_dense_layers
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * expert_size
    return total - inactive
