"""Parameters of the JAX package's trees, for the port: the ``init``
trees of its models for the port's (``LM``: dense, MoE, MLA and rwkv6
blocks; ``ZambaModel``; ``WhisperModel``), its AdamW state for
``optim.adamw``, and the ``moe_init`` tree for its MoE layer.

The reference stacks the layers on a leading axis (``layers/attn/wq`` is
``[L, d, H * dh]``); the port keeps one tree per layer.  Arrays arrive as
numpy (``jax.device_get`` of the tree), bfloat16 ones as ml_dtypes
arrays, and leave as CPU tensors of the same dtype.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _map(fn: Callable, t):
    if isinstance(t, dict):
        return {k: _map(fn, v) for k, v in t.items()}
    return fn(t)


def _first_leaf(t):
    while isinstance(t, dict):
        t = t[sorted(t)[0]]
    return t


# the stacked layer groups of the reference's models: LM's (deepseek's
# dense first layer apart), ZambaModel's and WhisperModel's
LAYER_GROUPS = ("dense_layers", "layers", "mamba_layers", "enc_layers", "dec_layers")
# the groups that are one tree, not stacked: zamba's shared block and the
# top-level tensors
PLAIN_GROUPS = ("embed", "final_norm", "head", "shared", "enc_norm")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A reference model's parameter tree (``{"embed", "final_norm",
    ["head"], ["dense_layers"], "layers"}``; zamba's ``{"embed",
    "mamba_layers", "shared", "final_norm"}``; whisper's ``{"embed",
    "enc_layers", "enc_norm", "dec_layers", "final_norm"}``) -> the same
    with each stacked group as a list of one tree per layer, for the port
    model's ``load``; ``shared`` stays one tree.  A layer's ``moe``
    sub-tree goes through ``moe_params_from_jax``; MLA's attention tree is
    a dict like GQA's.  A leaf may itself be a dict of arrays (the int8
    moment codes and their scales): each array is sliced by layer.  Every
    leaf keeps its dtype."""
    unknown = set(tree) - set(LAYER_GROUPS) - set(PLAIN_GROUPS)
    if unknown:
        raise ValueError(f"parameter groups of no model: {sorted(unknown)}")
    out = {k: _map(_tensor, v) for k, v in tree.items() if k not in LAYER_GROUPS}
    for group in LAYER_GROUPS:
        if group in tree:
            out[group] = [_layer(tree[group], i)
                          for i in range(len(_first_leaf(tree[group])))]
    return out


def _layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked block tree."""
    lp = {k: v for k, v in stacked.items() if k != "moe"}
    out = _map(lambda a: _tensor(a[i]), lp)
    if "moe" in stacked:
        out["moe"] = moe_params_from_jax(_map(lambda a: np.asarray(a)[i],
                                              stacked["moe"]))
    return out


def opt_state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's AdamW state (``step``; ``m``, ``v`` and optional
    ``master`` trees stacked over layers, float32 leaves or the int8
    ``{"q", "s"}`` / ``{"q", "lo", "st"}`` dicts) -> the port's: ``step``
    a host int, each tree with one entry per layer.  The int8 blocks run
    along the last axis, so a layer's codes and scales are the slices of
    the stacked ones."""
    out: Dict[str, Any] = {"step": int(np.asarray(state["step"]))}
    for key in ("m", "v", "master"):
        if key in state:
            out[key] = params_from_jax(state[key])
    return out


MOE_KEYS = {"router", "w_gate", "w_up", "w_down", "shared"}


def moe_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's ``moe_init`` tree (``router``, ``w_gate``, ``w_up``,
    ``w_down``, optional ``shared``) -> the port's ``moe_init`` tree, the
    same arrays as CPU tensors."""
    unknown = set(tree) - MOE_KEYS
    if unknown:
        raise ValueError(f"not a moe_init tree: unexpected keys {sorted(unknown)}")
    return _map(_tensor, dict(tree))
