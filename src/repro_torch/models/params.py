"""Weights as a tree of modules: the parameter trees of the reference
(nested dicts, the stacked layers as lists of one tree a layer) held by
an ``nn.Module``, and the drawing, loading and reading-back every model
of the port shares.

    ParamTree(tree)       a dict of tensors as a module (leaves are
                          ``nn.Parameter``s, dicts sub-modules)
    TreeModel             the base of ``LM``, ``ZambaModel`` and
                          ``WhisperModel``: ``init(seed)``, ``load(tree)``,
                          ``param_tree()``; a subclass gives
                          ``init_tree(gen)``
"""
from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: leaves are ``nn.Parameter``s,
    dicts are sub-trees, read as ``p["wq"]`` or ``p.attn``; ``tree()``
    gives the dict back (of the parameters themselves).  A layer is one:
    ``norm*`` tensors and the ``attn`` and ``ffn`` or ``moe`` sub-trees
    keyed as in the reference (``p.attn["wq"]``, ``p.moe["shared"]["w_up"]``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                self.add_module(name, ParamTree(t))
            else:
                self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        out.update((name, m.tree()) for name, m in self._modules.items())
        return out


def _cast_like(tree, like, device, copy: bool):
    """``tree`` on ``device``, each leaf in the dtype of its counterpart in
    ``like`` (the model's own meta tree: the reference's dtypes, float32
    leaves of a bf16 model included)."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"parameter tree {got} where the model has {sorted(like)}")
        return {k: _cast_like(tree[k], like[k], device, copy) for k in like}
    if isinstance(like, list):
        if not isinstance(tree, list) or len(tree) != len(like):
            got = len(tree) if isinstance(tree, list) else type(tree).__name__
            raise ValueError(f"{got} layers for a config of {len(like)}")
        return [_cast_like(t, w, device, copy) for t, w in zip(tree, like)]
    if tuple(tree.shape) != tuple(like.shape):
        raise ValueError(f"a leaf of shape {tuple(tree.shape)} where the model has "
                         f"{tuple(like.shape)}")
    return tree.to(device=device, dtype=like.dtype, copy=copy)


class TreeModel(nn.Module, abc.ABC):
    """A model on one device (CUDA unless ``device="cpu"``) whose weights
    are the reference's parameter tree: each top-level tensor a parameter
    of the model, each dict a ``ParamTree`` and each list of layer trees
    an ``nn.ModuleList`` of them, under the tree's own keys.

    What the train step asks of a model (``launch.steps``): ``cfg``,
    ``param_tree()``, ``loss(batch)`` and ``mesh`` / ``ep``, which are
    None here (no expert-parallel island); ``LM`` sets them for its MoE
    blocks."""

    mesh: Any = None
    ep: Any = None

    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._tree_names: List[str] = []      # the tree's keys, in init_tree's order

    @abc.abstractmethod
    def init_tree(self, gen: Optional[torch.Generator]) -> Dict[str, Any]:
        """A parameter tree drawn from ``gen`` in the reference's order, on
        the generator's device; with no generator, meta tensors of the same
        shapes and dtypes (``registry.param_shapes``)."""

    def init(self, seed: Union[int, torch.Generator] = 0) -> "TreeModel":
        """Random weights drawn on the model's device; a Generator or a
        seed for one."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(seed)
        return self._set(self.init_tree(gen), copy=False)

    def load(self, tree: Dict[str, Any]) -> "TreeModel":
        """Take a parameter tree of the model's structure, copied to the
        model's device and to each leaf's dtype as ``init_tree`` draws it
        (the MoE router, rwkv's ``w0`` and ``u`` and Mamba2's ``dt_bias``,
        ``a_log`` and ``d_skip`` stay float32 in a bf16 model; training
        updates the weights in place; the caller's tree stays as it was)."""
        return self._set(tree, copy=True)

    def _set(self, tree: Dict[str, Any], copy: bool) -> "TreeModel":
        tree = _cast_like(tree, self.init_tree(None), self.device, copy)
        self._tree_names = list(tree)
        for name, t in tree.items():
            if isinstance(t, list):
                setattr(self, name, nn.ModuleList(ParamTree(lp) for lp in t))
            elif isinstance(t, dict):
                setattr(self, name, ParamTree(t))
            else:
                self.register_parameter(name, nn.Parameter(t))
        return self

    def param_tree(self) -> Dict[str, Any]:
        """The weights (``nn.Parameter``s, trainable) as the reference's
        tree with the layers as lists, in ``init_tree``'s order: what
        ``optim.adamw`` and the checkpoints walk."""
        out: Dict[str, Any] = {}
        for name in self._tree_names:
            t = getattr(self, name)
            out[name] = ([lp.tree() for lp in t] if isinstance(t, nn.ModuleList)
                         else t.tree() if isinstance(t, ParamTree) else t)
        return out
