"""Activation sharding specs: the port's counterpart of
``repro/models/actsharding.py``.

The reference pins activations with ``with_sharding_constraint`` at block
boundaries (batch over DP, the residual stream's sequence over "model",
attention heads over "model", logits' vocab over "model"), so that GSPMD
runs the intended data- and tensor-parallel program.  The port runs one
program on one card and shards nothing.  It keeps the same choices as
pure functions of a shape, the mesh's axis sizes, ``multi_pod`` and the
config (:func:`hidden_spec` ... :func:`params_specs`), and the
:class:`ActShard` mixin that ``LM``, ``ZambaModel`` and ``WhisperModel``
call at the reference's sites, in its order.  Each method returns its
input unchanged; with a production mesh (``shard_mesh``) and a counter of
:mod:`repro_torch.core.op_analysis` active, it also reports the site, the
shape, the spec and the bytes a device would hold.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core import op_analysis
from repro_torch.models.partitioning import (P, param_rules, path_leaves,
                                             path_leaves_specs, spec_divisor,
                                             tree_specs)


def dp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _dp(batch: int, axis_sizes: Dict[str, int], multi_pod: bool):
    """The DP axes when the batch divides over them, else None."""
    size = axis_sizes.get("data", 1) * axis_sizes.get("pod", 1)
    return dp_axes(multi_pod) if batch % size == 0 else None


def hidden_spec(shape, axis_sizes, multi_pod: bool, cfg) -> P:
    """[B, S, d]: batch over DP, SEQUENCE over model (sequence-parallel
    residuals) when ``cfg.sp_residuals`` and S divides."""
    tp = None
    if getattr(cfg, "sp_residuals", True) and shape[1] % axis_sizes.get("model", 1) == 0:
        tp = "model"
    return P(_dp(shape[0], axis_sizes, multi_pod), tp, None)


def logits_spec(shape, axis_sizes, multi_pod: bool, cfg) -> P:
    """[..., V]: vocab over model, batch over DP."""
    rest = (None,) * (len(shape) - 2)
    return P(_dp(shape[0], axis_sizes, multi_pod), *rest, "model")


def full_hidden_spec(shape, axis_sizes, multi_pod: bool, cfg) -> P:
    """[B, S, d] gathered to the full sequence before a block's matmuls."""
    return P(_dp(shape[0], axis_sizes, multi_pod), None, None)


def qkv_specs(q_shape, axis_sizes, multi_pod: bool, cfg) -> Tuple[P, P]:
    """(q's spec, k's and v's): q [B, S, Hkv, G, dh] heads over model, on
    Hkv if it divides, else on G; k / v [B, S, Hkv, dh] on Hkv or
    replicated."""
    ms = axis_sizes.get("model", 1)
    dp = _dp(q_shape[0], axis_sizes, multi_pod)
    hkv, g = q_shape[2], q_shape[3]
    if hkv % ms == 0:
        qspec = P(dp, None, "model", None, None)
    elif g % ms == 0:
        qspec = P(dp, None, None, "model", None)
    else:
        qspec = P(dp, None, None, None, None)
    kspec = P(dp, None, "model" if hkv % ms == 0 else None, None)
    return qspec, kspec


def kv_spec(shape, axis_sizes, multi_pod: bool, cfg) -> P:
    """A layer's cache [B, S, Hkv, dh] (or [B, S, r]): seq over model."""
    rest = (None,) * (len(shape) - 3)
    return P(_dp(shape[0], axis_sizes, multi_pod), "model", None, *rest)


def params_specs(layer_tree, axis_sizes, multi_pod: bool, cfg):
    """One layer's weights (a per-layer tree, unstacked) -> their specs."""
    return tree_specs(layer_tree, param_rules(cfg, multi_pod), axis_sizes)


def per_device_bytes(shape, itemsize: int, spec, axis_sizes) -> float:
    n = 1
    for s in shape:
        n *= int(s)
    return n * itemsize / spec_divisor(spec, axis_sizes)


class ActShard:
    """Mixin: a model carries ``shard_mesh`` (a production mesh by shape,
    :class:`repro_torch.launch.mesh.ProductionMesh`, or None) and reports
    its activation specs while a counter is active.  Every method returns
    its input unchanged."""
    shard_mesh = None

    @property
    def multi_pod(self) -> bool:
        return self.shard_mesh is not None and "pod" in self.shard_mesh.shape

    def _reporting(self) -> bool:
        return self.shard_mesh is not None and op_analysis.active()

    def _axis_sizes(self) -> Dict[str, int]:
        return dict(self.shard_mesh.shape)

    def _cs(self, site: str, x, spec: P):
        op_analysis.note_activation(
            site, x.shape, spec,
            per_device_bytes(x.shape, x.element_size(), spec, self._axis_sizes()))
        return x

    def _spec(self, fn, x):
        return fn(tuple(x.shape), self._axis_sizes(), self.multi_pod, self.cfg)

    def cs_hidden(self, x):
        if self._reporting():
            self._cs("hidden", x, self._spec(hidden_spec, x))
        return x

    def cs_logits(self, x):
        if self._reporting():
            self._cs("logits", x, self._spec(logits_spec, x))
        return x

    def cs_full_hidden(self, x):
        if self._reporting():
            self._cs("full_hidden", x, self._spec(full_hidden_spec, x))
        return x

    def cs_qkv(self, q, k, v):
        if self._reporting():
            qspec, kspec = self._spec(qkv_specs, q)
            self._cs("q", q, qspec)
            self._cs("k", k, kspec)
            self._cs("v", v, kspec)
        return q, k, v

    def cs_kv(self, x):
        if self._reporting():
            self._cs("kv", x, self._spec(kv_spec, x))
        return x

    def cs_params(self, lp):
        """One layer's weights (a ``ParamTree`` or a dict), each leaf in
        ``jax.tree_util``'s order."""
        if self._reporting():
            tree = lp.tree() if hasattr(lp, "tree") else lp
            specs = dict(path_leaves_specs(params_specs(
                tree, self._axis_sizes(), self.multi_pod, self.cfg)))
            for path, leaf in path_leaves(tree):
                self._cs("params", leaf, specs[path])
        return lp
