"""Sharding rules: parameter, cache and batch specs for every architecture,
the port's copy of ``repro/models/partitioning.py``.

Mesh axes: ``("data", "model")`` on one pod, ``("pod", "data", "model")``
across pods.  The design is the reference's:

* batch and activations over DP = ("pod", "data");
* tensor parallelism over "model" (flattened head and ff dims);
* FSDP of params over "data" only, so every per-layer gather stays in a
  pod;
* optimizer state over every DP chip (``zero3``);
* experts over ("pod", "model"), where the node-aware dispatch pays off;
* decode KV caches over "model" on the SEQUENCE dim.

The port runs one program on one card, so nothing is sharded here: the
specs feed the dry run's per-device budgets
(:func:`repro_torch.launch.steps.build_cell`) and the activation records
of :mod:`repro_torch.models.actsharding`.  A spec is a :class:`P`, a
tuple whose entries are None, an axis name or a tuple of names.

Rules are ordered regexes over "/"-joined paths; the first match wins.
They are written for the reference's STACKED layers (a leading layer
axis).  The port keeps one tree a layer (``layers/3/attn/wq``), so a
per-layer leaf is matched in its stacked form (``layers/attn/wq`` with
a leading layer axis) and takes that spec without its first entry,
which the rules never shard.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), None)``;
    ``P()`` replicates.  A one-axis tuple is stored as its axis, as jax's
    ``PartitionSpec`` canonicalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


Rules = List[Tuple[str, P]]


def _axes(multi_pod: bool):
    dp = ("pod", "data") if multi_pod else ("data",)
    fsdp = "data"
    tp = "model"
    ep = ("pod", "model") if multi_pod else ("model",)
    return dp, fsdp, tp, ep


def param_rules(cfg, multi_pod: bool, *, zero3: bool = False) -> Rules:
    """zero3=True returns the optimizer-state variant (fsdp over all DP)."""
    dp, fsdp, tp, ep = _axes(multi_pod)
    # experts already take the pod axis (EP spans pods); their FSDP dim can
    # only take "data": a mesh axis appears once a spec
    efsdp = "data"
    if zero3:
        fsdp = dp
    L = None  # the leading stacked-layer dim is never sharded
    return [
        # embeddings / head: vocab over model
        (r"embed$", P(tp, None)),
        (r"head$", P(None, tp)),
        # MoE: experts over EP axes, FSDP over data on the d_model dim
        (r"moe/router$", P(L, None, None)),
        (r"moe/w_(gate|up)$", P(L, ep, efsdp, None)),
        (r"moe/w_down$", P(L, ep, None, efsdp)),
        (r"moe/shared/w_(gate|up)$", P(L, fsdp, tp)),
        (r"moe/shared/w_down$", P(L, tp, fsdp)),
        # MLA
        (r"attn/wq_a$", P(L, fsdp, None)),
        (r"attn/wq_b$", P(L, fsdp, tp)),
        (r"attn/wkv_a$", P(L, fsdp, None)),
        (r"attn/wkv_b$", P(L, None, tp)),
        (r"attn/(q_norm|k_norm|kv_norm)$", P(L, None)),
        # GQA attention
        (r"attn/w(q|k|v)$", P(L, fsdp, tp)),
        (r"attn/wo$", P(L, tp, fsdp)),
        (r"xattn/w(q|k|v)$", P(L, fsdp, tp)),
        (r"xattn/wo$", P(L, tp, fsdp)),
        # dense FFN
        (r"ffn/w_(gate|up)$", P(L, fsdp, tp)),
        (r"ffn/w_down$", P(L, tp, fsdp)),
        # mamba2
        (r"mamba/in_proj$", P(L, fsdp, tp)),
        (r"mamba/bc_proj$", P(L, fsdp, None)),
        (r"mamba/dt_proj$", P(L, fsdp, None)),
        (r"mamba/conv_w$", P(L, None, tp)),
        (r"mamba/out_proj$", P(L, tp, fsdp)),
        (r"mamba/(dt_bias|a_log|d_skip)$", P(L, None)),
        # rwkv6
        (r"block/w(r|k|v|g)$", P(L, fsdp, tp)),
        (r"block/wo$", P(L, tp, fsdp)),
        (r"block/w_lora_a$", P(L, fsdp, None)),
        (r"block/w_lora_b$", P(L, None, tp)),
        (r"block/c(k|r)$", P(L, fsdp, tp)),
        (r"block/cv$", P(L, tp, fsdp)),
        (r"block/(mix_.|cmix_.|w0|u|ln_x)$", P(L, None)),
        # norms and the rest: replicated
        (r".*", P()),
    ]


def _stacked_form(path: str, shape) -> Tuple[str, Tuple[int, ...], bool]:
    """A per-layer leaf (a path with a layer index) as the reference's
    stacked leaf: the index dropped, a leading layer axis added."""
    parts = path.split("/")
    kept = [p for p in parts if not p.isdigit()]
    if len(kept) == len(parts):
        return path, tuple(shape), False
    return "/".join(kept), (1,) + tuple(shape), True


def _match_stacked(rules: Rules, path: str, shape, axis_sizes) -> P:
    for pat, spec in rules:
        if re.search(pat, path):
            return _guard(_fit(spec, path, len(shape)), shape, axis_sizes)
    return P()


def _match(rules: Rules, path: str, shape, axis_sizes) -> P:
    """The spec of one leaf: the first rule that matches its path, fitted
    to its rank and guarded; a per-layer leaf's is its stacked form's
    without the layer entry."""
    spath, sshape, per_layer = _stacked_form(path, shape)
    spec = _match_stacked(rules, spath, sshape, axis_sizes)
    return P(*spec[1:]) if per_layer else spec


def _guard(spec: P, shape, axis_sizes) -> P:
    """Argument shardings must divide evenly: drop the sharding of any dim
    whose size is not a multiple of its mesh-axes product (whisper's 51865
    vocab, batch-1 long_500k caches, ...)."""
    if axis_sizes is None:
        return spec
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= axis_sizes.get(a, 1)
        out.append(entry if shape[i] % size == 0 else None)
    return P(*out)


def _fit(spec: P, path: str, ndim: int) -> P:
    """A rule spec fitted to the leaf's rank: rules are written for the
    STACKED layout (leading layer dim); an unstacked leaf (zamba's shared
    block, one layer's tree) drops the leading None, a shorter one (norm
    vectors) is replicated."""
    entries = list(spec)
    if len(entries) == ndim:
        return P(*entries)
    if len(entries) - 1 == ndim and (entries[0] is None):
        return P(*entries[1:])
    if len(entries) + 1 == ndim:
        return P(None, *entries)
    return P()


def _is_leaf(x) -> bool:
    return hasattr(x, "shape")


def path_leaves(tree, path: Tuple = ()):
    """``(path string, leaf)`` of every tensor-like leaf (anything with a
    ``.shape``), dict keys sorted, list entries by index, as
    ``jax.tree_util`` orders them; other leaves (a cache's host ``pos``,
    a state's ``step``) are left out."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from path_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from path_leaves(v, path + (str(i),))
    elif _is_leaf(tree):
        yield "/".join(path), tree


def _map_with_path(fn, tree, path: Tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree) if _is_leaf(tree) else None


def tree_specs(tree, rules: Rules, axis_sizes: Optional[Dict[str, int]] = None):
    """A tree of tensors (or anything with a ``.shape``) -> the same tree
    of specs; leaves without a shape map to None."""
    return _map_with_path(lambda path, leaf: _match(rules, path, leaf.shape, axis_sizes),
                          tree)


def param_specs(cfg, params_shape, multi_pod: bool, zero3: bool = False,
                axis_sizes=None):
    return tree_specs(params_shape, param_rules(cfg, multi_pod, zero3=zero3),
                      axis_sizes)


# ---------------------------------------------------------------------------
# batch and cache specs
# ---------------------------------------------------------------------------

def batch_spec(multi_pod: bool) -> P:
    dp, _, _, _ = _axes(multi_pod)
    return P(dp, None)


def frames_spec(multi_pod: bool) -> P:
    dp, _, _, _ = _axes(multi_pod)
    return P(dp, None, None)


def cache_rules(cfg, multi_pod: bool) -> Rules:
    dp, _, tp, _ = _axes(multi_pod)
    return [
        # KV caches [L, B, S, Hkv, dh]: batch over DP, SEQUENCE over model
        (r"layers/(k|v)$", P(None, dp, tp, None, None)),
        (r"shared/(k|v)$", P(None, dp, tp, None, None)),
        (r"x(k|v)$", P(None, dp, tp, None, None)),
        # MLA latent cache [L, B, S, r]
        (r"layers/(c_kv|k_rope)$", P(None, dp, tp, None)),
        (r"dense_layers/(k|v)$", P(None, dp, tp, None, None)),
        (r"dense_layers/(c_kv|k_rope)$", P(None, dp, tp, None)),
        # SSM states: batch over DP, heads over model
        (r"mamba/h$", P(None, dp, tp, None, None)),
        (r"mamba/conv$", P(None, dp, None, tp)),
        (r"state/S$", P(None, dp, tp, None, None)),
        (r"state/last_x(_c)?$", P(None, dp, tp)),
        (r"length$", P(dp)),
        (r".*", P()),
    ]


def cache_specs(cfg, cache_shape, multi_pod: bool, axis_sizes=None):
    return tree_specs(cache_shape, cache_rules(cfg, multi_pod), axis_sizes)


def spec_divisor(spec, axis_sizes: Dict[str, int]) -> int:
    """Chips a leaf of this spec is split over: the product of the sizes
    of every axis it names."""
    div = 1
    for entry in spec or ():
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            div *= axis_sizes.get(a, 1)
    return max(div, 1)


def leaf_specs(tree, spec_tree) -> List[Tuple[str, Any, P]]:
    """``(path, leaf, spec)`` of every leaf of ``tree`` with its spec."""
    specs = dict(path_leaves_specs(spec_tree))
    return [(path, leaf, specs[path]) for path, leaf in path_leaves(tree)]


def path_leaves_specs(spec_tree, path: Tuple = ()):
    """``(path string, spec)`` of every spec of a spec tree."""
    if isinstance(spec_tree, P):
        yield "/".join(path), spec_tree
    elif isinstance(spec_tree, dict):
        for k in sorted(spec_tree):
            yield from path_leaves_specs(spec_tree[k], path + (str(k),))
    elif isinstance(spec_tree, (list, tuple)):
        for i, v in enumerate(spec_tree):
            yield from path_leaves_specs(v, path + (str(i),))
