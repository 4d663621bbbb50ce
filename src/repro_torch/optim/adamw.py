"""AdamW with cosine schedule, global-norm clipping, and optional 8-bit
moment states (block-quantized, dequant-update-requant).

The port's copy of ``repro/optim/adamw.py``: the same float32 arithmetic,
the same int8 block codecs (blocks along the LAST axis only, so a layer's
state is exactly the slice of the reference's ``[L, ...]`` stacked state,
scales included), fp32 master weights whenever a parameter is of lower
precision.  Weight decay applies to every leaf.

Trees are nested dicts and lists of tensors (``LM.param_tree()``); a
dict's leaves are visited in sorted key order, as ``jax.tree_util``
does.  Where the reference returns new trees, :func:`adamw_update`
updates the parameters, the moments and the masters IN PLACE under
``torch.no_grad()`` (at full width the state is the bulk of the card's
memory: no second copy of it is made) and returns the global gradient
norm.  ``state["step"]`` is a host int.  A leaf of more than
``UPDATE_SLICE`` elements is updated a slice of rows at a time, so the
update's float32 temporaries (about six the size of what is updated at
once) stay small beside the state; the int8 blocks run along the last
axis, so every slice holds whole blocks and the arithmetic is the same.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"     # "float32" | "int8"
    master_fp32: bool = True         # keep fp32 master copies of bf16 params


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves_with_path(tree: Pytree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs: dict keys sorted, list entries by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_at(tree: Pytree, path: Tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# schedule and norm (float32 throughout, as the reference)
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``: the reference's float32 ops in its
    order, on 0-d CPU tensors; returned as the float32 value.  The cosine
    itself is the correctly rounded float32 of the double's: XLA's float32
    cos is within one ulp of it (and so is torch's), but no float32 cos
    of another library reproduces XLA's bits."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + _f32(math.cos(float(math.pi * t))))
    return float(cfg.lr * warm * cos)


def _bias_correction(b: float, step: int) -> float:
    """``1 - b ** step`` in float32, as the reference computes it."""
    return float(1 - torch.pow(_f32(b), _f32(step)))


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum over leaves of their squares, each leaf squared in
    float32 (a 0-d float32 tensor on the leaves' device)."""
    return torch.sqrt(sum(torch.square(leaf.float()).sum()
                          for _, leaf in tree_leaves_with_path(tree)))


# ---------------------------------------------------------------------------
# 8-bit block quantization for moment states: blocks run along the LAST
# axis only and the array shape is preserved (the reference's layout)
# ---------------------------------------------------------------------------

SHARD_HINT = 16   # the reference's mesh width: blocks tile 1/16 shards


@functools.lru_cache(maxsize=None)
def _block_of(n: int) -> int:
    """Largest block <= 4096 dividing n whose block COUNT is a multiple of
    SHARD_HINT (e.g. llama head 128256 -> b=501, nb=256)."""
    best = 0
    for b in range(1, min(n, 4096) + 1):
        if n % b == 0 and (n // b) % SHARD_HINT == 0:
            best = b
    if best:
        return best
    for b in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if n % b == 0:
            return b
    return 1


def _scale_shape(shape) -> tuple:
    if not shape:
        return (1,)
    b = _block_of(shape[-1])
    return tuple(shape[:-1]) + (shape[-1] // b,)


def _q8_zeros(shape, device) -> Dict[str, torch.Tensor]:
    return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
            "s": torch.zeros(_scale_shape(shape), dtype=torch.float32, device=device)}


def _blocks(x: torch.Tensor, nb: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], nb, x.shape[-1] // nb)


def _q8_dequant(st: Dict[str, torch.Tensor]) -> torch.Tensor:
    q = st["q"]
    if not q.shape:
        return q.float() * st["s"][0]
    return (_blocks(q.float(), st["s"].shape[-1]) * st["s"][..., None]).reshape(q.shape)


def _q8_quant(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    xf = x.float()
    if not x.shape:
        s = torch.clamp(xf.abs(), min=1e-30) / 127.0
        return {"q": torch.round(xf / s).to(torch.int8), "s": s[None]}
    nb = x.shape[-1] // _block_of(x.shape[-1])
    blocks = _blocks(xf, nb)
    scale = torch.clamp(blocks.abs().amax(dim=-1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return {"q": q.reshape(x.shape).to(torch.int8), "s": scale}


# v (second moment) needs ~10 orders of dynamic range: linear absmax
# quantization collapses small entries to 0 and m/(sqrt(0)+eps) explodes.
# Quantize v in the LOG domain (per-block min/step), the int8-Adam trick.
_LOG_FLOOR = -46.0   # log(1e-20)
# jnp.exp(_LOG_FLOOR) is float32's exp of -46, not Python's double: the
# log-domain codes move by one if the floor is the double
_FLOOR = float(np.exp(np.float32(_LOG_FLOOR)))
_ZERO_BELOW = float(np.float32(_FLOOR) * np.float32(1.5))


def _q8l_zeros(shape, device) -> Dict[str, torch.Tensor]:
    ss = _scale_shape(shape)
    return {"q": torch.full(shape, -127, dtype=torch.int8, device=device),
            "lo": torch.full(ss, _LOG_FLOOR, dtype=torch.float32, device=device),
            "st": torch.zeros(ss, dtype=torch.float32, device=device)}


def _q8l_dequant(st: Dict[str, torch.Tensor]) -> torch.Tensor:
    q = st["q"]
    if not q.shape:
        v = torch.exp(st["lo"][0] + (q.float() + 127.0) * st["st"][0])
    else:
        qf = _blocks(q.float(), st["lo"].shape[-1]) + 127.0
        v = torch.exp(st["lo"][..., None] + qf * st["st"][..., None]).reshape(q.shape)
    return torch.where(v <= _ZERO_BELOW, 0.0, v)


def _q8l_quant(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    xl = torch.log(torch.clamp(x.float(), min=_FLOOR))
    if not x.shape:
        return {"q": torch.full((), -127, dtype=torch.int8, device=x.device),
                "lo": xl[None], "st": torch.zeros((1,), device=x.device)}
    nb = x.shape[-1] // _block_of(x.shape[-1])
    blocks = _blocks(xl, nb)
    lo = blocks.amin(dim=-1)
    stp = torch.clamp((blocks.amax(dim=-1) - lo) / 254.0, min=1e-12)
    q = torch.clamp(torch.round((blocks - lo[..., None]) / stp[..., None]) - 127,
                    -127, 127)
    return {"q": q.reshape(x.shape).to(torch.int8), "lo": lo, "st": stp}


def _store(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    for k, t in src.items():
        dst[k].copy_(t)


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------

def adamw_init(params: Pytree, cfg: AdamWConfig) -> Dict:
    """Zero moments (float32, or int8 codes with their block scales) on
    each parameter's device, and float32 masters when any parameter is of
    lower precision and ``cfg.master_fp32``."""
    if cfg.state_dtype == "int8":
        m_zeros = lambda p: _q8_zeros(p.shape, p.device)  # noqa: E731
        v_zeros = lambda p: _q8l_zeros(p.shape, p.device)  # noqa: E731
    else:
        m_zeros = v_zeros = lambda p: torch.zeros(  # noqa: E731
            p.shape, dtype=torch.float32, device=p.device)
    state = {"step": 0, "m": tree_map(m_zeros, params),
             "v": tree_map(v_zeros, params)}
    if cfg.master_fp32 and any(p.dtype != torch.float32
                               for _, p in tree_leaves_with_path(params)):
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


# elements of a leaf updated at once (a slice of its leading axis)
UPDATE_SLICE = 1 << 27


def _update_slices(shape) -> list:
    """Slices of a leaf's leading axis of at most ``UPDATE_SLICE``
    elements; the whole leaf (``...``) when it is small or 1-D."""
    n = math.prod(shape)
    if len(shape) < 2 or n <= UPDATE_SLICE:
        return [...]
    rows = max(1, UPDATE_SLICE // (n // shape[0]))
    return [slice(i, i + rows) for i in range(0, shape[0], rows)]


@torch.no_grad()
def adamw_update(grads: Pytree, params: Pytree, state: Dict,
                 cfg: AdamWConfig) -> torch.Tensor:
    """One AdamW step: ``params``, the moments and the masters of ``state``
    are updated in place and ``state["step"]`` advances; returns the
    global norm of ``grads`` (before clipping, a 0-d float32 tensor)."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    # a true division (a Python float over a tensor would take the
    # reciprocal first and round twice)
    scale = torch.clamp(torch.div(torch.full_like(gnorm, cfg.clip_norm),
                                  torch.clamp(gnorm, min=1e-9)), max=1.0)
    bc1, bc2 = _bias_correction(cfg.b1, step), _bias_correction(cfg.b2, step)
    q8 = cfg.state_dtype == "int8"
    masters = state.get("master")
    for path, p in tree_leaves_with_path(params):
        m_all, v_all = tree_at(state["m"], path), tree_at(state["v"], path)
        g_all = tree_at(grads, path)
        for sl in _update_slices(p.shape):
            g = g_all[sl].to(torch.float32, copy=True).mul_(scale)
            m_st = {k: t[sl] for k, t in m_all.items()} if q8 else m_all[sl]
            v_st = {k: t[sl] for k, t in v_all.items()} if q8 else v_all[sl]
            m = _q8_dequant(m_st) if q8 else m_st
            v = _q8l_dequant(v_st) if q8 else v_st
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            del g
            upd = torch.div(v, bc2).sqrt_().add_(cfg.eps)
            upd = torch.div(m, bc1).div_(upd)
            dst = p.data[sl]
            base = tree_at(masters, path)[sl] if masters is not None else (
                dst if p.dtype == torch.float32 else dst.float())
            upd.add_(base, alpha=cfg.weight_decay)
            base.add_(upd, alpha=-lr)
            del upd
            if base is not dst:
                dst.copy_(base)
            if q8:
                _store(m_st, _q8_quant(m))
                _store(v_st, _q8l_quant(v))
    state["step"] = step
    return gnorm
