"""Mixture-of-Experts layer: parameters and the local oracle over the
dispatch of :mod:`repro_torch.moe`.

Mirrors ``repro/models/moe.py``:

* :func:`moe_init`: the router, the expert FFNs and the optional shared
  experts, drawn from an explicit ``torch.Generator`` on its device;
* :func:`moe_apply_local`: the single-device dense-masked reference,
  the oracle of the distributed island;
* the island's names (:class:`EPInfo`, :func:`moe_apply_sharded` and its
  pieces), re-exported from :mod:`repro_torch.moe.dispatch`.

``models.convert.moe_params_from_jax`` turns the reference's ``moe_init``
tree into this one, so both packages compute on the same weights.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import dense_init
from repro_torch.moe.dispatch import (EPInfo, _expert_compute,  # noqa: F401
                                      _fifo_slots, _moe_island, _router,
                                      _shared_ffn, moe_apply_sharded)

__all__ = ["EPInfo", "moe_init", "moe_apply_local", "moe_apply_sharded"]


def moe_init(gen: Union[None, int, torch.Generator], cfg, dtype,
             device: DeviceLike = None) -> Dict:
    """``{"router" [d, E] float32, "w_gate" / "w_up" [E, d, ff], "w_down"
    [E, ff, d], optional "shared"}`` in ``dtype``, drawn in the reference's
    order from ``gen`` (a Generator, whose device they fill, or a seed for
    one on ``device``: CUDA unless ``"cpu"``); ``None`` gives meta
    tensors of the same shapes (``registry.param_shapes``)."""
    if gen is not None and not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(gen)
    d, ff, E = cfg.d_model, cfg.moe_dff, cfg.n_experts
    p = {
        "router": dense_init(gen, d, E, torch.float32),
        "w_gate": _expert_init(gen, E, d, ff, dtype),
        "w_up": _expert_init(gen, E, d, ff, dtype),
        "w_down": _expert_init(gen, E, ff, d, dtype),
    }
    if cfg.n_shared_experts:
        ffs = ff * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, d, ffs, dtype),
                       "w_up": dense_init(gen, d, ffs, dtype),
                       "w_down": dense_init(gen, ffs, d, dtype)}
    return p


def _expert_init(gen: Optional[torch.Generator], E: int, d_in: int, d_out: int,
                 dtype) -> torch.Tensor:
    if gen is None:
        return torch.empty((E, d_in, d_out), dtype=dtype, device="meta")
    w = torch.randn((E, d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def moe_apply_local(p: Dict, cfg, x: torch.Tensor,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """Dense-masked reference: every expert on every token, then masked
    by the router's gates; O(E / top_k) extra flops, an oracle only.
    ``chunk`` bounds the tokens computed at once (the result does not
    depend on it: each token is computed alone)."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    step = T if chunk is None else chunk
    out = torch.empty_like(x2)
    for t0 in range(0, T, step):
        xc = x2[t0:t0 + step]
        w, ids = _router(p, cfg, xc)
        gate = torch.zeros((xc.shape[0], cfg.n_experts), dtype=torch.float32,
                           device=x.device)
        gate.scatter_add_(1, ids, w)
        h = torch.einsum("td,edf->tef", xc, p["w_gate"])
        u = torch.einsum("td,edf->tef", xc, p["w_up"])
        y = torch.einsum("tef,efd->ted", F.silu(h) * u, p["w_down"])
        o = torch.einsum("ted,te->td", y.float(), gate).to(x.dtype)
        if cfg.n_shared_experts:
            o = o + _shared_ffn(p, xc)
        out[t0:t0 + step] = o
    return out.reshape(B, S, d)
