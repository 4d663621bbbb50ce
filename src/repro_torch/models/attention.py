"""GQA attention (+ sliding window / softcap / qk-norm): the full
sequence (training, prefill) and one token against a cache (decoding).

Functions on tensors, mirroring ``repro/models/attention.py``: weights
``[d_in, d_out]`` used as ``x @ w``, caches ``[B, S, Hkv, D]``.  MLA
waits for its slice (ROADMAP Queue 1 item 7d).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attn.kernel import decode_attention_grouped
from repro_torch.models.common import (apply_rope, blocked_attention,
                                       dense_init, init_device, rms_norm)


def gqa_init(gen: Optional[torch.Generator], cfg, dtype) -> Dict[str, torch.Tensor]:
    d, dh = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * dh, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dtype),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=init_device(gen))
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=init_device(gen))
    return p


def _project_qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x [B, S, d] -> q [B, S, Hkv, G, dh], k and v [B, S, Hkv, dh]."""
    b, s, _ = x.shape
    dh, hkv = cfg.head_dim, cfg.n_kv_heads
    g = cfg.n_heads // hkv
    q = (x @ p["wq"]).reshape(b, s, hkv, g, dh)
    k = (x @ p["wk"]).reshape(b, s, hkv, dh)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q.reshape(b, s, hkv * g, dh), positions,
                   cfg.rope_theta).reshape(b, s, hkv, g, dh)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(p, cfg, x: torch.Tensor, *, window: Optional[int] = None,
               causal: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention and the k, v it attended over:
    x [B, S, d] -> (out [B, S, d], k and v [B, S, Hkv, dh])."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = blocked_attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_softcap, block_q=cfg.attn_block_q,
                            block_kv=cfg.attn_block_kv)
    return out.reshape(b, s, -1) @ p["wo"], k, v


def gqa_apply(p, cfg, x: torch.Tensor, *, window: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill): x [B, S, d] -> [B, S, d]."""
    return gqa_attend(p, cfg, x, window=window, causal=causal)[0]


def gqa_init_cache(cfg, batch: int, max_seq: int, dtype, device) -> Dict[str, torch.Tensor]:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               length: torch.Tensor, *, pos: int, window: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, 1, d]; cache k/v [B, S, Hkv, dh]; length [B] tokens already
    stored (the new token lands at index ``length``).

    Decode steps are aligned across the batch, so ``pos`` is the host's
    copy of ``length[0]``: the new k/v are written into the preallocated
    cache IN PLACE at slot ``pos`` (slice assignment; the reference returns
    a new cache), and the returned cache is the same tensors.  Raises when
    the cache is full (``pos >= S``), where the reference's
    ``dynamic_update_slice`` would clamp silently.  Attention goes through
    ``decode_attention_grouped``: the CUDA kernel for CUDA tensors, its
    plain version for CPU ones.
    """
    b = x.shape[0]
    max_seq = cache["k"].shape[1]
    if not 0 <= pos < max_seq:
        raise ValueError(f"KV cache full: slot {pos} of a cache of {max_seq}")
    q, k, v = _project_qkv(p, cfg, x, length[:, None])
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    _, _, hkv, g, dh = q.shape
    out = decode_attention_grouped(
        q.reshape(b, hkv, g, dh), cache["k"].transpose(1, 2),
        cache["v"].transpose(1, 2), length + 1, scale=1.0 / math.sqrt(dh),
        softcap=cfg.attn_softcap, window=window or 0)
    return out.to(x.dtype).reshape(b, 1, -1) @ p["wo"], cache
