"""Shared building blocks of the port's models: norms, RoPE, decode
attention's plain version, the output head, initialisers.

Functions on tensors, mirroring ``repro/models/common.py``.  Initialisers
draw from an explicit ``torch.Generator`` on the device they fill.
``blocked_attention`` and ``chunked_xent`` wait for the prefill and
training slices.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.decode_attn.ref import decode_attention_ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32 accumulation; gemma2 stores (w - 1) => scale (1 + w)."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (xf * inv * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Frequencies in float64 on the host, then float32 on the device, as
    the reference computes them (float32 from the start drifts at long
    positions)."""
    return torch.from_numpy(rope_frequencies(dim, theta).astype(np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, dim]; positions: [..., seq] (broadcastable)."""
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    angles = positions[..., None].float() * freqs          # [..., seq, dim/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# decode attention (plain version) and the head
# ---------------------------------------------------------------------------

def cache_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length: torch.Tensor, *,
                           softcap: float = 0.0,
                           window: Optional[int] = None) -> torch.Tensor:
    """One-token decode attention over a padded cache (plain path).

    q: [B, 1, Hkv, G, Dh]; caches [B, S, Hkv, Dh]; length [B] current count
    (the new token is at index length-1); ``window`` keeps positions
    ``>= length - window``.  The CUDA kernel behind
    ``kernels.decode_attn.decode_attention_grouped`` computes the same
    function, reading the caches in place.
    """
    b, _, hkv, g, dh = q.shape
    out = decode_attention_ref(q.reshape(b, hkv, g, dh), k_cache.transpose(1, 2),
                               v_cache.transpose(1, 2), length,
                               scale=1.0 / math.sqrt(dh), softcap=softcap,
                               window=window or 0)
    return out.reshape(q.shape).to(q.dtype)


def head_logits(x: torch.Tensor, head: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ head).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
