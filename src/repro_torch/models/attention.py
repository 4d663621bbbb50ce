"""Attention modules: GQA (+ sliding window / softcap / qk-norm) and
MLA (deepseek-v2's compressed KV with a decoupled RoPE key), each over
the full sequence (training, prefill) and one token against a cache
(decoding).

Functions on tensors, mirroring ``repro/models/attention.py``: weights
``[d_in, d_out]`` used as ``x @ w``; GQA caches ``[B, S, Hkv, D]``, MLA
caches the latent ``c_kv [B, S, r_kv]`` and ``k_rope [B, S, rope]``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attn.kernel import decode_attention_grouped
from repro_torch.models.common import (NEG, apply_rope, blocked_attention,
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
               causal: bool = True, cs_qkv=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention and the k, v it attended over:
    x [B, S, d] -> (out [B, S, d], k and v [B, S, Hkv, dh]).  ``cs_qkv``
    (a model's activation specs) sees q, k, v before the attention."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    if cs_qkv is not None:
        q, k, v = cs_qkv(q, k, v)
    out = blocked_attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_softcap, block_q=cfg.attn_block_q,
                            block_kv=cfg.attn_block_kv)
    return out.reshape(b, s, -1) @ p["wo"], k, v


def gqa_apply(p, cfg, x: torch.Tensor, *, window: Optional[int] = None,
              causal: bool = True, cs_qkv=None) -> torch.Tensor:
    """Full-sequence attention (training / prefill): x [B, S, d] -> [B, S, d]."""
    return gqa_attend(p, cfg, x, window=window, causal=causal, cs_qkv=cs_qkv)[0]


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
        softcap=cfg.attn_softcap, window=window or 0, span=pos + 1)
    return out.to(x.dtype).reshape(b, 1, -1) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): low-rank compressed KV with decoupled RoPE
# ---------------------------------------------------------------------------

def mla_init(gen: Optional[torch.Generator], cfg, dtype) -> Dict[str, torch.Tensor]:
    """Drawn from ``gen`` in the reference's order (queries, compressed
    kv, expansion, output); ``wq_a`` and ``q_norm`` only with a query
    rank ``mla_q_lora``."""
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.mla_kv_lora, cfg.mla_q_lora
    nope, rope, dv = cfg.mla_qk_nope, cfg.mla_rope_dim, cfg.mla_v_head
    ones = lambda n: torch.ones((n,), dtype=dtype, device=init_device(gen))  # noqa: E731
    p = {}
    if r_q:
        p["wq_a"] = dense_init(gen, d, r_q, dtype)
        p["q_norm"] = ones(r_q)
    p["wq_b"] = dense_init(gen, r_q or d, h * (nope + rope), dtype)
    p["wkv_a"] = dense_init(gen, d, r_kv + rope, dtype)
    p["kv_norm"] = ones(r_kv)
    p["wkv_b"] = dense_init(gen, r_kv, h * (nope + dv), dtype)
    p["wo"] = dense_init(gen, h * dv, d, dtype)
    return p


def _mla_qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x [B, S, d] -> q_nope [B, S, H, nope], q_rope [B, S, H, rope],
    the normed latent c_kv [B, S, r_kv] and the shared k_rope [B, S, rope]."""
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.mla_qk_nope, cfg.mla_rope_dim
    q_in = rms_norm(x @ p["wq_a"], p["q_norm"]) if cfg.mla_q_lora else x
    q = (q_in @ p["wq_b"]).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], positions,
                                               cfg.rope_theta)
    kv = x @ p["wkv_a"]                                   # [B, S, r_kv + rope]
    c_kv = rms_norm(kv[..., :cfg.mla_kv_lora], p["kv_norm"])
    k_rope = apply_rope(kv[..., cfg.mla_kv_lora:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand(p, cfg, c_kv: torch.Tensor):
    """The cached latent decompressed into per-head k_nope and v."""
    b, s, _ = c_kv.shape
    h, nope, dv = cfg.n_heads, cfg.mla_qk_nope, cfg.mla_v_head
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, h, nope + dv)
    return kv[..., :nope], kv[..., nope:]


def mla_attend(p, cfg, x: torch.Tensor, cs_qkv=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal MLA and the latent it cached: x [B, S, d] ->
    (out [B, S, d], c_kv [B, S, r_kv], k_rope [B, S, rope]).  Through
    ``blocked_attention`` with one kv head a query head (Hkv = H, G = 1),
    keys of nope + rope and values of ``mla_v_head``."""
    b, s, _ = x.shape
    h, rope, dv = cfg.n_heads, cfg.mla_rope_dim, cfg.mla_v_head
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    k_nope, v = _mla_expand(p, cfg, c_kv)
    q = torch.cat([q_nope, q_rope], -1)[:, :, :, None, :]    # [B, S, H, 1, Dk]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, rope)], -1)
    if cs_qkv is not None:
        q, k, v = cs_qkv(q, k, v)
    out = blocked_attention(q, k, v, causal=True, softcap=0.0,
                            block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
    return out.reshape(b, s, h * dv) @ p["wo"], c_kv, k_rope


def mla_apply(p, cfg, x: torch.Tensor, cs_qkv=None) -> torch.Tensor:
    """Full-sequence MLA (training / prefill): x [B, S, d] -> [B, S, d]."""
    return mla_attend(p, cfg, x, cs_qkv)[0]


def mla_init_cache(cfg, batch: int, max_seq: int, dtype, device) -> Dict[str, torch.Tensor]:
    """The compressed latent and the rope key, ``r_kv + rope`` values a
    token instead of GQA's ``2 Hkv dh``."""
    return {"c_kv": torch.zeros((batch, max_seq, cfg.mla_kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.mla_rope_dim), dtype=dtype,
                                  device=device)}


def mla_decode(p, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               length: torch.Tensor, *, pos: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, 1, d]; cache ``c_kv`` / ``k_rope``; ``length`` [B] tokens
    already stored and ``pos`` its host copy (aligned steps, as
    ``gqa_decode``): the new latent and rope key are written IN PLACE at
    slot ``pos``, and a full cache raises where the reference clamps.

    Absorbed attention in float32, the reference's einsums in plain
    PyTorch (its scores are ``r_kv + rope`` wide, no Pallas kernel):
    ``W_b`` folds into the query and the output, so the cache is never
    decompressed::

        score(s) = (W_bk^T q_nope) . c_kv[s] + q_rope . k_rope[s]
        out      = W_bv^T (sum_s p_s c_kv[s])
    """
    b = x.shape[0]
    h, nope, rope, dv = (cfg.n_heads, cfg.mla_qk_nope, cfg.mla_rope_dim,
                         cfg.mla_v_head)
    max_seq = cache["c_kv"].shape[1]
    if not 0 <= pos < max_seq:
        raise ValueError(f"KV cache full: slot {pos} of a cache of {max_seq}")
    q_nope, q_rope, c_new, k_new = _mla_qkv(p, cfg, x, length[:, None])
    cache["c_kv"][:, pos] = c_new[:, 0]
    cache["k_rope"][:, pos] = k_new[:, 0]
    w_b = p["wkv_b"].reshape(cfg.mla_kv_lora, h, nope + dv).float()
    w_bk, w_bv = w_b[..., :nope], w_b[..., nope:]
    c_kv = cache["c_kv"].float()
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_bk)
    scale = 1.0 / math.sqrt(nope + rope)
    s_lat = torch.einsum("bhr,bsr->bhs", q_eff, c_kv)
    s_rope = torch.einsum("bhp,bsp->bhs", q_rope[:, 0].float(),
                          cache["k_rope"].float())
    scores = (s_lat + s_rope) * scale
    mask = torch.arange(max_seq, device=x.device)[None] < (length + 1)[:, None]
    prob = torch.softmax(torch.where(mask[:, None], scores, NEG), dim=-1)
    lat = torch.einsum("bhs,bsr->bhr", prob, c_kv)
    out = torch.einsum("bhr,rhv->bhv", lat, w_bv)
    return out.reshape(b, 1, h * dv).to(x.dtype) @ p["wo"], cache
