"""Shared building blocks of the port's models: norms, RoPE, blocked
(flash-style) attention, decode attention's plain version, the chunked
cross-entropy, the output head, initialisers.

Functions on tensors, mirroring ``repro/models/common.py``.  Initialisers
draw from an explicit ``torch.Generator`` on the device they fill; with
no generator they return tensors on the meta device (shapes, no
allocation: ``registry.param_shapes``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import op_analysis
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def init_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where an initialiser puts its tensors: the generator's device, or
    the meta device when there is no generator."""
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    if gen is None:
        return torch.empty((d_in, d_out), dtype=dtype, device="meta")
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int,
               dtype) -> torch.Tensor:
    if gen is None:
        return torch.empty((vocab, d), dtype=dtype, device="meta")
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


def l2_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free L2 normalization (chameleon qk-norm style, f32)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(x.dtype)


def layer_call(remat: bool):
    """How a model calls its layers: ``call(fn, *args)``, through
    ``torch.utils.checkpoint`` (the backward recomputes the layer instead
    of keeping its activations) when ``remat`` and grads are on, else
    directly (the reference wraps its scan body in ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)
    return lambda fn, *a: fn(*a)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Frequencies in float64 on the host, then float32 on the device, as
    the reference computes them (float32 from the start drifts at long
    positions).  Made once a device and cached, so an operator count
    leaves the copy out: every run then counts the same."""
    with op_analysis.suspended():
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
# blocked (flash-style) attention
# ---------------------------------------------------------------------------

NEG = -1e30


def _kv_block(qi, kk, vv, m_prev, l_prev, acc, mask, softcap):
    """One KV block of the online softmax: the running max ``m``, sum ``l``
    and output ``acc`` updated with the block's scores (the reference's
    ``kv_block``, its float32 ops in its order)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kk.float())
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m_prev, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask, p, 0.0)
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vv.float())
    return m_new, l_new, acc


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: float = 0.0, block_q: int = 1024,
                      block_kv: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV blocks: O(S) memory instead of O(S^2).

    q: [B, Sq, Hkv, G, Dk]  (grouped query heads)
    k: [B, Skv, Hkv, Dk];  v: [B, Skv, Hkv, Dv]  (Dv may differ: MLA)
    window: sliding window size (keys ``kv_pos > q_pos - window``); None =
    full.  q_offset: absolute position of q[0] (prefill continuation).
    Returns [B, Sq, Hkv, G, Dv] in q's dtype.

    Mirrors the reference: Sq and Skv padded up to the blocks, the masks
    ``kv_pos <= q_pos`` (causal), ``kv_pos < Skv``, ``q_pos < q_offset +
    Sq`` and the window, masked scores ``NEG``, and each KV block's body
    checkpointed when grads are on (the backward recomputes it instead of
    keeping every ``[bq, bkv]`` score block).  The loops are Python loops,
    so a KV block that the causal mask, the window or the padding masks
    whole is skipped: over such a block the reference's update is the
    identity (p = 0, alpha = 1), so skipping it changes no bit.
    """
    b, sq, hkv, g, dk = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    scale = 1.0 / np.sqrt(dk)
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    nq, nkv = -(-sq // bq), -(-skv // bkv)
    pad_q, pad_kv = nq * bq - sq, nkv * bkv - skv
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    qb = q.float() * scale
    dev = q.device
    use_ckpt = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for iq in range(nq):
        q_lo = q_offset + iq * bq
        q_pos = q_lo + torch.arange(bq, device=dev)
        q_hi = min(q_lo + bq, q_offset + sq) - 1      # last real query
        qi = qb[:, iq * bq:(iq + 1) * bq]
        m = torch.full((b, hkv, g, bq), NEG, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, bq, dv), dtype=torch.float32, device=dev)
        for ikv in range(nkv):
            kv_lo = ikv * bkv
            kv_hi = min(kv_lo + bkv, skv) - 1           # last real key
            if q_hi < q_lo or (causal and kv_lo > q_hi) or (
                    window is not None and kv_hi <= q_lo - window):
                continue                                 # masked whole
            kv_pos = kv_lo + torch.arange(bkv, device=dev)
            mask = kv_pos[None, :] <= q_pos[:, None] if causal else \
                torch.ones((bq, bkv), dtype=torch.bool, device=dev)
            mask = mask & (kv_pos[None, :] < skv) & (q_pos[:, None] < q_offset + sq)
            if window is not None:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            args = (qi, k[:, kv_lo:kv_lo + bkv], v[:, kv_lo:kv_lo + bkv],
                    m, l_run, acc, mask, softcap)
            m, l_run, acc = (checkpoint(_kv_block, *args, use_reentrant=False)
                             if use_ckpt else _kv_block(*args))
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))        # [B, bq, Hkv, G, Dv]
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out[:, :sq].to(q.dtype)


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


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materialises [B, S, V] at once)
# ---------------------------------------------------------------------------

def _xent_chunk(xi, head, li, softcap, cs_logits=None):
    """(sum of the chunk's token NLLs, its count of labels >= 0), float32."""
    logits = (xi @ head).float()
    if cs_logits is not None:
        logits = cs_logits(logits)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    # the label's logit by a gather: the reference's one-hot reduce sums
    # one nonzero with zeros, which is exact too
    ll = logits.gather(-1, li.clamp(min=0).long()[..., None])[..., 0]
    valid = li >= 0
    nll = torch.where(valid, lse - ll, 0.0)
    return torch.stack([nll.sum(), valid.sum().float()])


def chunked_xent(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                 *, chunk: int = 2048, softcap: float = 0.0,
                 cs_logits=None) -> torch.Tensor:
    """x: [B, S, D]; head: [D, V]; labels: [B, S] (-1 ignored) -> mean
    token NLL (0-d float32).

    The sequence runs in chunks, each checkpointed when grads are on (the
    backward recomputes a chunk's ``[B, chunk, V]`` logits instead of
    keeping every chunk's).  A chunk longer than S is cut to S: the
    reference pads S up to the chunk, and the padded tokens (label -1)
    add exactly zero to both sums, so only the padding's memory and
    FLOPs differ.  ``cs_logits`` (a model's activation specs) sees each
    chunk's float32 logits.
    """
    b, s, d = x.shape
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    use_ckpt = torch.is_grad_enabled() and (x.requires_grad or head.requires_grad)
    acc = torch.zeros(2, dtype=torch.float32, device=x.device)
    for i in range(n):
        args = (x[:, i * chunk:(i + 1) * chunk], head,
                labels[:, i * chunk:(i + 1) * chunk], softcap, cs_logits)
        acc = acc + (checkpoint(_xent_chunk, *args, use_reentrant=False)
                     if use_ckpt else _xent_chunk(*args))
    return acc[0] / torch.clamp(acc[1], min=1.0)
