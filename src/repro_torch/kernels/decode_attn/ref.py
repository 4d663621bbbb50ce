"""Plain PyTorch version of the decode-attention kernel (same contract)."""
from __future__ import annotations

import torch

NEG_BIG = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float,
                         softcap: float = 0.0, window: int = 0,
                         span=None) -> torch.Tensor:
    """q [B, Hkv, g, D]; k, v [B, Hkv, S, D] (any strides); lengths [B]
    -> float32 [B, Hkv, g, D].

    Positions ``>= lengths[b]`` are masked and, with ``window > 0``, so
    are positions ``< lengths[b] - window``.  An empty range gives zeros,
    as the kernel does (``acc / max(l, 1e-30)``).  ``span`` is the
    kernel wrapper's (it only sizes its declared work) and is ignored.
    """
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(k.shape[2], device=k.device)[None, :]
    n = lengths.to(device=k.device, dtype=torch.int64)[:, None]
    mask = pos < n
    if window > 0:
        mask = mask & (pos >= n - window)
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, NEG_BIG)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out / p.sum(-1, keepdim=True).clamp_min(1e-30)
