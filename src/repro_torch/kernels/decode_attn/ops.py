"""User-facing decode attention in the flat-head layout.

The port's counterpart of ``repro/kernels/decode_attn/ops.py``.  It needs
none of that function's copies: the kernel reads the [B, S, Hkv, D] cache
in place (no swap of axes, no padding to a block, no cast to float32).
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.decode_attn.kernel import decode_attention_grouped


def decode_attention(q, k_cache, v_cache, lengths, *, softcap: float = 0.0,
                     window: int = 0, device: DeviceLike = None) -> torch.Tensor:
    """GQA decode attention on CUDA unless ``device="cpu"``.

    q:        [B, H, D]       one new token per sequence
    k_cache:  [B, S, Hkv, D]  of q's dtype (float32 or bfloat16)
    v_cache:  [B, S, Hkv, D]
    lengths:  [B]             valid prefix per sequence
    returns   [B, H, D] float32 on that device
    """
    dev = resolve_device(device)
    q, k_cache, v_cache = (torch.as_tensor(t, device=dev)
                           for t in (q, k_cache, v_cache))
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    out = decode_attention_grouped(
        q.reshape(b, hkv, h // hkv, d).contiguous(), k_cache.transpose(1, 2),
        v_cache.transpose(1, 2), lengths.contiguous(), scale=1.0 / d ** 0.5,
        softcap=softcap, window=window)
    return out.reshape(b, h, d)
