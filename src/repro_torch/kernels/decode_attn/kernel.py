"""Single-token GQA decode attention: CUDA kernel wrapper.

The kernel (``csrc/decode_attn.cu``) replaces the Pallas kernel
``repro/kernels/decode_attn/kernel.py::decode_attention_grouped``:

    q:       [B, Hkv, g, D] float32 or bfloat16, contiguous
    k, v:    [B, Hkv, S, D] of q's dtype, any strides with unit stride
             along D: the transpose ``cache.transpose(1, 2)`` of the
             model's [B, S, Hkv, D] cache is read in place, with no copy
    lengths: [B] int32, positions ``>= lengths[b]`` masked
    returns  [B, Hkv, g, D] float32

``window > 0`` also masks positions ``< lengths[b] - window`` (the sliding
window of ``models.common.cache_decode_attention``); ``window = 0`` is
the TPU kernel's contract.  ``softcap > 0`` caps the scores as
``softcap * tanh(s / softcap)``.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors take the
kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

NAME = "decode_attention_grouped"
WARPS = 4                 # warps per thread block (kWarps in the source)
MAX_D = 256               # one 8-element slice of D per lane of a warp
BLOCKS_IN_FLIGHT = 2112   # 16 blocks of WARPS warps for each of 132 SMs
MIN_WARP_ROWS = 16        # fewest positions worth a warp of its own
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def _fn():
    fn = _build.library("decode_attn").decode_attention_grouped
    if fn.argtypes is None:
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, ll, ll, ll, ll, ll, ll, p, p,
                       i, i, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def query_tile(g: int) -> int:
    """Query rows one warp carries: the next power of two of g, at most 8
    (larger groups take several tiles, each reading k/v again)."""
    return min(8, 1 << (g - 1).bit_length())


def split_plan(n_tiles: int, span: int) -> Tuple[int, int]:
    """(units, chunk): each of the ``n_tiles`` (b, kv head, query tile)
    triples gets ``units`` warps (a multiple of WARPS), each over ``chunk``
    consecutive positions of the at most ``span`` valid ones.  About
    BLOCKS_IN_FLIGHT blocks in all, since ragged lengths leave many of
    them without work, and no block under WARPS * MIN_WARP_ROWS
    positions."""
    blocks = max(1, min(-(-BLOCKS_IN_FLIGHT // max(n_tiles, 1)),
                        -(-span // (WARPS * MIN_WARP_ROWS))))
    units = blocks * WARPS
    return units, -(-span // units)


def _check(q, k, v, lengths) -> None:
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.shape != ks or ks[0] != qs[0] \
            or ks[1] != qs[1] or ks[3] != qs[3]:
        raise ValueError(f"q [B, Hkv, g, D] and k, v [B, Hkv, S, D] expected, got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (qs[0],):
        raise ValueError(f"lengths must be int32 [{qs[0]}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev or lengths.device != dev:
        raise ValueError("all operands must lie on one device")


def _check_kernel_layout(q, k, v, lengths) -> None:
    """What the kernel reads: 16-byte rows of 8-element slices of D."""
    d = q.shape[3]
    if d % 8 or d > MAX_D:
        raise ValueError(f"head dim must be a multiple of 8 up to {MAX_D}, got {d}")
    if not q.is_contiguous() or not lengths.is_contiguous():
        raise ValueError("q and lengths must be contiguous")
    per16 = 16 // q.element_size()
    for name, st in (("k", k.stride()), ("v", v.stride())):
        if st[3] != 1 or st[0] % per16 or st[1] % per16 or st[2] % per16:
            raise ValueError(f"{name} needs a unit stride along D and 16-byte "
                             f"aligned rows, got strides {st}")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q, k, v must start on a 16-byte boundary")
    b, hkv, g, _ = q.shape
    if k.shape[2] > _INT32_MAX or b > 65535 or hkv * -(-g // query_tile(g)) > 65535:
        raise ValueError(f"shape out of the kernel's range: {tuple(k.shape)}, g {g}")


def decode_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lengths: torch.Tensor, *, scale: float,
                             softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """One new token per sequence over its cache; see the module docstring."""
    _check(q, k, v, lengths)
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = none), got {window}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, scale=scale,
                                    softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_layout(q, k, v, lengths)
    b, hkv, g, d = q.shape
    seq = k.shape[2]
    gt = query_tile(g)
    span = min(seq, window) if window > 0 else seq
    units, chunk = split_plan(b * hkv * -(-g // gt), span)
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    part = torch.empty(b * hkv * g * units * (d + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 _DTYPES[q.dtype], *k.stride()[:3], *v.stride()[:3],
                 out.data_ptr(), part.data_ptr(), b, hkv, g, gt, seq, d,
                 window, units, chunk, float(scale), float(softcap), stream)
    _build.check_status(code, NAME)
    _build.launches[NAME] += 1
    return out
