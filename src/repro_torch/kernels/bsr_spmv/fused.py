"""Fused BSR SpMM over a packed x: CUDA kernel wrappers.

One CUDA template (``csrc/bsr_spmm.cu``) replaces both Pallas kernels of
``repro/kernels/bsr_spmv/fused.py``: :func:`fused_bsr_spmm_packed` runs it
over 1-3 bn-aligned x segments, :func:`fused_bsr_spmm` over one
concatenated x.  Their arithmetic is identical, so the two agree bit for
bit.  Every operand is rank-batched:

    cols:   [P, n_brows, ktot] int32 block-column ids (-1 = padding slot)
    blocks: [P, n_brows, ktot, bm, bn] float32 (padding slots zero)
    x / xs: [P, n_bcols_s, bn, nv] float32 per segment
    returns [P, n_brows, bm, nv] float32

Operands are contiguous, and blocks and x start on 16-byte boundaries.
CPU tensors take the plain version (:mod:`.ref`); CUDA tensors take the
kernel or raise; ``meta`` tensors an empty result of the output's shape.
While :mod:`repro_torch.core.op_analysis` counts, a call reports its
declared work (:func:`declared_work`).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core import op_analysis
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmv.ref import (fused_bsr_spmm_packed_ref,
                                              fused_bsr_spmm_ref)

_INT32_MAX = 2**31 - 1


def _fn():
    fn = _build.library("bsr_spmm").fused_bsr_spmm_f32
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ll, ll, ll, i, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(cols: torch.Tensor, blocks: torch.Tensor, xs) -> None:
    if not 1 <= len(xs) <= 3:
        raise ValueError(f"1 to 3 x segments, got {len(xs)}")
    if cols.dtype != torch.int32 or blocks.dtype != torch.float32:
        raise TypeError(f"cols int32 and blocks float32, got {cols.dtype}, "
                        f"{blocks.dtype}")
    if cols.dim() != 3 or blocks.dim() != 5 or blocks.shape[:3] != cols.shape:
        raise ValueError(f"cols [P, n_brows, ktot] and blocks [P, n_brows, "
                         f"ktot, bm, bn] expected, got {tuple(cols.shape)} and "
                         f"{tuple(blocks.shape)}")
    p, bn, nv = cols.shape[0], blocks.shape[4], xs[0].shape[-1]
    for x in xs:
        if x.dtype != torch.float32 or x.dim() != 4 or x.shape[0] != p \
                or x.shape[2] != bn or x.shape[3] != nv:
            raise ValueError(f"each x segment must be float32 [{p}, n_bcols, "
                             f"{bn}, {nv}], got {x.dtype} {tuple(x.shape)}")
    for t in (cols, blocks, *xs):
        if t.device != cols.device:
            raise ValueError("all operands must lie on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for t in (blocks, *xs):
        if t.data_ptr() % 16:
            raise ValueError("blocks and x segments must start on a 16-byte "
                             "boundary (the kernel reads 16-byte vectors)")
    if max(*blocks.shape, nv) > _INT32_MAX:
        raise ValueError(f"shape out of the kernel's range: {tuple(blocks.shape)}, nv {nv}")


def _launch(name: str, cols: torch.Tensor, blocks: torch.Tensor,
            xs) -> torch.Tensor:
    fn = _fn()
    p, n_brows, ktot, bm, bn = blocks.shape
    nv = xs[0].shape[-1]
    out = torch.empty((p, n_brows, bm, nv), dtype=torch.float32,
                      device=cols.device)
    pad = 3 - len(xs)
    ptrs = [x.data_ptr() for x in xs] + [xs[0].data_ptr()] * pad
    lens = [x.shape[1] for x in xs] + [0] * pad
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    code = fn(cols.data_ptr(), blocks.data_ptr(), *ptrs, *lens, len(xs),
              out.data_ptr(), p, n_brows, ktot, bm, bn, nv, stream)
    _build.check_status(code, name)
    _build.launches[name] += 1
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def declared_work(cols, blocks, xs):
    """``(flops, bytes read, bytes written)`` of a call: a block product
    for every slot (padding included: the structure, not the values,
    sizes it), cols, blocks and x read once, the output written once."""
    p, n_brows, ktot, bm, bn = blocks.shape
    nv = xs[0].shape[-1]
    read = _nbytes(cols) + _nbytes(blocks) + sum(_nbytes(x) for x in xs)
    return 2.0 * p * n_brows * ktot * bm * bn * nv, read, p * n_brows * bm * nv * 4


def _run(name, plain, cols, blocks, xs) -> torch.Tensor:
    with op_analysis.kernel(name, lambda: declared_work(cols, blocks, xs)):
        if cols.device.type == "cpu":
            return plain()
        if cols.device.type == "meta":
            return torch.empty(blocks.shape[:2] + (blocks.shape[3], xs[0].shape[-1]),
                               dtype=torch.float32, device="meta")
        if cols.device.type != "cuda":
            raise ValueError(f"unsupported device {cols.device}")
        return _launch(name, cols, blocks, xs)


def fused_bsr_spmm_packed(cols: torch.Tensor, blocks: torch.Tensor,
                          xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """w = A @ cat(xs) without materialising the concatenation."""
    xs = tuple(xs)
    _check(cols, blocks, xs)
    return _run("fused_bsr_spmm_packed",
                lambda: fused_bsr_spmm_packed_ref(cols, blocks, xs), cols, blocks, xs)


def fused_bsr_spmm(cols: torch.Tensor, blocks: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """w = A @ x over one concatenated x (the one-segment instance)."""
    _check(cols, blocks, (x,))
    return _run("fused_bsr_spmm", lambda: fused_bsr_spmm_ref(cols, blocks, x),
                cols, blocks, (x,))
