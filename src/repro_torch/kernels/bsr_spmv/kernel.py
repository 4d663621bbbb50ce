"""Padded-uniform BSR SpMM of one matrix: CUDA kernel wrapper.

The kernel (``bsr_spmm_padded_f32`` in ``csrc/bsr_spmm.cu``, the
one-segment, one-rank instance of the fused BSR template) replaces the
Pallas kernel ``repro/kernels/bsr_spmv/kernel.py::bsr_spmm_padded``:

    cols:   [n_brows, kmax] int32 block-column ids (-1 = padding slot)
    blocks: [n_brows, kmax, bm, bn] float32 (padding slots zero)
    x:      [n_bcols, bn, nv] float32
    returns [n_brows, bm, nv] float32

Operands are contiguous, and blocks and x start on 16-byte boundaries.
CPU tensors take the plain version (:mod:`.ref`); CUDA tensors take the
kernel or raise; ``meta`` tensors an empty result of the output's shape.
While :mod:`repro_torch.core.op_analysis` counts, a call reports its
declared work (:func:`declared_work`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import op_analysis
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmv.ref import bsr_spmm_padded_ref

NAME = "bsr_spmm_padded"
_INT32_MAX = 2**31 - 1


def _fn():
    fn = _build.library("bsr_spmm").bsr_spmm_padded_f32
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, ll, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(cols: torch.Tensor, blocks: torch.Tensor, x: torch.Tensor) -> None:
    if cols.dtype != torch.int32 or blocks.dtype != torch.float32 \
            or x.dtype != torch.float32:
        raise TypeError(f"cols int32, blocks and x float32, got {cols.dtype}, "
                        f"{blocks.dtype}, {x.dtype}")
    if cols.dim() != 2 or blocks.dim() != 4 or blocks.shape[:2] != cols.shape \
            or x.dim() != 3 or x.shape[1] != blocks.shape[3]:
        raise ValueError(f"cols [n_brows, kmax], blocks [n_brows, kmax, bm, bn] "
                         f"and x [n_bcols, bn, nv] expected, got "
                         f"{tuple(cols.shape)}, {tuple(blocks.shape)}, "
                         f"{tuple(x.shape)}")
    for t in (blocks, x):
        if t.device != cols.device:
            raise ValueError("all operands must lie on one device")
    for t in (cols, blocks, x):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for t in (blocks, x):
        if t.data_ptr() % 16:
            raise ValueError("blocks and x must start on a 16-byte boundary "
                             "(the kernel reads 16-byte vectors)")
    if max(*blocks.shape, x.shape[2]) > _INT32_MAX:
        raise ValueError(f"shape out of the kernel's range: {tuple(blocks.shape)}, "
                         f"nv {x.shape[2]}")


def declared_work(cols, blocks, x):
    """``(flops, bytes read, bytes written)`` of a call: a block product
    for every slot (padding included), cols, blocks and x read once, the
    output written once."""
    n_brows, kmax, bm, bn = blocks.shape
    nv = x.shape[2]
    read = sum(t.numel() * t.element_size() for t in (cols, blocks, x))
    return 2.0 * n_brows * kmax * bm * bn * nv, read, n_brows * bm * nv * 4


def bsr_spmm_padded(cols: torch.Tensor, blocks: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """w = A @ x for the padded-uniform BSR layout of one matrix."""
    _check(cols, blocks, x)
    with op_analysis.kernel(NAME, lambda: declared_work(cols, blocks, x)):
        return _dispatch(cols, blocks, x)


def _dispatch(cols, blocks, x) -> torch.Tensor:
    if cols.device.type == "cpu":
        return bsr_spmm_padded_ref(cols, blocks, x)
    if cols.device.type == "meta":
        return torch.empty((blocks.shape[0], blocks.shape[2], x.shape[2]),
                           dtype=torch.float32, device="meta")
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    n_brows, kmax, bm, bn = blocks.shape
    nv = x.shape[2]
    out = torch.empty((n_brows, bm, nv), dtype=torch.float32, device=cols.device)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    code = _fn()(cols.data_ptr(), blocks.data_ptr(), x.data_ptr(), x.shape[0],
                 out.data_ptr(), n_brows, kmax, bm, bn, nv, stream)
    _build.check_status(code, NAME)
    _build.launches[NAME] += 1
    return out
