"""ELL SpMM over a packed x of 1-3 segments: CUDA kernel wrapper.

The kernel (``csrc/ell_spmm.cu``) replaces the Pallas kernel
``repro/kernels/ell_spmv/kernel.py::ell_spmm_packed``.  Every operand is
rank-batched: one launch covers all ranks of the plan.

    cols: [P, n_rows, kmax] int32 column ids in the packed x domain (-1 = pad)
    vals: [P, n_rows, kmax] float32 (0 on padding slots)
    xs:   1-3 tensors [P, len_s, nv] float32; the packed domain of rank r
          is ``cat([x[r] for x in xs])``, never materialised
    returns [P, n_rows, nv] float32

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
from repro_torch.kernels.ell_spmv.ref import ell_spmm_packed_ref

NAME = "ell_spmm_packed"
_INT32_MAX = 2**31 - 1


def _fn():
    fn = _build.library("ell_spmm").ell_spmm_packed_f32
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ll, ll, ll, i, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(cols: torch.Tensor, vals: torch.Tensor, xs) -> None:
    if not 1 <= len(xs) <= 3:
        raise ValueError(f"1 to 3 x segments, got {len(xs)}")
    if cols.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"cols int32 and vals float32, got {cols.dtype}, {vals.dtype}")
    if cols.dim() != 3 or cols.shape != vals.shape:
        raise ValueError(f"cols/vals must be equal [P, n_rows, kmax], got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")
    p, nv = cols.shape[0], xs[0].shape[-1]
    for x in xs:
        if x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != p \
                or x.shape[2] != nv:
            raise ValueError(f"each x segment must be float32 [{p}, len, {nv}], "
                             f"got {x.dtype} {tuple(x.shape)}")
    for t in (cols, vals, *xs):
        if t.device != cols.device:
            raise ValueError("all operands must lie on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if max(cols.shape[1], cols.shape[2], nv) > _INT32_MAX or p > 65535:
        raise ValueError(f"shape out of the kernel's range: {tuple(cols.shape)}, nv {nv}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def declared_work(cols, vals, xs):
    """``(flops, bytes read, bytes written)`` of a call: a product for
    every slot (padding included: the structure, not the values, sizes
    it), cols, vals and x read once, the output written once."""
    p, n_rows, kmax = cols.shape
    nv = xs[0].shape[-1]
    read = _nbytes(cols) + _nbytes(vals) + sum(_nbytes(x) for x in xs)
    return 2.0 * p * n_rows * kmax * nv, read, p * n_rows * nv * 4


def ell_spmm_packed(cols: torch.Tensor, vals: torch.Tensor,
                    xs: Sequence[torch.Tensor]) -> torch.Tensor:
    xs = tuple(xs)
    _check(cols, vals, xs)
    with op_analysis.kernel(NAME, lambda: declared_work(cols, vals, xs)):
        return _dispatch(cols, vals, xs)


def _dispatch(cols, vals, xs) -> torch.Tensor:
    if cols.device.type == "cpu":
        return ell_spmm_packed_ref(cols, vals, xs)
    if cols.device.type == "meta":
        return torch.empty(cols.shape[:2] + (xs[0].shape[-1],), dtype=torch.float32,
                           device="meta")
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    fn = _fn()
    p, n_rows, kmax = cols.shape
    nv = xs[0].shape[-1]
    out = torch.empty((p, n_rows, nv), dtype=torch.float32, device=cols.device)
    pad = 3 - len(xs)
    ptrs = [x.data_ptr() for x in xs] + [xs[0].data_ptr()] * pad
    lens = [x.shape[1] for x in xs] + [0] * pad
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    code = fn(cols.data_ptr(), vals.data_ptr(), *ptrs, *lens, len(xs),
              out.data_ptr(), p, n_rows, kmax, nv, stream)
    _build.check_status(code, NAME)
    _build.launches[NAME] += 1
    return out
