"""The plain reference of an SpMV apply: ``A @ x`` and ``A.T @ u`` over the
CSR that the benchmark made, in float64, with plain PyTorch operations
(a gather, a product and an ``index_add_``), in blocks of nonzeros so
that it fits beside whatever else is on the device.

It imports nothing of the program and takes nothing the program made:
the matrix is the benchmark's own CSR, and the operand is handed in as
a global ``[n, nv]`` array.

``Reference.apply(x, transpose, precision="bf16")`` is the control: the
same sums with the matrix values and the operand rounded to bfloat16,
their products and sums in float32 (products of two bf16 values are
exact in float32), the step below the float32 that the configurations
state.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: nonzeros a block: [block, nv] float64 temporaries of at most 256 MB at nv = 8
BLOCK_NNZ = 1 << 22


class Reference:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                 shape: Tuple[int, int], device) -> None:
        self.shape = tuple(shape)
        self.device = torch.device(device)
        counts = torch.from_numpy(np.diff(indptr))
        self.rows = torch.repeat_interleave(
            torch.arange(shape[0], dtype=torch.int64), counts).to(self.device)
        self.cols = torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(self.device)
        self.vals = torch.from_numpy(np.asarray(data, dtype=np.float64)).to(self.device)

    def apply(self, x: torch.Tensor, transpose: bool = False,
              precision: str = "float64") -> Tuple[torch.Tensor, torch.Tensor]:
        """``(A @ x, |A| @ |x|)`` (``A.T`` with ``transpose``) for a global
        ``[n, nv]`` operand.  The second array is each result entry's
        rounding scale.  ``precision="bf16"`` is the control."""
        if precision == "float64":
            dtype = torch.float64
            vals, x = self.vals, x.to(self.device, torch.float64)
        elif precision == "bf16":
            dtype = torch.float32
            vals = self.vals.to(torch.bfloat16).to(dtype)
            x = x.to(self.device).to(torch.bfloat16).to(dtype)
        else:
            raise ValueError(f"precision must be float64 or bf16, got {precision!r}")
        src_all, dst_all = (self.rows, self.cols) if transpose else (self.cols, self.rows)
        n_out = self.shape[1] if transpose else self.shape[0]
        out = torch.zeros((n_out, x.shape[1]), dtype=dtype, device=self.device)
        scale = torch.zeros_like(out)
        for lo in range(0, self.vals.numel(), BLOCK_NNZ):
            hi = lo + BLOCK_NNZ
            prod = vals[lo:hi, None] * x.index_select(0, src_all[lo:hi])
            out.index_add_(0, dst_all[lo:hi], prod)
            scale.index_add_(0, dst_all[lo:hi], prod.abs_())
        return out, scale


def scaled_error(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest ``|got - want|`` over its entry's rounding scale
    ``(|A| |x|)_i``, in float64.  An entry whose scale is 0 must be exact:
    any difference there reads infinite."""
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    ratio = torch.where(scale > 0, diff / scale.to(torch.float64).clamp_min(1e-300),
                        torch.where(diff > 0, torch.inf, 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0
