"""Single-process BSR SpMV / SpMM on a ``sparse.BSR`` matrix: the paper's
``local_spmv`` on one process, through the padded-uniform BSR kernel.

Both run on CUDA unless ``device="cpu"`` is asked for, and return a
tensor on that device, of the matrix's padded row length.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bsr_spmv.kernel import bsr_spmm_padded
from repro_torch.sparse.bsr import BSR


def bsr_spmm(bsr: BSR, x, *, device: DeviceLike = None) -> torch.Tensor:
    """w = A @ x with x ``[n_cols, nv]`` (zero-padded up to the block
    grid); returns ``[n_rows_padded, nv]`` float32."""
    dev = resolve_device(device)
    cols, blocks, _ = bsr.padded_uniform()
    bn = bsr.block_shape[1]
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    pad_rows = bsr.shape[1] - x.shape[0]
    if pad_rows:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_rows))
    xb = x.reshape(bsr.shape[1] // bn, bn, -1).contiguous()
    if xb.data_ptr() % 16:  # a view into the caller's array; the kernel needs 16-byte alignment
        xb = xb.clone()
    out = bsr_spmm_padded(torch.from_numpy(cols).to(dev),
                          torch.from_numpy(blocks).to(dev), xb)
    return out.reshape(bsr.shape[0], -1)


def bsr_spmv(bsr: BSR, v, *, device: DeviceLike = None) -> torch.Tensor:
    """w = A @ v for a single vector; returns ``[n_rows_padded]``."""
    v = torch.as_tensor(v).reshape(-1, 1)
    return bsr_spmm(bsr, v, device=device).reshape(-1)
