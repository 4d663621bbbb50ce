"""Plain PyTorch version of the ELL SpMM kernel (same contract)."""
from __future__ import annotations

from typing import Sequence

import torch


def ell_spmm_packed_ref(cols: torch.Tensor, vals: torch.Tensor,
                        xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``out[r, i] = sum_k vals[r, i, k] * X_r[max(cols[r, i, k], 0)]`` with
    ``X_r = cat(xs)[r]``: gather, multiply, sum over the slot axis."""
    x = torch.cat(list(xs), dim=1)                        # [P, n_x, nv]
    rank = torch.arange(cols.shape[0], device=cols.device)[:, None, None]
    gathered = x[rank, cols.clamp(min=0).long()]          # [P, n_rows, kmax, nv]
    return (vals[..., None] * gathered).sum(dim=2)


def ell_spmv_ref(ell, v) -> torch.Tensor:
    """The plain version over one ``sparse.ELL`` container: ``A @ v`` for
    an element vector ``v`` (numpy or a tensor, whose device it runs on;
    numpy runs on the CPU), as one rank of :func:`ell_spmm_packed_ref`."""
    v = torch.as_tensor(v)
    cols = torch.as_tensor(ell.cols, device=v.device)
    vals = torch.as_tensor(ell.vals, device=v.device)
    out = ell_spmm_packed_ref(cols[None], vals[None],
                              (v.to(vals.dtype).reshape(1, -1, 1),))
    return out.reshape(-1)
