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
