"""Plain PyTorch versions of the fused BSR SpMM kernels (same contracts)."""
from __future__ import annotations

from typing import Sequence

import torch


def fused_bsr_spmm_ref(cols: torch.Tensor, blocks: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """``w[r, i] = sum_k blocks[r, i, k] @ x[r, max(cols[r, i, k], 0)]``:
    gather the x blocks, one batched block product, sum over slots."""
    rank = torch.arange(cols.shape[0], device=cols.device)[:, None, None]
    gathered = x[rank, cols.clamp(min=0).long()]          # [P, nbr, ktot, bn, nv]
    return torch.einsum("prkmn,prknv->prkmv", blocks, gathered).sum(dim=2)


def fused_bsr_spmm_packed_ref(cols: torch.Tensor, blocks: torch.Tensor,
                              xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Packed-x contract: the block columns index ``cat(xs)``."""
    return fused_bsr_spmm_ref(cols, blocks, torch.cat(list(xs), dim=1))
