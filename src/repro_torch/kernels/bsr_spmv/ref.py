"""Plain PyTorch versions of the BSR SpMM kernels (same contracts)."""
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


def bsr_spmm_padded_ref(cols: torch.Tensor, blocks: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """``w[i] = sum_k blocks[i, k] @ x[cols[i, k]]`` over the live slots
    (``cols >= 0``) of one padded-uniform BSR: gather the x blocks with
    padding slots zeroed, one batched block product, sum over slots."""
    gathered = x[cols.clamp(min=0).long()]                 # [nbr, kmax, bn, nv]
    gathered = torch.where((cols >= 0)[..., None, None], gathered, 0.0)
    return torch.einsum("rkmn,rknv->rkmv", blocks, gathered).sum(dim=1)


def bsr_spmv_ref(bsr, v) -> torch.Tensor:
    """Plain version on a ``sparse.BSR`` container and an element vector
    of its padded column length (CPU, float32)."""
    cols, blocks, _ = bsr.padded_uniform()
    bn = bsr.block_shape[1]
    x = torch.as_tensor(v, dtype=torch.float32).reshape(-1, bn, 1)
    return bsr_spmm_padded_ref(torch.from_numpy(cols), torch.from_numpy(blocks),
                               x).reshape(-1)
