"""Block-sparse-row (BSR) container: the layout of the BSR kernels.

Dense ``(bm, bn)`` blocks; block row i holds ``data[indptr[i]:indptr[i+1]]``
at block columns ``indices[...]``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.sparse.csr import CSR


@dataclasses.dataclass
class BSR:
    indptr: np.ndarray    # int32 [n_brows + 1]
    indices: np.ndarray   # int32 [n_blocks]
    data: np.ndarray      # float32 [n_blocks, bm, bn]
    shape: Tuple[int, int]  # logical (padded) element shape

    @property
    def block_shape(self) -> Tuple[int, int]:
        return self.data.shape[1], self.data.shape[2]

    @property
    def n_brows(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_blocks(self) -> int:
        return int(self.indices.size)

    @property
    def density(self) -> float:
        """Stored blocks over the blocks of the whole block grid."""
        bm, bn = self.block_shape
        total = (self.shape[0] // bm) * (self.shape[1] // bn)
        return self.n_blocks / max(total, 1)

    def matvec(self, v: np.ndarray) -> np.ndarray:
        """Dense-block oracle (numpy); ``v`` has the padded length."""
        bm, bn = self.block_shape
        out = np.zeros(self.shape[0], dtype=np.result_type(self.data, v))
        vb = v.reshape(-1, bn)
        for i in range(self.n_brows):
            acc = np.zeros(bm, dtype=out.dtype)
            for k in range(self.indptr[i], self.indptr[i + 1]):
                acc += self.data[k] @ vb[self.indices[k]]
            out[i * bm:(i + 1) * bm] = acc
        return out

    def to_dense(self) -> np.ndarray:
        bm, bn = self.block_shape
        out = np.zeros(self.shape, dtype=self.data.dtype)
        for i in range(self.n_brows):
            for k in range(self.indptr[i], self.indptr[i + 1]):
                j = self.indices[k]
                out[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] = self.data[k]
        return out

    @staticmethod
    def from_csr(a: CSR, bm: int = 128, bn: int = 128,
                 dtype=np.float32) -> "BSR":
        """CSR -> BSR, zero-padding the element shape up to the block
        grid.  Only blocks holding a nonzero are stored."""
        rows, cols, vals = a.to_coo()
        return BSR.from_coo(rows, cols, vals, a.shape, bm=bm, bn=bn, dtype=dtype)

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: Tuple[int, int], bm: int = 128, bn: int = 128,
                 dtype=np.float32) -> "BSR":
        """COO (element indices) -> BSR, zero-padding up to the block grid.
        Duplicates are summed; only blocks holding an entry are stored."""
        nbr = -(-shape[0] // bm)
        nbc = -(-shape[1] // bn)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        key = (rows // bm) * nbc + cols // bn
        order = np.argsort(key, kind="stable")
        rows, cols, vals, key = rows[order], cols[order], vals[order], key[order]
        ukey, start = np.unique(key, return_index=True)
        counts = np.diff(np.append(start, rows.size))
        block_id = np.repeat(np.arange(ukey.size), counts)
        data = np.zeros((ukey.size, bm, bn), dtype=dtype)
        np.add.at(data, (block_id, rows % bm, cols % bn), vals.astype(dtype))
        ubr = (ukey // nbc).astype(np.int32)
        ubc = (ukey % nbc).astype(np.int32)
        indptr = np.zeros(nbr + 1, dtype=np.int32)
        np.add.at(indptr, ubr + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        return BSR(indptr=indptr, indices=ubc, data=data,
                   shape=(nbr * bm, nbc * bn))

    def padded_uniform(self, kmax: int = 0) -> Tuple[np.ndarray, np.ndarray, int]:
        """Pad every block row to the max blocks per row: returns
        ``(block_cols [n_brows, kmax] int32 with -1 pad,
        blocks [n_brows, kmax, bm, bn], kmax)``.  A larger ``kmax`` may be
        forced to align the layouts of several ranks."""
        counts = np.diff(self.indptr)
        kmax = max(kmax, 1, int(counts.max()) if counts.size else 0)
        bm, bn = self.block_shape
        brow = np.repeat(np.arange(self.n_brows), counts)
        slot = np.arange(self.n_blocks) - np.repeat(self.indptr[:-1], counts)
        cols = np.full((self.n_brows, kmax), -1, dtype=np.int32)
        blocks = np.zeros((self.n_brows, kmax, bm, bn), dtype=self.data.dtype)
        cols[brow, slot] = self.indices
        blocks[brow, slot] = self.data
        return cols, blocks, kmax
