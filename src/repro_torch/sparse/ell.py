"""ELLPACK (padded-row) container: the layout of the ELL SpMM kernel.

Every row is padded to the matrix's max nonzeros per row: two
``[n_rows, kmax]`` arrays of column ids and values.  Padding slots hold
``cols == -1`` and ``vals == 0``; consumers clamp the column to 0, so
padding is inert against any finite x.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ELL:
    """Row-padded sparse matrix: row i holds ``cols[i, :]`` / ``vals[i, :]``."""

    cols: np.ndarray   # int32 [n_rows, kmax], -1 = padding slot
    vals: np.ndarray   # float32 [n_rows, kmax], 0 on padding slots
    shape: Tuple[int, int]  # logical element shape (n_rows may exceed shape[0])

    @property
    def kmax(self) -> int:
        return int(self.cols.shape[1])

    @property
    def n_rows(self) -> int:
        return int(self.cols.shape[0])

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: Tuple[int, int], n_rows_pad: int = 0,
                 kmax: int = 0) -> "ELL":
        """COO -> ELL without per-row Python loops.  ``n_rows_pad`` adds
        all-padding rows and ``kmax`` forces a wider slot axis, to align
        the per-rank layouts of a rank-batched program."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        n_rows = max(shape[0], n_rows_pad)
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = np.bincount(rows, minlength=n_rows)
        kmax = max(kmax, 1, int(counts.max(initial=0)))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(rows.size) - starts[rows]
        out_cols = np.full((n_rows, kmax), -1, dtype=np.int32)
        out_vals = np.zeros((n_rows, kmax), dtype=np.float32)
        out_cols[rows, slot] = cols.astype(np.int32)
        out_vals[rows, slot] = vals.astype(np.float32)
        return ELL(cols=out_cols, vals=out_vals, shape=shape)

    @staticmethod
    def from_csr(a, n_rows_pad: int = 0, kmax: int = 0) -> "ELL":
        rows, cols, vals = a.to_coo()
        return ELL.from_coo(rows, cols, vals, a.shape,
                            n_rows_pad=n_rows_pad, kmax=kmax)


def stack_ell(per_rank: List[ELL],
              kmax: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Align ranks to one shared kmax and stack into the
    ``[n_procs, n_rows, kmax]`` cols/vals arrays of the rank-batched kernel."""
    kmax = max(kmax or 1, max(e.kmax for e in per_rank))
    n_rows = max(e.n_rows for e in per_rank)
    cols = np.full((len(per_rank), n_rows, kmax), -1, dtype=np.int32)
    vals = np.zeros((len(per_rank), n_rows, kmax), dtype=np.float32)
    for r, e in enumerate(per_rank):
        cols[r, : e.n_rows, : e.kmax] = e.cols
        vals[r, : e.n_rows, : e.kmax] = e.vals
    return cols, vals, kmax
