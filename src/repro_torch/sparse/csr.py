"""Minimal CSR/COO container for the host layer of the port.

Numpy only: the container is what the plan compiler reads, never what the
device program runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def expand_positions(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """``concat(starts[i] + arange(counts[i]))`` without a Python loop:
    the index ramp behind CSR row expansion (``csr_matmul``)."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(counts)
    intra = np.arange(total) - np.repeat(ends - counts, counts)
    return np.repeat(starts, counts) + intra


@dataclasses.dataclass
class CSR:
    indptr: np.ndarray   # int64 [n_rows + 1]
    indices: np.ndarray  # int64 [nnz]
    data: np.ndarray     # float64 [nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        sl = slice(self.indptr[i], self.indptr[i + 1])
        return self.indices[sl], self.data[sl]

    def matvec(self, v: np.ndarray) -> np.ndarray:
        out = np.zeros(self.shape[0], dtype=np.result_type(self.data, v))
        np.add.at(out, np.repeat(np.arange(self.shape[0]), np.diff(self.indptr)),
                  self.data * v[self.indices])
        return out

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        return rows, self.indices.copy(), self.data.copy()

    def transpose(self) -> "CSR":
        rows, cols, vals = self.to_coo()
        return CSR.from_coo(cols, rows, vals, (self.shape[1], self.shape[0]))

    def select_rows(self, rows: np.ndarray) -> "CSR":
        counts = self.indptr[rows + 1] - self.indptr[rows]
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        # each selected row's nnz range as one vectorised gather: start
        # offsets repeated per element plus an intra-row ramp
        starts = self.indptr[rows]
        take = np.repeat(starts - indptr[:-1], counts) + np.arange(indptr[-1])
        return CSR(indptr=indptr, indices=self.indices[take], data=self.data[take],
                   shape=(int(rows.size), self.shape[1]))

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: Tuple[int, int], sum_duplicates: bool = True,
                 assume_sorted: bool = False) -> "CSR":
        """``assume_sorted`` skips the row-major sort for input already in
        row-major order (only with ``sum_duplicates=False``)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if sum_duplicates and rows.size:
            key = rows * shape[1] + cols
            order = np.argsort(key, kind="stable")
            key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
            _, start = np.unique(key, return_index=True)
            summed = np.add.reduceat(vals, start) if vals.size else vals
            rows, cols, vals = rows[start], cols[start], summed
        elif assume_sorted:
            assert rows.size < 2 or (np.diff(rows) >= 0).all()
        else:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSR(indptr=indptr.astype(np.int64), indices=cols, data=vals, shape=shape)

    @staticmethod
    def from_dense(a: np.ndarray) -> "CSR":
        rows, cols = np.nonzero(a)
        return CSR.from_coo(rows, cols, a[rows, cols], a.shape, sum_duplicates=False)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        rows, cols, vals = self.to_coo()
        out[rows, cols] = vals
        return out
