"""The paper's random matrices (arXiv:1612.08060, Figs. 11-12): a
constant number of column draws a row, the diagonal among them, values
U(-1, 1), duplicates summed.

A frozen copy of ``repro_torch.sparse.generators.random_fixed_nnz``
(``symmetric_pattern=False``): the same draws from
``numpy.random.default_rng(seed)`` in the same order, and duplicates
summed in draw order, so the CSR is equal to the program's entry for
entry.  Each row is sorted on its own instead of through one COO sort.

``pattern_seed`` draws the columns from another seed than the values:
the values are the ones ``seed`` gives after its own column draw, so
``pattern_seed == seed`` (or None) is the program's matrix.  A fixed
pattern gives every seed the same sparsity, hence the same plan and the
same work, with its own values.
"""
from __future__ import annotations

import numpy as np

SEEDED = True


def build(n_rows: int, nnz_per_row: int, seed: int = 0, pattern_seed=None):
    """``(indptr, indices, data, shape)``: int64, int64, float64 CSR."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_rows, size=(n_rows, nnz_per_row))
    if pattern_seed is not None and pattern_seed != seed:
        cols = np.random.default_rng(pattern_seed).integers(
            0, n_rows, size=(n_rows, nnz_per_row))
    cols[:, 0] = np.arange(n_rows)
    vals = rng.uniform(-1.0, 1.0, size=n_rows * nnz_per_row).reshape(cols.shape)
    order = np.argsort(cols, axis=1, kind="stable")
    cols = np.take_along_axis(cols, order, axis=1)
    vals = np.take_along_axis(vals, order, axis=1)
    first = np.ones(cols.shape, dtype=bool)
    first[:, 1:] = cols[:, 1:] != cols[:, :-1]
    start = np.flatnonzero(first)
    indices = cols.reshape(-1)[start].astype(np.int64)
    data = np.add.reduceat(vals.reshape(-1), start)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(first.sum(axis=1), out=indptr[1:])
    return indptr, indices, data, (n_rows, n_rows)
