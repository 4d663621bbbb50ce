"""Vectorized CSR x CSR product (numpy; no scipy in the library path)."""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSR, expand_positions

# Expansion budget: the pre-merge intermediate arrays (rows/cols/vals of
# every a_ik * B[k, :] product) are bounded to ~this many entries per
# chunk, so dense-ish A rows against wide B rows no longer allocate
# O(nnz(A) * max_row(B)) at once (~3 int64/float64 arrays, so the peak
# per-chunk footprint is ~24 B * DEFAULT_CHUNK_PRODUCTS ≈ 50 MB).
DEFAULT_CHUNK_PRODUCTS = 1 << 21


def _expand_merge(a: CSR, b: CSR, b_counts: np.ndarray, r0: int, r1: int):
    """Row-expand A rows [r0, r1) against B and merge duplicates.

    Products enumerate in A row-major order and merge via stable sort +
    ``reduceat`` — the same order/association for every chunk split, so
    chunking never changes a bit of the output.
    """
    lo, hi = a.indptr[r0], a.indptr[r1]
    ak, av = a.indices[lo:hi], a.data[lo:hi]
    ai = np.repeat(np.arange(r0, r1), np.diff(a.indptr[r0: r1 + 1]))
    counts = b_counts[ak]
    take = expand_positions(b.indptr[ak], counts)
    if take.size == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), np.empty(0)
    rows = np.repeat(ai, counts)
    cols = b.indices[take]
    vals = np.repeat(av, counts) * b.data[take]
    key = rows * np.int64(b.shape[1]) + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq, start = np.unique(key, return_index=True)
    return (uniq // b.shape[1], uniq % b.shape[1],
            np.add.reduceat(vals, start))


def csr_matmul(a: CSR, b: CSR,
               chunk_products: int = DEFAULT_CHUNK_PRODUCTS) -> CSR:
    """C = A @ B by row expansion: every nonzero (i, k) of A contributes
    a_ik * B[k, :]; duplicates are summed per (i, j).

    The expansion is CHUNKED over contiguous A-row blocks so the
    intermediate product arrays stay under ``chunk_products`` entries
    (one block may exceed it only when a single row does): peak memory
    is bounded instead of O(nnz(A) * max_row(B)).  Chunk boundaries fall
    on row boundaries and each (i, j) group merges in the same stable
    order, so the result is bit-for-bit independent of ``chunk_products``.
    """
    assert a.shape[1] == b.shape[0], (a.shape, b.shape)
    shape = (a.shape[0], b.shape[1])
    b_counts = np.diff(b.indptr)
    # per-row expansion sizes -> cumulative products at each row boundary
    per_nnz = b_counts[a.indices]
    cum = np.concatenate([[0], np.cumsum(per_nnz)])[a.indptr]
    total = int(cum[-1])
    if total == 0:
        return CSR.from_coo(np.empty(0, np.int64), np.empty(0, np.int64),
                            np.empty(0), shape)
    parts = []
    r0 = 0
    n_rows = a.shape[0]
    while r0 < n_rows:
        r1 = int(np.searchsorted(cum, cum[r0] + chunk_products, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n_rows)  # at least one row per chunk
        parts.append(_expand_merge(a, b, b_counts, r0, r1))
        r0 = r1
    rows = np.concatenate([p[0] for p in parts])
    cols = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    # chunks are row-disjoint and ascending; each is already row-major
    return CSR.from_coo(rows, cols, vals, shape, sum_duplicates=False,
                        assume_sorted=True)
