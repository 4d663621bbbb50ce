"""Offline surrogates for the SuiteSparse matrices of Figs. 13-15.

The collection is not available offline, so each of the 13 matrices the
paper uses is replaced by a synthetic matrix with its published row
count (divided by ``scale``), its average nnz per row and its structure
class (banded stencil / power-law graph / nearly dense row blocks).
Benchmarks label them ``<name>-like``.  Statistics from the SuiteSparse
collection index (public metadata).  Equal, array for array, to the JAX
package's surrogates for every name, scale and seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.sparse.csr import CSR
from repro_torch.sparse.generators import random_fixed_nnz


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    n: int            # rows of the real matrix (divided by ``scale`` at build)
    nnz_per_row: int  # average
    family: str       # "stencil" | "graph" | "rowblock"


# The 13 largest real SuiteSparse matrices of the paper.  Row counts are
# divided by ``scale`` at build time: the shape of the communication
# pattern is what the experiments exercise.
SPECS: List[MatrixSpec] = [
    MatrixSpec("nlpkkt240", 27_993_600, 28, "stencil"),
    MatrixSpec("nlpkkt200", 16_240_000, 27, "stencil"),
    MatrixSpec("nlpkkt160", 8_345_600, 27, "stencil"),
    MatrixSpec("ML_Geer", 1_504_002, 73, "rowblock"),
    MatrixSpec("Flan_1565", 1_564_794, 75, "stencil"),
    MatrixSpec("Cube_Coup_dt0", 2_164_760, 59, "stencil"),
    MatrixSpec("CurlCurl_4", 2_380_515, 11, "stencil"),
    MatrixSpec("dielFilterV3real", 1_102_824, 81, "rowblock"),
    MatrixSpec("StocF-1465", 1_465_137, 14, "stencil"),
    MatrixSpec("audikw_1", 943_695, 82, "rowblock"),
    MatrixSpec("Serena", 1_391_349, 46, "stencil"),
    MatrixSpec("Geo_1438", 1_437_960, 44, "stencil"),
    MatrixSpec("Hook_1498", 1_498_023, 41, "stencil"),
]

BY_NAME: Dict[str, MatrixSpec] = {s.name: s for s in SPECS}


def _banded(n: int, nnz_per_row: int, seed: int) -> CSR:
    """Symmetric banded pattern: the diagonal and random offsets within a
    band of ~sqrt(n), a reordered 3D stencil (nlpkkt, Flan, Serena)."""
    rng = np.random.default_rng(seed)
    band = max(8, int(np.sqrt(n)))
    k = nnz_per_row
    offs = np.unique(np.concatenate([
        [0], rng.integers(1, band, size=2 * k)]))[: k // 2 + 1]
    rows, cols, vals = [], [], []
    idx = np.arange(n)
    for o in offs:
        r = idx[: n - o]
        rows += [r, r + o]
        cols += [r + o, r]
        v = rng.uniform(-1, 1, size=r.size)
        vals += [v, v]
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n, n))


def _rowblock(n: int, nnz_per_row: int, seed: int) -> CSR:
    """A few nearly dense rows (and their columns) over a banded
    background (audikw, dielFilter): the pattern behind the paper's
    strided partition."""
    rng = np.random.default_rng(seed)
    base = _banded(n, max(4, nnz_per_row // 2), seed)
    rows, cols, vals = base.to_coo()
    n_dense = max(1, n // 1000)
    dense_rows = rng.choice(n, size=n_dense, replace=False)
    width = min(n, nnz_per_row * 50)
    extra_r, extra_c = [], []
    for dr in dense_rows:
        c = rng.choice(n, size=width, replace=False)
        extra_r.append(np.full(width, dr))
        extra_c.append(c)
    er = np.concatenate(extra_r)
    ec = np.concatenate(extra_c)
    ev = rng.uniform(-1, 1, size=er.size)
    return CSR.from_coo(np.concatenate([rows, er, ec]),
                        np.concatenate([cols, ec, er]),
                        np.concatenate([vals, ev, ev]), (n, n))


def build(name: str, scale: int = 1024, seed: int = 0) -> CSR:
    """The ``name``-like surrogate at ``n = max(256, spec.n // scale)`` rows."""
    spec = BY_NAME[name]
    n = max(256, spec.n // scale)
    if spec.family == "rowblock":
        return _rowblock(n, spec.nnz_per_row, seed)
    if spec.family == "graph":
        return random_fixed_nnz(n, spec.nnz_per_row, seed, symmetric_pattern=True)
    return _banded(n, spec.nnz_per_row, seed)
