"""The paper's rotated anisotropic diffusion problem (arXiv:1612.08060,
Sec. 5): the bilinear FE 9-point stencil of ``-div(Q diag(1, eps) Q^T
grad u)`` on an n x n grid, Q a rotation by theta.

A frozen copy of ``repro_torch.sparse.generators.rotated_anisotropic_2d``
(``stencil="fe"``): the same weights from the same floating-point
expressions, rows in grid order, each row's columns ascending, so the
CSR is equal to the program's entry for entry.  It is assembled row by
row instead of through a COO sort, which is faster and needs no code of
the program.  The matrix does not depend on the seed.
"""
from __future__ import annotations

import numpy as np

SEEDED = False


def stencil(eps: float, theta: float) -> np.ndarray:
    """The 3 x 3 FE stencil, ``st[di + 1, dj + 1]`` the weight that row
    (i, j) gives column (i - di, j - dj)."""
    c, s = np.cos(theta), np.sin(theta)
    cxx = c * c + eps * s * s
    cyy = eps * c * c + s * s
    cxy = (1.0 - eps) * c * s
    st = np.empty((3, 3))
    st[0, 0] = -cxx / 6 - cyy / 6 - cxy / 2
    st[0, 1] = cyy / 3 - 2 * cxx / 3
    st[0, 2] = -cxx / 6 - cyy / 6 + cxy / 2
    st[1, 0] = cxx / 3 - 2 * cyy / 3
    st[1, 1] = 4.0 / 3.0 * (cxx + cyy)
    st[1, 2] = cxx / 3 - 2 * cyy / 3
    st[2, 0] = -cxx / 6 - cyy / 6 + cxy / 2
    st[2, 1] = cyy / 3 - 2 * cxx / 3
    st[2, 2] = -cxx / 6 - cyy / 6 - cxy / 2
    return st


def build(n: int, eps: float, theta: float, seed: int = 0):
    """``(indptr, indices, data, shape)``: int64, int64, float64 CSR of
    the n*n x n*n operator."""
    st = stencil(eps, theta)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    cols, vals, live = [], [], []
    # ascending columns: the row above first (di = +1), then left to right
    for di in (1, 0, -1):
        for dj in (1, 0, -1):
            w = st[di + 1, dj + 1]
            if w == 0.0:
                continue
            si, sj = i - di, j - dj
            live.append(((si >= 0) & (si < n) & (sj >= 0) & (sj < n)).reshape(-1))
            cols.append((si * n + sj).reshape(-1))
            vals.append(np.full(n * n, w))
    live = np.stack(live, axis=1)
    indices = np.stack(cols, axis=1)[live].astype(np.int64)
    data = np.stack(vals, axis=1)[live]
    indptr = np.zeros(n * n + 1, dtype=np.int64)
    np.cumsum(live.sum(axis=1), out=indptr[1:])
    return indptr, indices, data, (n * n, n * n)
