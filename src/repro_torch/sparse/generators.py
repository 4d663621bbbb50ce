"""Sparse test problems of the paper's experiments (Sec. 5).

* :func:`rotated_anisotropic_2d` — 9-point FE discretisation of
  ``-div(Q diag(1, eps) Q^T grad u)`` on an n x n grid, Q a rotation by
  theta (the paper's "2D rotated anisotropic" problem).
* :func:`poisson_2d` — the 5-point Laplacian.
* :func:`linear_elasticity_2d` — Q1 plane-stress linear elasticity on a
  regular grid, 2 dofs per node (the paper's second AMG problem).
* :func:`random_fixed_nnz` — random matrices with a constant number of
  nonzeros per row (Figs. 11-12).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSR


def poisson_2d(n: int) -> CSR:
    """Standard 5-point Laplacian on an n x n grid."""
    return rotated_anisotropic_2d(n, eps=1.0, theta=0.0, stencil="fd")


def _stencil_matrix(n: int, offsets, weights) -> CSR:
    """Assemble an n*n grid operator from a list of ((di, dj), w) entries."""
    rows, cols, vals = [], [], []
    idx = np.arange(n * n).reshape(n, n)
    for (di, dj), w in zip(offsets, weights):
        if w == 0.0:
            continue
        si = slice(max(0, -di), n - max(0, di))
        sj = slice(max(0, -dj), n - max(0, dj))
        ti = slice(max(0, di), n + min(0, di))
        tj = slice(max(0, dj), n + min(0, dj))
        r = idx[ti, tj].reshape(-1)
        c = idx[si, sj].reshape(-1)
        rows.append(r)
        cols.append(c)
        vals.append(np.full(r.size, w))
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n * n, n * n))


def rotated_anisotropic_2d(n: int, eps: float = 0.001,
                           theta: float = np.pi / 6.0,
                           stencil: str = "fe") -> CSR:
    """-div(Q diag(1, eps) Q^T grad u) on an n x n grid.

    ``stencil="fe"`` is the bilinear FE 9-point stencil (PyAMG's
    ``diffusion_stencil_2d`` convention); ``"fd"`` is the 5/9-point FD one.
    """
    c, s = np.cos(theta), np.sin(theta)
    cxx = c * c + eps * s * s
    cyy = eps * c * c + s * s
    cxy = (1.0 - eps) * c * s  # half the mixed coefficient

    if stencil == "fd":
        off = [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1), (-1, 1)]
        w = [2 * cxx + 2 * cyy, -cxx, -cxx, -cyy, -cyy,
             -cxy / 2, -cxy / 2, cxy / 2, cxy / 2]
        return _stencil_matrix(n, off, w)

    st = np.empty((3, 3))
    st[0, 0] = -cxx / 6 - cyy / 6 - cxy / 2   # NW  (di=+1, dj=-1)
    st[0, 1] = cyy / 3 - 2 * cxx / 3          # N
    st[0, 2] = -cxx / 6 - cyy / 6 + cxy / 2   # NE
    st[1, 0] = cxx / 3 - 2 * cyy / 3          # W
    st[1, 1] = 4.0 / 3.0 * (cxx + cyy)        # C
    st[1, 2] = cxx / 3 - 2 * cyy / 3          # E
    st[2, 0] = -cxx / 6 - cyy / 6 + cxy / 2   # SW
    st[2, 1] = cyy / 3 - 2 * cxx / 3          # S
    st[2, 2] = -cxx / 6 - cyy / 6 - cxy / 2   # SE
    offsets, weights = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            offsets.append((di, dj))
            weights.append(st[di + 1, dj + 1])
    return _stencil_matrix(n, offsets, weights)


def linear_elasticity_2d(n: int, E: float = 1e5, nu: float = 0.3) -> CSR:
    """Q1 plane-stress linear elasticity on an n x n node grid (2 dofs per
    node): the 8 x 8 element stiffness of a bilinear quad on unit square
    elements by 2 x 2 Gauss quadrature, assembled, with the x = 0 edge
    pinned (Dirichlet) so the matrix is SPD."""
    D = (E / (1.0 - nu * nu)) * np.array([
        [1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]])
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    ke = np.zeros((8, 8))
    for xi in gp:
        for eta in gp:
            dN = 0.25 * np.array([
                [-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)],
                [-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)]])
            J = dN @ np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=float)
            dNdx = np.linalg.solve(J, dN)
            B = np.zeros((3, 8))
            B[0, 0::2] = dNdx[0]
            B[1, 1::2] = dNdx[1]
            B[2, 0::2] = dNdx[1]
            B[2, 1::2] = dNdx[0]
            ke += B.T @ D @ B * np.linalg.det(J)

    nodes = np.arange(n * n).reshape(n, n)
    ne = n - 1
    e00 = nodes[:-1, :-1].reshape(-1)
    elems = np.stack([e00, e00 + 1, e00 + n + 1, e00 + n], axis=1)  # ccw quad
    dof = np.empty((ne * ne, 8), dtype=np.int64)
    dof[:, 0::2] = 2 * elems
    dof[:, 1::2] = 2 * elems + 1
    rows = np.repeat(dof, 8, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 8)).reshape(-1)
    vals = np.tile(ke.reshape(-1), ne * ne)
    a = CSR.from_coo(rows, cols, vals, (2 * n * n, 2 * n * n))
    fixed = np.concatenate([2 * nodes[0], 2 * nodes[0] + 1])
    return _apply_dirichlet(a, fixed)


def _apply_dirichlet(a: CSR, fixed: np.ndarray) -> CSR:
    """Drop the rows and columns of the ``fixed`` dofs and put ones on
    their diagonal."""
    rows, cols, vals = a.to_coo()
    fixed_set = np.zeros(a.shape[0], dtype=bool)
    fixed_set[fixed] = True
    keep = ~(fixed_set[rows] | fixed_set[cols])
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    rows = np.concatenate([rows, fixed])
    cols = np.concatenate([cols, fixed])
    vals = np.concatenate([vals, np.ones(fixed.size)])
    return CSR.from_coo(rows, cols, vals, a.shape)


def random_fixed_nnz(n_rows: int, nnz_per_row: int, seed: int = 0) -> CSR:
    """Random matrix, constant nnz/row, values U(-1, 1), diagonal included
    (the paper's Figs. 11-12 family)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_rows, size=(n_rows, nnz_per_row))
    cols[:, 0] = np.arange(n_rows)  # keep a diagonal
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    vals = rng.uniform(-1.0, 1.0, size=rows.size)
    return CSR.from_coo(rows, cols.reshape(-1), vals, (n_rows, n_rows))
