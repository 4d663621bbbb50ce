"""Smoothed-aggregation AMG setup: strength -> aggregates -> tentative
prolongator -> smoothed P -> Galerkin product R A P.

The paper's Figs. 8-10 measure the SpMV's communication on every level
of AMG hierarchies for a rotated anisotropic diffusion and a linear
elasticity problem; this module builds such hierarchies on the host in
float64 numpy.  Coarse levels are small and dense, the many-message
regime where the node-aware exchange wins most (paper Sec. 5).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.amg.matmul import csr_matmul
from repro_torch.sparse.csr import CSR


@dataclasses.dataclass
class Level:
    a: CSR
    p: Optional[CSR] = None       # prolongation to THIS level from coarse
    r: Optional[CSR] = None       # restriction (P^T)
    aggregates: Optional[np.ndarray] = None  # fine node -> aggregate id


def strength_graph(a: CSR, theta: float = 0.0) -> CSR:
    """Symmetric strength of connection: keep A_ij with
    |A_ij| >= theta * sqrt(|A_ii| |A_jj|); the diagonal is always kept."""
    rows, cols, vals = a.to_coo()
    diag = np.zeros(a.shape[0])
    dmask = rows == cols
    diag[rows[dmask]] = np.abs(vals[dmask])
    diag[diag == 0] = 1.0
    keep = np.abs(vals) >= theta * np.sqrt(diag[rows] * diag[cols])
    keep |= dmask
    return CSR.from_coo(rows[keep], cols[keep], vals[keep], a.shape,
                        sum_duplicates=False)


def standard_aggregation(s: CSR) -> np.ndarray:
    """Greedy aggregation on the strength graph, in row order:

    1. a node whose strong neighbourhood is wholly unaggregated seeds a
       new aggregate of that neighbourhood;
    2. each node left joins the aggregate (from pass 1) of its first
       aggregated strong neighbour;
    3. the nodes still left become singletons.

    The passes visit rows in order and each decision depends on the
    ones before it, so they stay loops; they run over Python lists,
    which cost far less per row than numpy calls on a few neighbours.
    """
    n = s.shape[0]
    indptr, indices = s.indptr.tolist(), s.indices.tolist()
    agg = [-1] * n
    next_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        for k in nbrs:
            if agg[k] != -1:
                break
        else:
            for k in nbrs:
                agg[k] = next_agg
            agg[i] = next_agg
            next_agg += 1
    attach = list(agg)
    for i in range(n):
        if agg[i] != -1:
            continue
        for k in indices[indptr[i]:indptr[i + 1]]:
            if agg[k] != -1:
                attach[i] = agg[k]
                break
    for i in range(n):
        if attach[i] == -1:
            attach[i] = next_agg
            next_agg += 1
    return np.array(attach, dtype=np.int64)


def tentative_prolongator(agg: np.ndarray, nullspace: np.ndarray
                          ) -> tuple[CSR, np.ndarray]:
    """QR of the near-nullspace over each aggregate: P has one block
    column per (aggregate, nullspace vector); returns (P, coarse
    nullspace).  The QRs of all aggregates of one size run as one
    batched call, the same LAPACK factorisation per aggregate."""
    n, nb = nullspace.shape
    n_agg = int(agg.max()) + 1
    order = np.argsort(agg, kind="stable")
    bounds = np.searchsorted(agg[order], np.arange(n_agg + 1))
    sizes = np.diff(bounds)
    q_sorted = np.zeros((n, nb))       # the rows of Q, in ``order``
    bc = np.zeros((n_agg * nb, nb))
    for sz in np.unique(sizes[sizes > 0]):
        ids = np.flatnonzero(sizes == sz)
        pos = bounds[ids][:, None] + np.arange(sz)          # [k, sz]
        q, r = np.linalg.qr(nullspace[order[pos]])          # [k, sz, nb]
        q_sorted[pos, : q.shape[2]] = q
        bc.reshape(n_agg, nb, nb)[ids, : r.shape[1]] = r    # short aggregates: zero rows
    rows = np.repeat(order, nb)
    cols = (np.repeat(agg[order], nb) * nb
            + np.tile(np.arange(nb), n)).astype(np.int64)
    p = CSR.from_coo(rows, cols, q_sorted.reshape(-1), (n, n_agg * nb),
                     sum_duplicates=False)
    return p, bc


def _diag(a: CSR) -> np.ndarray:
    """The diagonal of ``a``, with its zeros set to 1."""
    rows, cols, vals = a.to_coo()
    d = np.zeros(a.shape[0])
    m = rows == cols
    d[rows[m]] = vals[m]
    d[d == 0] = 1.0
    return d


def _spectral_radius_dinv_a(a: CSR, iters: int = 15, seed: int = 0) -> float:
    diag = _diag(a)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(a.shape[0])
    lam = 1.0
    for _ in range(iters):
        y = a.matvec(x) / diag
        lam = float(np.linalg.norm(y) / max(np.linalg.norm(x), 1e-30))
        x = y / max(np.linalg.norm(y), 1e-30)
    return max(lam, 1e-12)


def smooth_prolongator(a: CSR, t: CSR, omega_scale: float = 4.0 / 3.0) -> CSR:
    """P = (I - omega D^-1 A) T with omega = omega_scale / rho(D^-1 A)."""
    omega = omega_scale / _spectral_radius_dinv_a(a)
    rows, cols, vals = a.to_coo()
    diag = _diag(a)
    eye = np.arange(a.shape[0])
    s = CSR.from_coo(np.concatenate([rows, eye]), np.concatenate([cols, eye]),
                     np.concatenate([-omega * vals / diag[rows],
                                     np.ones(a.shape[0])]), a.shape)
    return csr_matmul(s, t)


def smoothed_aggregation_hierarchy(a: CSR, nullspace: Optional[np.ndarray] = None,
                                   theta: float = 0.0, max_levels: int = 12,
                                   coarse_size: int = 64) -> List[Level]:
    """Build the SA-AMG hierarchy; ``levels[0].a`` is the fine matrix and
    each coarse matrix is the host product ``R (A P)``."""
    if nullspace is None:
        nullspace = np.ones((a.shape[0], 1))
    levels = [Level(a=a)]
    b = nullspace
    while len(levels) < max_levels and levels[-1].a.shape[0] > coarse_size:
        a_l = levels[-1].a
        agg = standard_aggregation(strength_graph(a_l, theta))
        if (int(agg.max()) + 1) * b.shape[1] >= 0.8 * a_l.shape[0]:
            break  # coarsening stalled
        t, bc = tentative_prolongator(agg, b)
        p = smooth_prolongator(a_l, t)
        r = p.transpose()
        levels[-1].p = p
        levels[-1].r = r
        levels[-1].aggregates = agg
        levels.append(Level(a=csr_matmul(r, csr_matmul(a_l, p))))
        b = bc
    return levels
