"""AMG V-cycle and (preconditioned) Krylov solvers over the port's
distributed operators.

The solvers are float64 numpy on the host; every SpMV inside them may be
a plain callable or a :class:`repro_torch.api.NapOperator` (operators
are callable).  :func:`level_operators` builds a fully distributed
hierarchy on the device: one square operator for each level's A and one
rectangular operator for each P, whose ``.T`` view is the restriction,
so the V-cycle's grid transfers run as node-aware SpMVs too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.amg.hierarchy import Level, _diag
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.partition import contiguous_partition
from repro_torch.device import DeviceLike
from repro_torch.sparse.csr import CSR


@dataclasses.dataclass
class LevelOperators:
    """The distributed operators of one hierarchy level.

    ``a``: square operator of A_l (row == col partition); ``p``: the
    RECTANGULAR prolongation (row_part = level l's partition, col_part =
    level l+1's); ``r``: the restriction ``p.T``, the same compiled plan
    with send and recv roles reversed.  Each is ``None`` where the level
    is too small to distribute; :func:`amg_vcycle` then takes the
    level's host matvecs.
    """

    a: Optional[object] = None
    p: Optional[object] = None
    r: Optional[object] = None

    def galerkin(self, materialize: bool = False,
                 **materialize_kwargs) -> Optional[object]:
        """The coarse-grid operator ``R @ A @ P``, or None if a factor is
        missing.  By default the lazy
        :class:`repro_torch.api.ComposedOperator` (three chained
        node-aware SpMVs an apply); ``materialize=True`` collapses it
        through the distributed SpGEMM into a concrete operator on the
        coarse partitions (one SpMV an apply), with ``materialize_kwargs``
        passed to :meth:`repro_torch.api.ComposedOperator.materialize`."""
        if self.a is None or self.p is None or self.r is None:
            return None
        composed = self.r @ self.a @ self.p
        if not materialize:
            return composed
        return composed.materialize(**materialize_kwargs)


def level_operators(levels: Sequence[Level], topo, *, method: str = "nap",
                    backend: str = "torch", min_rows: Optional[int] = None,
                    parts: Optional[Sequence] = None,
                    materialize: bool = False,
                    spgemm_backend: Optional[str] = None, spgemm_dtype=None,
                    comm: Optional[str] = None, device: DeviceLike = None,
                    **kwargs) -> List[LevelOperators]:
    """One :class:`LevelOperators` (A and the rectangular P / R) per level.

    ``parts`` gives one partition per level (default: contiguous over
    each level's rows); level l's P takes ``row_part=parts[l],
    col_part=parts[l+1]``, so every interface of the V-cycle
    (``P.T @ r``, ``R @ A @ P``) chains with matching partitions.  A
    level with fewer rows than ``min_rows`` (default: the rank count)
    gets no operators.  ``comm`` picks the exchange PER LEVEL and PER
    DIRECTION: each A and P is its own :func:`repro_torch.api.operator`
    call, so ``comm="auto"`` reads that level's sparsity (verdicts in
    each operator's ``autotune_report()["comm"]``).  The operators run
    on ``device`` (CUDA by default); other ``kwargs`` go to
    :func:`repro_torch.api.operator`.

    ``materialize=True`` assembles every coarse matrix through the
    node-aware distributed SpGEMM (:func:`repro_torch.spgemm.galerkin_rap`
    on ``spgemm_backend``, by default the operators' ``backend``:
    ``"torch"`` on ``device`` in ``spgemm_dtype`` payloads, or the host
    float64 ``"simulate"``) instead of taking the hierarchy's host
    product: each ``A_c = R (A P)`` chains from the previous distributed
    product, is held against the hierarchy's host assembly (bit for bit
    on ``"simulate"``, to float32 round-off growing with the chain depth
    on ``"torch"``), and the coarse operators are built from it.

    In a multi-process job each operator compiles as a node-block plan
    (:func:`repro_torch.mesh.buffers.plan_mesh`) and every apply returns
    the whole vector in every process, so the host solvers run unchanged
    and alike everywhere.  The SpGEMM of ``materialize=True`` runs the
    whole layout in each process (the reference's has no block form
    either): every process assembles the same coarse matrices.
    """
    import repro_torch.api as nap

    floor = topo.n_procs if min_rows is None else min_rows
    if parts is None:
        parts = [contiguous_partition(lvl.a.shape[0], topo.n_procs)
                 for lvl in levels]
    a_mats = [lvl.a for lvl in levels]
    spgemm_backend = spgemm_backend or backend
    if materialize:
        from repro_torch.spgemm import assert_matches_host, galerkin_rap
        for i in range(len(levels) - 1):
            lvl = levels[i]
            r_mat = lvl.r if lvl.r is not None else lvl.p.transpose()
            a_mats[i + 1] = galerkin_rap(
                r_mat, a_mats[i], lvl.p, parts[i], parts[i + 1], topo,
                method=method if method in ("nap", "standard") else "nap",
                backend=spgemm_backend, device=device, dtype=spgemm_dtype)
            # float32 products chain level to level, so the tolerance
            # against the float64 host hierarchy grows with the depth
            assert_matches_host(a_mats[i + 1], levels[i + 1].a,
                                spgemm_backend, f"level {i + 1} A_c",
                                rtol=5e-5 * (i + 1))
    kw = dict(method=method, backend=backend, comm=comm, device=device, **kwargs)
    ops: List[LevelOperators] = []
    for i, lvl in enumerate(levels):
        entry = LevelOperators()
        if lvl.a.shape[0] >= floor:
            entry.a = nap.operator(a_mats[i], topo, parts[i], **kw)
            if lvl.p is not None:
                entry.p = nap.operator(lvl.p, topo, row_part=parts[i],
                                       col_part=parts[i + 1], **kw)
                entry.r = entry.p.T
        ops.append(entry)
    return ops


def jacobi(a: CSR, x: np.ndarray, b: np.ndarray, d: np.ndarray,
           sweeps: int = 2, omega: float = 2.0 / 3.0,
           spmv: Optional[Callable] = None) -> np.ndarray:
    """``sweeps`` damped Jacobi sweeps; ``spmv`` may be a callable or a
    NapOperator (operators are callable)."""
    mv = spmv or a.matvec
    for _ in range(sweeps):
        x = x + omega * (b - mv(x)) / d
    return x


def amg_vcycle(levels: List[Level], b: np.ndarray,
               x: Optional[np.ndarray] = None, lvl: int = 0,
               operators: Optional[Sequence[LevelOperators]] = None
               ) -> np.ndarray:
    """One V(2,2)-cycle.

    ``operators[lvl]`` is that level's :class:`LevelOperators` from
    :func:`level_operators`: A plus the rectangular P / R, so restriction
    runs as the node-aware ``P.T @ r`` and prolongation as ``P @ x_c``.
    ``None`` members, and every level when ``operators`` is None, take
    the level's host matvecs.
    """
    a = levels[lvl].a
    entry = operators[lvl] if operators is not None else LevelOperators()
    a_op, p_op, r_op = entry.a, entry.p, entry.r
    mv = a_op if a_op is not None else a.matvec
    if x is None:
        x = np.zeros_like(b)
    if lvl == len(levels) - 1 or levels[lvl].p is None:
        dense = a.to_dense()
        return np.linalg.lstsq(dense, b, rcond=None)[0]
    d = _diag(a)
    x = jacobi(a, x, b, d, spmv=mv)
    res = b - mv(x)
    # restriction: the node-aware transpose SpMV (P.T against the SAME
    # compiled plan as prolongation) where distributed, else host matvec
    coarse_b = (r_op @ res) if r_op is not None else levels[lvl].r.matvec(res)
    coarse_x = amg_vcycle(levels, coarse_b, None, lvl + 1, operators)
    x = x + ((p_op @ coarse_x) if p_op is not None
             else levels[lvl].p.matvec(coarse_x))
    return jacobi(a, x, b, d, spmv=mv)


def cg_solve(a: CSR, b: np.ndarray, tol: float = 1e-8, maxiter: int = 500,
             precond: Optional[Callable[[np.ndarray], np.ndarray]] = None,
             spmv: Optional[Callable] = None,
             x0: Optional[np.ndarray] = None,
             callback: Optional[Callable[[int, np.ndarray], None]] = None,
             verify_every: int = 0, verify_tol: float = 1e-6):
    """(Preconditioned) conjugate gradients; returns (x, iters, relres).

    ``spmv`` may be a plain callable or a NapOperator.  ``x0`` warm-starts
    the iteration; ``callback(it, x)`` fires after every iteration, and
    raising from it aborts the solve.  A restarted CG rebuilds its
    Krylov space from x, so its iterates differ from an uninterrupted
    run, but any solve driven to ``tol`` meets the same residual bound.

    ``verify_every=k`` (0 = off; the default path is bit-identical to a
    build without the feature) adds a SELF-VERIFYING replay check every k
    iterations: the recursive residual ``r`` is compared against the true
    residual ``b - A x`` (one extra SpMV).  A silently corrupted SpMV
    poisons the recursion — the two drift apart far beyond float
    round-off — so on a drift past ``verify_tol`` (relative to ``||b||``)
    the solver rolls back to the LAST VERIFIED iterate and replays; a
    transient fault replays clean and the trajectory re-joins the
    fault-free one exactly.  Drift that persists at the same iterate
    raises :class:`repro_torch.core.integrity.IntegrityError` (the corruption
    is not transient — retrying cannot help).
    """
    mv = spmv or a.matvec
    x = np.zeros_like(b) if x0 is None else np.array(x0, dtype=b.dtype)
    r = b - mv(x)
    z = precond(r) if precond else r
    p = z.copy()
    rz = float(r @ z)
    b_norm = max(float(np.linalg.norm(b)), 1e-30)
    rel = float(np.linalg.norm(r)) / b_norm
    if rel < tol:     # warm start already converged
        return x, 0, rel
    snap = (x.copy(), r.copy(), p.copy(), rz) if verify_every else None
    snap_it = 0
    failed_at = -1
    it = 1
    while it <= maxiter:
        ap = mv(p)
        alpha = rz / max(float(p @ ap), 1e-300)
        x += alpha * p
        r -= alpha * ap
        verified = False
        if verify_every and it % verify_every == 0:
            drift = float(np.linalg.norm((b - mv(x)) - r)) / b_norm
            if drift > verify_tol:
                if failed_at == it:
                    raise IntegrityError(
                        f"CG true-residual replay check failed twice at "
                        f"iteration {it} (drift {drift:.3e} > "
                        f"{verify_tol:.1e}): persistent SpMV corruption")
                failed_at = it
                x, r, p = snap[0].copy(), snap[1].copy(), snap[2].copy()
                rz = snap[3]
                it = snap_it + 1
                continue
            verified = True
            failed_at = -1
        if callback is not None:
            callback(it, x)
        rel = float(np.linalg.norm(r)) / b_norm
        if rel < tol:
            return x, it, rel
        z = precond(r) if precond else r
        rz_new = float(r @ z)
        p = z + (rz_new / max(rz, 1e-300)) * p
        rz = rz_new
        # snapshot AFTER the direction update: the saved tuple is the
        # complete loop-top state of iteration it+1, so a rollback replays
        # the clean trajectory exactly (a verify-point snapshot would pair
        # the new x/r with the PREVIOUS search direction)
        if verified:
            snap = (x.copy(), r.copy(), p.copy(), rz)
            snap_it = it
        it += 1
    return x, maxiter, float(np.linalg.norm(r)) / b_norm


def _safe_div(num: float, den: float) -> float:
    """num/den with a sign-preserving breakdown guard (BiCG denominators
    are legitimately negative — clamping with max() would flip search
    directions into garbage)."""
    if abs(den) < 1e-300:
        den = 1e-300 if den >= 0 else -1e-300
    return num / den


def bicgstab_solve(a: CSR, b: np.ndarray, tol: float = 1e-8,
                   maxiter: int = 500, spmv: Optional[Callable] = None,
                   spmv_t: Optional[Callable] = None,
                   verify_every: int = 0, verify_tol: float = 1e-6):
    """BiCG-stabilised solve for nonsymmetric systems; returns
    (x, iters, relres).

    BiCGSTAB itself needs only ``A @ v``, but the classic BiCG it
    stabilises needs ``A.T @ v`` — pass ``spmv_t`` (e.g. ``op.T``) to run
    plain BiCG instead, exercising the transpose SpMV the NapOperator
    front-end provides from the same compiled plan.

    ``verify_every=k`` adds the same true-residual replay check as
    :func:`cg_solve` (0 = off, default path untouched): drift between
    the recursive and true residual past ``verify_tol`` rolls back to
    the last verified iterate and replays; persistent drift at the same
    iterate raises :class:`repro_torch.core.integrity.IntegrityError`.
    """
    mv = spmv or a.matvec
    x = np.zeros_like(b)
    r = b - mv(x)
    b_norm = max(float(np.linalg.norm(b)), 1e-30)

    def _check(it, x, r, failed_at) -> bool:
        """Shared replay check: True means drift past tolerance (roll
        back); a REPEAT failure at the same iterate raises instead —
        retrying cannot fix a persistent corruption."""
        drift = float(np.linalg.norm((b - mv(x)) - r)) / b_norm
        if drift <= verify_tol:
            return False
        if failed_at == it:
            raise IntegrityError(
                f"true-residual replay check failed twice at "
                f"iteration {it} (drift {drift:.3e} > "
                f"{verify_tol:.1e}): persistent SpMV corruption")
        return True

    if spmv_t is not None:
        # plain BiCG (Lanczos biorthogonalisation) using A and A.T
        rt = r.copy()
        p, pt = r.copy(), rt.copy()
        rho = float(rt @ r)
        snap = (x.copy(), r.copy(), rt.copy(), p.copy(), pt.copy(), rho) \
            if verify_every else None
        snap_it, failed_at, it = 0, -1, 1
        while it <= maxiter:
            ap = mv(p)
            alpha = _safe_div(rho, float(pt @ ap))
            x += alpha * p
            r -= alpha * ap
            verified = False
            if verify_every and it % verify_every == 0:
                if _check(it, x, r, failed_at):
                    failed_at = it
                    x, r, rt, p, pt = (s.copy() for s in snap[:5])
                    rho = snap[5]
                    it = snap_it + 1
                    continue
                verified, failed_at = True, -1
            rel = float(np.linalg.norm(r)) / b_norm
            if rel < tol:
                return x, it, rel
            rt = rt - alpha * spmv_t(pt)
            rho_new = float(rt @ r)
            beta = _safe_div(rho_new, rho)
            p = r + beta * p
            pt = rt + beta * pt
            rho = rho_new
            # snapshot AFTER the direction updates — the complete loop-top
            # state of iteration it+1, so a rollback replays exactly
            if verified:
                snap = (x.copy(), r.copy(), rt.copy(), p.copy(), pt.copy(),
                        rho)
                snap_it = it
            it += 1
        return x, maxiter, float(np.linalg.norm(r)) / b_norm
    rt0 = r.copy()
    rho = alpha = omega = 1.0
    v = p = np.zeros_like(b)
    snap = (x.copy(), r.copy(), v.copy(), p.copy(), rho, alpha, omega) \
        if verify_every else None
    snap_it, failed_at, it = 0, -1, 1
    while it <= maxiter:
        rho_new = float(rt0 @ r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        rho = rho_new
        p = r + beta * (p - omega * v)
        v = mv(p)
        alpha = _safe_div(rho, float(rt0 @ v))
        s = r - alpha * v
        t = mv(s)
        omega = _safe_div(float(t @ s), float(t @ t))
        x += alpha * p + omega * s
        r = s - omega * t
        if verify_every and it % verify_every == 0:
            if _check(it, x, r, failed_at):
                failed_at = it
                x, r, v, p = (s_.copy() for s_ in snap[:4])
                rho, alpha, omega = snap[4:]
                it = snap_it + 1
                continue
            failed_at = -1
            # BiCGSTAB updates every recurrence at the loop TOP, so the
            # verify-point state IS the loop-top state of iteration it+1
            snap = (x.copy(), r.copy(), v.copy(), p.copy(), rho, alpha,
                    omega)
            snap_it = it
        rel = float(np.linalg.norm(r)) / b_norm
        if rel < tol:
            return x, it, rel
        it += 1
    return x, maxiter, float(np.linalg.norm(r)) / b_norm
