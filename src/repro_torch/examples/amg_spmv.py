"""AMG-preconditioned CG where EVERY SpMV, restriction and prolongation
included, is a node-aware operator.

This is the paper's driving application: algebraic multigrid solves spend
their time in per-level SpMVs whose communication patterns degrade on
coarse levels.  A rotated-anisotropic system is solved by AMG-PCG with a
fully distributed hierarchy: ``level_operators`` emits one square
operator per level's A and one RECTANGULAR operator per prolongation P
(``row_part`` = fine partition, ``col_part`` = coarse partition); the
restriction is ``P.T``, the node-aware transpose over the same compiled
plan.  The lazily composed Galerkin operator ``(R @ A @ P)`` is
cross-checked against the scipy triple product and then MATERIALISED
through the node-aware distributed SpGEMM (:mod:`repro_torch.spgemm`)
into a concrete coarse operator, first on the exact float64 simulate
backend, then on the device; the device hierarchy with every coarse
operator assembled on the device then preconditions PCG, and a BiCG
solve on a nonsymmetric system exercises ``op.T`` on a square system.

    PYTHONPATH=src python -m repro_torch.examples.amg_spmv [--device cpu]
"""
import argparse
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp

import repro_torch.api as nap
from repro_torch.amg import (amg_vcycle, bicgstab_solve, cg_solve,
                             level_operators, smoothed_aggregation_hierarchy)
from repro_torch.core.cost_model import BLUE_WATERS
from repro_torch.core.topology import Topology
from repro_torch.sparse import CSR, random_fixed_nnz, rotated_anisotropic_2d
from repro_torch.spgemm import torch_spgemm_runs


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="device of the device backend (default: CUDA)")
    args = ap.parse_args(argv)

    a = rotated_anisotropic_2d(48, eps=0.01, theta=np.pi / 6)
    a = CSR.from_dense(a.to_dense() + np.eye(a.shape[0]) * 1e-3)
    topo = Topology(n_nodes=8, ppn=4)
    levels = smoothed_aggregation_hierarchy(a, theta=0.1, coarse_size=64)
    print(f"AMG hierarchy: {[lvl.a.shape[0] for lvl in levels]} rows/level")

    # one LevelOperators per level: square A + rectangular P, R = P.T
    # (exact simulator backend) + modeled times, grid transfers included
    ops = level_operators(levels, topo, method="nap", backend="simulate")
    std_ops = level_operators(levels, topo, method="standard",
                              backend="simulate")
    for i, (lvl, op, op_std) in enumerate(zip(levels, ops, std_ops)):
        if op.a is None:
            continue
        ts = op_std.a.cost(BLUE_WATERS)["total"]
        tn = op.a.cost(BLUE_WATERS)["total"]
        line = (f"  level {i}: rows {lvl.a.shape[0]:6d}  modeled comm "
                f"std {ts:.2e}s  nap {tn:.2e}s  ({ts/tn:4.1f}x)")
        if op.p is not None:
            line += (f"  P {op.p.shape[0]}x{op.p.shape[1]} comm "
                     f"{op.p.cost(BLUE_WATERS)['total']:.2e}s")
        print(line)

    # -- the Galerkin operator as lazy composition ---------------------------
    # (R @ A @ P) chains three node-aware SpMVs (restriction through the
    # transpose); cross-check against the scipy triple product.
    gal = ops[0].galerkin()
    assert gal is not None and gal.shape == levels[1].a.shape
    rng = np.random.default_rng(0)
    xc = rng.standard_normal(gal.shape[1])
    p_sp = sp.csr_matrix(levels[0].p.to_dense())
    a_sp = sp.csr_matrix(levels[0].a.to_dense())
    want = (p_sp.T @ a_sp @ p_sp) @ xc
    np.testing.assert_allclose(gal @ xc, want, rtol=1e-5, atol=1e-6)
    print(f"Galerkin (R @ A @ P) @ x matches the scipy triple product "
          f"({gal.shape[0]}x{gal.shape[1]}, 3 chained node-aware SpMVs)")

    # -- materialised Galerkin: the node-aware distributed SpGEMM ------------
    # two distributed products (A@P then R@(AP)) carrying B-row blocks
    # through the three-step exchange; the float64 simulate path is bit
    # for bit the host csr_matmul assembly of the hierarchy.
    conc = gal.materialize(cross_check=True)
    np.testing.assert_allclose(conc @ xc, want, rtol=1e-9, atol=1e-9)
    assert np.array_equal(conc.a.data, levels[1].a.data)
    print(f"materialize(): concrete coarse operator "
          f"({conc.shape[0]}x{conc.shape[1]}, nnz {conc.a.nnz}) via the "
          f"distributed SpGEMM, bit for bit the host RAP, 1 SpMV/apply")

    # every grid transfer in the V-cycle is a rectangular operator
    n_rect = sum(1 for e in ops if e.p is not None)
    assert all(e.r.transposed and e.r.shape == e.p.shape[::-1]
               for e in ops if e.p is not None)
    print(f"{n_rect} rectangular P/R operator pairs in the V-cycle "
          f"(restriction = P.T through the node-aware transpose path)")

    b = rng.standard_normal(a.shape[0])
    x, iters, rel = cg_solve(
        a, b, tol=1e-8, maxiter=100,
        precond=lambda r: amg_vcycle(levels, r, operators=ops),
        spmv=ops[0].a)
    print(f"AMG-PCG with fully distributed V-cycle converged in {iters} "
          f"iters (relres {rel:.1e})")
    assert rel < 1e-8

    # -- the same hierarchy on the device: every coarse operator assembled
    # by the device SpGEMM (held against the host assembly inside), the
    # Galerkin operator materialised on the device, PCG over them
    runs = torch_spgemm_runs()
    dev_ops = level_operators(levels, topo, device=args.device,
                              materialize=True, spgemm_backend="torch")
    n_products = 2 * (len(levels) - 1)
    assert torch_spgemm_runs() - runs == n_products
    conc_dev = dev_ops[0].galerkin(materialize=True, cross_check=True)
    np.testing.assert_allclose(conc_dev @ xc, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    xd, iters_d, rel_d = cg_solve(
        a, b, tol=1e-5, maxiter=100,
        precond=lambda r: amg_vcycle(levels, r, operators=dev_ops),
        spmv=dev_ops[0].a)
    print(f"device: {n_products} Galerkin products on the device SpGEMM, "
          f"materialized R @ A @ P matches; AMG-PCG on device operators "
          f"converged in {iters_d} iters (relres {rel_d:.1e})")
    assert rel_d < 1e-5

    # -- transpose SpMV in anger: BiCG on a nonsymmetric system --------------
    # plain BiCG needs A.T @ v every iteration; op.T serves it from the
    # same compiled NAP plan with the send/recv roles reversed.
    an = random_fixed_nnz(1024, 9, seed=3)
    an = CSR.from_dense(an.to_dense() + np.eye(1024) * 12.0)  # diag-dominant
    op_n = nap.operator(an, topo, method="nap", backend="simulate")
    bn = rng.standard_normal(1024)
    xb, itb, relb = bicgstab_solve(an, bn, tol=1e-8, maxiter=200,
                                   spmv=op_n, spmv_t=op_n.T)
    print(f"BiCG with forward+transpose NAPSpMV converged in {itb} iters "
          f"(relres {relb:.1e})")
    assert relb < 1e-8


if __name__ == "__main__":
    main()
