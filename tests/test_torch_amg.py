"""The port's AMG stack against the JAX package's.

The smoothed-aggregation hierarchy (aggregates and every level's a / p /
r) and ``csr_matmul`` are bit-equal to the reference's, on rotated
anisotropic problems at grids 24-48 and linear elasticity at grids 12-16
with its three rigid-body modes.  ``level_operators(comm="auto")``
resolves every level as the reference's ``choose_comm`` does (the same
postal constants given to both), and a V-cycle, PCG and BiCGSTAB through
the port's operators match the reference's solvers driven by its float64
simulate operators.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

import repro.amg as ref_amg
import repro.amg.hierarchy as ref_h
import repro.comm as ref_comm
import repro.core.cost_model as ref_cost
import repro.core.partition as ref_partition
import repro.sparse as ref_sparse
from repro.core.topology import Topology as RefTopology
from repro.sparse.csr import CSR as RefCSR

import repro_torch.amg as port_amg
import repro_torch.amg.hierarchy as port_h
import repro_torch.sparse as port_sparse
from repro_torch.core.cost_model import BLUE_WATERS_POSTAL
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.topology import Topology
from repro_torch.sparse.csr import CSR as PortCSR

TOL = dict(rtol=1e-4, atol=1e-5)


def rigid_modes(n):
    """Translations and the rotation of a 2-dof-per-node n x n grid."""
    xy = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  -1).reshape(-1, 2).astype(float)
    ns = np.zeros((2 * n * n, 3))
    ns[0::2, 0] = 1.0
    ns[1::2, 1] = 1.0
    ns[0::2, 2] = -xy[:, 1]
    ns[1::2, 2] = xy[:, 0]
    return ns


# (name, generator, grid, hierarchy keywords)
PROBLEMS = [
    ("aniso24", "rotated_anisotropic_2d", 24, dict(theta=0.1, coarse_size=16)),
    ("aniso32", "rotated_anisotropic_2d", 32, dict(theta=0.1, coarse_size=16)),
    ("aniso48", "rotated_anisotropic_2d", 48, dict(theta=0.1, coarse_size=16)),
    ("aniso40_theta0", "rotated_anisotropic_2d", 40, dict(coarse_size=16)),
    ("elasticity12", "linear_elasticity_2d", 12, dict(theta=0.05, coarse_size=20)),
    ("elasticity16", "linear_elasticity_2d", 16, dict(theta=0.05, coarse_size=20)),
]


def hierarchies(problem):
    _, gen, n, kw = problem
    a_ref, a_port = getattr(ref_sparse, gen)(n), getattr(port_sparse, gen)(n)
    ns = rigid_modes(n) if gen == "linear_elasticity_2d" else None
    return (ref_amg.smoothed_aggregation_hierarchy(a_ref, nullspace=ns, **kw),
            port_amg.smoothed_aggregation_hierarchy(a_port, nullspace=ns, **kw))


def assert_csr_equal(x, y, what):
    assert tuple(x.shape) == tuple(y.shape), what
    for f in ("indptr", "indices", "data"):
        got, want = getattr(y, f), getattr(x, f)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {f}")
        assert got.dtype == want.dtype, f"{what} {f}"


@pytest.mark.parametrize("problem", PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_hierarchy_is_bit_equal(problem):
    ref, port = hierarchies(problem)
    assert len(port) == len(ref) >= 2
    for i, (lr, lp) in enumerate(zip(ref, port)):
        assert_csr_equal(lr.a, lp.a, f"level {i} a")
        for f in ("p", "r"):
            if getattr(lr, f) is None:
                assert getattr(lp, f) is None
            else:
                assert_csr_equal(getattr(lr, f), getattr(lp, f), f"level {i} {f}")
        if lr.aggregates is None:
            assert lp.aggregates is None
        else:
            np.testing.assert_array_equal(lp.aggregates, lr.aggregates)


@pytest.mark.parametrize("seed", range(4))
def test_aggregation_and_tentative_prolongator_are_bit_equal(seed):
    """The list-based aggregation loop and the batched QRs on graphs
    with isolated nodes and stragglers, and aggregates smaller than the
    nullspace (zero-padded columns of Q, zero rows of R)."""
    rng = np.random.default_rng(seed)
    n = 120
    mat = (rng.random((n, n)) < 0.03) * rng.standard_normal((n, n))
    mat = mat + mat.T + np.diag(rng.uniform(1, 2, n))
    mat[:5] = 0.0
    mat[:, :5] = 0.0                       # isolated nodes, no diagonal
    s_ref = ref_h.strength_graph(RefCSR.from_dense(mat), theta=0.2)
    s_port = port_h.strength_graph(PortCSR.from_dense(mat), theta=0.2)
    assert_csr_equal(s_ref, s_port, "strength")
    agg = port_h.standard_aggregation(s_port)
    np.testing.assert_array_equal(agg, ref_h.standard_aggregation(s_ref))
    assert agg.dtype == np.int64 and agg.min() == 0
    ns = rng.standard_normal((n, 3))
    p_ref, bc_ref = ref_h.tentative_prolongator(agg, ns)
    p_port, bc_port = port_h.tentative_prolongator(agg, ns)
    assert_csr_equal(p_ref, p_port, "tentative")
    np.testing.assert_array_equal(bc_port, bc_ref)
    assert np.bincount(agg).min() < 3      # short aggregates were exercised


@pytest.mark.parametrize("chunk", [7, 100, 1 << 21])
@pytest.mark.parametrize("seed", range(3))
def test_csr_matmul_is_bit_equal(seed, chunk):
    rng = np.random.default_rng(40 + seed)
    x = (rng.random((37, 29)) < 0.2) * rng.standard_normal((37, 29))
    y = (rng.random((29, 41)) < 0.3) * rng.standard_normal((29, 41))
    x[3] = 0.0
    want = ref_amg.csr_matmul(RefCSR.from_dense(x), RefCSR.from_dense(y),
                              chunk_products=chunk)
    got = port_amg.csr_matmul(PortCSR.from_dense(x), PortCSR.from_dense(y),
                              chunk_products=chunk)
    assert_csr_equal(want, got, "product")
    np.testing.assert_allclose(got.to_dense(), x @ y, rtol=1e-12, atol=1e-12)


def _ref_postal():
    return ref_cost.PostalParams(**dataclasses.asdict(BLUE_WATERS_POSTAL))


@pytest.mark.parametrize("problem", [PROBLEMS[1], PROBLEMS[4]],
                         ids=[PROBLEMS[1][0], PROBLEMS[4][0]])
def test_level_operators_auto_verdicts_match_reference(problem):
    ref, port = hierarchies(problem)
    topo, t_ref = Topology(2, 4), RefTopology(2, 4)
    ops = port_amg.level_operators(port, topo, comm="auto", device="cpu")
    assert len(ops) == len(port)
    parts = [ref_partition.contiguous_partition(lv.a.shape[0], 8) for lv in ref]
    checked = 0
    for i, (lv, entry) in enumerate(zip(ref, ops)):
        if lv.a.shape[0] < topo.n_procs:
            assert entry.a is None and entry.p is None
            continue
        mats = [("a", lv.a, parts[i])]
        if lv.p is not None:
            mats.append(("p", lv.p, parts[i + 1]))
            assert entry.r.shape == lv.r.shape and entry.r.T is entry.p
        for name, mat, cpart in mats:
            want = ref_comm.choose_comm(mat.indptr, mat.indices, parts[i], t_ref,
                                        pairing="aligned", col_part=cpart,
                                        params=_ref_postal())
            got = getattr(entry, name).autotune_report()["comm"]
            assert got["resolved"] == want["forward"]["chosen"], (i, name)
            assert got["transpose_resolved"] == want["transpose"]["chosen"], (i, name)
            for d in ("forward", "transpose"):
                assert want[d]["wire_dtype"] == "f32"
                assert got[d] == want[d], (i, name, d)
            checked += 1
    assert checked >= 3


def _solver_setup(problem, topo_shape=(2, 2)):
    ref, port = hierarchies(problem)
    ops_port = port_amg.level_operators(port, Topology(*topo_shape), device="cpu")
    ops_ref = ref_amg.level_operators(ref, RefTopology(*topo_shape),
                                      backend="simulate", pairing="aligned")
    b = np.random.default_rng(12).standard_normal(port[0].a.shape[0])
    return ref, port, ops_ref, ops_port, b


SOLVER_PROBLEMS = [PROBLEMS[0], PROBLEMS[4]]


@pytest.mark.parametrize("problem", SOLVER_PROBLEMS, ids=[p[0] for p in SOLVER_PROBLEMS])
def test_vcycle_and_galerkin_match_reference(problem):
    ref, port, ops_ref, ops_port, b = _solver_setup(problem)
    want = ref_amg.amg_vcycle(ref, b, operators=ops_ref)
    got = port_amg.amg_vcycle(port, b, operators=ops_port)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, port_amg.amg_vcycle(port, b), **TOL)
    x = np.random.default_rng(3).standard_normal(port[1].a.shape[0])
    gal = ops_port[0].galerkin()
    rs, as_, ps = (sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
                   for m in (port[0].r, port[0].a, port[0].p))
    np.testing.assert_allclose(gal @ x, rs @ (as_ @ (ps @ x)), **TOL)
    np.testing.assert_allclose(gal @ x, port[1].a.matvec(x), **TOL)
    np.testing.assert_allclose(gal.T @ x, ps.T @ (as_.T @ (rs.T @ x)), **TOL)


@pytest.mark.parametrize("problem", SOLVER_PROBLEMS, ids=[p[0] for p in SOLVER_PROBLEMS])
def test_pcg_matches_reference(problem):
    """Six AMG-preconditioned CG iterations, with the true-residual check
    every 2, through the port's float32 operators and through the
    reference's float64 simulators."""
    ref, port, ops_ref, ops_port, b = _solver_setup(problem)

    def run(amg, levels, ops):
        hist = []
        x, _, rel = amg.cg_solve(
            levels[0].a, b, tol=1e-12, maxiter=6, spmv=ops[0].a,
            precond=lambda r: amg.amg_vcycle(levels, r, operators=ops),
            callback=lambda it, x: hist.append(
                np.linalg.norm(b - levels[0].a.matvec(x)) / np.linalg.norm(b)),
            verify_every=2, verify_tol=1e-4)
        return x, rel, np.array(hist)

    x_r, rel_r, h_r = run(ref_amg, ref, ops_ref)
    x_p, rel_p, h_p = run(port_amg, port, ops_port)
    assert h_p.size == h_r.size == 6 and h_r[-1] < 1e-2
    np.testing.assert_allclose(h_p, h_r, rtol=1e-3)
    np.testing.assert_allclose(x_p, x_r, **TOL)


def test_bicgstab_and_bicg_match_reference():
    """BiCGSTAB (A only) and plain BiCG (A and A.T) through the port's
    operators against the reference's solvers on its simulators."""
    ref, port, ops_ref, ops_port, b = _solver_setup(PROBLEMS[0])
    a_ref, a_port = ref[0].a, port[0].a
    for kw_r, kw_p in (({}, {}), (dict(spmv_t=ops_ref[0].a.T),
                                  dict(spmv_t=ops_port[0].a.T))):
        x_r, it_r, rel_r = ref_amg.bicgstab_solve(a_ref, b, tol=1e-12, maxiter=5,
                                                  spmv=ops_ref[0].a, **kw_r)
        x_p, it_p, rel_p = port_amg.bicgstab_solve(a_port, b, tol=1e-12, maxiter=5,
                                                   spmv=ops_port[0].a, **kw_p)
        assert it_p == it_r == 5
        np.testing.assert_allclose(rel_p, rel_r, rtol=1e-3)
        np.testing.assert_allclose(x_p, x_r, **TOL)


def test_cg_raises_on_persistent_corruption():
    _, port, _, ops_port, b = _solver_setup(PROBLEMS[0])
    bad = lambda v: ops_port[0].a @ v + 1e-3 * np.abs(v).max()  # noqa: E731
    with pytest.raises(IntegrityError, match="failed twice"):
        port_amg.cg_solve(port[0].a, b, maxiter=20, spmv=bad, verify_every=1)
