"""Rectangular operators, lazy composition and ``comm=`` at the port's
front door, against the JAX package.

Tall, wide and empty-rank ``[m, n]`` operators with independent row and
column partitions, every method, forward and transpose, against the
reference's float64 ``backend="simulate"`` operators at rtol 1e-4 /
atol 1e-5; ``(R @ A @ P) @ x`` and its ``.T`` against scipy; the
reference's compose-time errors; and ``comm="auto"`` resolving like the
reference on the skewed matrix of ``tests/test_comm.py``.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

import repro.api as ref_api
import repro.core.partition as ref_partition
from repro.core.topology import Topology as RefTopology
from repro.sparse.csr import CSR as RefCSR

import repro_torch.api as port_api
import repro_torch.core.partition as port_partition
from repro_torch.core.cost_model import BLUE_WATERS
from repro_torch.core.topology import Topology
from repro_torch.sparse.csr import CSR as PortCSR

TOL = dict(rtol=1e-4, atol=1e-5)
N_CASES = 9


def rect_case(seed):
    """A tall, wide or empty-rank (fewer columns than ranks) matrix with
    independent row and column partitions of one kind."""
    rng = np.random.default_rng(7000 + seed)
    nn, ppn = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    n_procs = nn * ppn
    kind = seed % 3
    if kind == 0:
        m = int(rng.integers(n_procs, 41))
        n = int(rng.integers(max(2, m // 3), m + 1))
    elif kind == 1:
        n = int(rng.integers(n_procs, 41))
        m = int(rng.integers(max(2, n // 3), n + 1))
    else:
        m = int(rng.integers(n_procs * 2 + 1, 41))
        n = int(rng.integers(1, max(2, n_procs)))
    mat = (rng.random((m, n)) < rng.uniform(0.1, 0.5)) * rng.standard_normal((m, n))
    pk = ["contiguous", "strided"][int(rng.integers(2))] + "_partition"
    parts = [(getattr(ref_partition, pk)(k, n_procs),
              getattr(port_partition, pk)(k, n_procs)) for k in (m, n)]
    return mat, parts, RefTopology(nn, ppn), Topology(nn, ppn), rng


@pytest.mark.parametrize("method", ["nap", "standard", "multistep"])
@pytest.mark.parametrize("seed", range(N_CASES))
def test_rectangular_matches_reference_simulate(seed, method):
    mat, ((rp_r, rp_p), (cp_r, cp_p)), t_ref, t_port, rng = rect_case(seed)
    ref = ref_api.operator(RefCSR.from_dense(mat), topo=t_ref, row_part=rp_r,
                           col_part=cp_r, method=method, backend="simulate",
                           pairing="aligned")
    op = port_api.operator(PortCSR.from_dense(mat), t_port, row_part=rp_p,
                           col_part=cp_p, method=method, device="cpu")
    assert op.shape == mat.shape and op.T.shape == mat.shape[::-1]
    assert op.range_part is rp_p and op.T.range_part is cp_p
    for nv in (None, 3):
        x = rng.standard_normal(mat.shape[1:] + (() if nv is None else (nv,)))
        y = rng.standard_normal(mat.shape[:1] + (() if nv is None else (nv,)))
        w, z = op @ x, op.T @ y
        assert w.shape == (mat.shape[0],) + x.shape[1:]
        assert z.shape == (mat.shape[1],) + y.shape[1:]
        np.testing.assert_allclose(w, ref @ x, **TOL)
        np.testing.assert_allclose(z, ref.T @ y, **TOL)
        np.testing.assert_allclose(w, mat @ x, **TOL)
        np.testing.assert_allclose(z, mat.T @ y, **TOL)


@pytest.mark.parametrize("seed", range(N_CASES))
def test_galerkin_composition_matches_scipy(seed):
    mat_p, ((_, rp), (_, cp)), _, topo, rng = rect_case(seed)
    m = mat_p.shape[0]
    mat_a = (rng.random((m, m)) < 0.3) * rng.standard_normal((m, m))
    a_op = port_api.operator(PortCSR.from_dense(mat_a), topo, rp, device="cpu")
    p_op = port_api.operator(PortCSR.from_dense(mat_p), topo, row_part=rp,
                             col_part=cp, device="cpu")
    gal = p_op.T @ a_op @ p_op
    assert isinstance(gal, port_api.ComposedOperator)
    assert gal.shape == (mat_p.shape[1],) * 2 and gal.range_part is cp
    assert len(gal.factors) == 3 and len(gal.stats()) == 3
    ps, as_ = sp.csr_matrix(mat_p), sp.csr_matrix(mat_a)
    x = rng.standard_normal((mat_p.shape[1], 2))
    np.testing.assert_allclose(gal @ x, (ps.T @ as_ @ ps) @ x, **TOL)
    np.testing.assert_allclose(gal.T @ x, (ps.T @ as_.T @ ps) @ x, **TOL)
    cost = gal.cost(BLUE_WATERS)
    assert cost["total"] == pytest.approx(sum(s["total"] for s in cost["stages"]))


def _pair(mat, topo, **parts):
    """The same operator in both packages (the reference on its simulate
    backend); ``parts`` maps a keyword to its (reference, port) value."""
    ref = ref_api.operator(RefCSR.from_dense(mat), topo=RefTopology(*topo),
                           backend="simulate", pairing="aligned",
                           **{k: v[0] for k, v in parts.items()})
    port = port_api.operator(PortCSR.from_dense(mat), Topology(*topo),
                             device="cpu", **{k: v[1] for k, v in parts.items()})
    return ref, port


def _both_parts(fn, n, n_procs):
    return (getattr(ref_partition, fn)(n, n_procs),
            getattr(port_partition, fn)(n, n_procs))


def test_composition_errors_match_reference():
    rng = np.random.default_rng(4)
    topo = (2, 2)
    a6 = _pair(rng.standard_normal((6, 6)), topo)
    b5 = _pair(rng.standard_normal((5, 7)), topo)
    strided = _both_parts("strided_partition", 6, 4)
    a6s = _pair(rng.standard_normal((6, 6)), topo, part=strided)
    for left, right in ((a6, b5), (a6, a6s)):
        msgs = []
        for side in (0, 1):
            with pytest.raises(ValueError) as err:
                left[side] @ right[side]
            msgs.append(str(err.value).split(":")[0])
        assert msgs[0] == msgs[1]
    # the interfaces that do match compose, also through .T
    assert (a6[1] @ a6[1].T @ a6[1]).shape == (6, 6)


def test_operator_argument_errors_match_reference():
    mat = np.random.default_rng(5).standard_normal((6, 4))
    rp, cp = _both_parts("contiguous_partition", 6, 4), \
        _both_parts("contiguous_partition", 4, 4)
    sq = _both_parts("contiguous_partition", 6, 4)
    cases = [dict(part=sq),                               # part= on [6, 4]
             dict(part=sq, row_part=rp),                  # both spellings
             dict(row_part=cp)]                           # wrong row count
    for kw in cases:
        msgs = []
        for side, (api, csr, topo, extra) in enumerate((
                (ref_api, RefCSR, RefTopology(2, 2), dict(backend="simulate")),
                (port_api, PortCSR, Topology(2, 2), dict(device="cpu")))):
            with pytest.raises(ValueError) as err:
                api.operator(csr.from_dense(mat), topo,
                             **{k: v[side] for k, v in kw.items()}, **extra)
            msgs.append(str(err.value).split(":")[0])
        assert msgs[0] == msgs[1], kw
    op = port_api.operator(PortCSR.from_dense(mat), Topology(2, 2),
                           row_part=rp[1], device="cpu")
    assert op.col_part.n_rows == 4 and op.shape == (6, 4)
    with pytest.raises(ValueError, match="comm must be one of"):
        port_api.operator(PortCSR.from_dense(mat), Topology(2, 2), comm="ring",
                          device="cpu")


def _skewed(topo_shape, rows_per_rank=16, bulk=12, seed=0):
    """``tests/test_comm.py::skewed_matrix``, rebuilt: a shared d = ppn
    background plus a d = 1 bulk in one node-pair direction only."""
    topo = Topology(*topo_shape)
    n = rows_per_rank * topo.n_procs
    rng = np.random.default_rng(seed)
    rows = [[] for _ in range(n)]
    for r in range(topo.n_procs):
        node, lr = topo.node_of(r), topo.local_of(r)
        remote = [q for q in range(topo.n_procs) if topo.node_of(q) != node]
        base = r * rows_per_rank
        for i in range(rows_per_rank):
            rows[base + i].append(base + i)
        for src in remote:
            for i in range(rows_per_rank):
                rows[base + i].append(src * rows_per_rank)
        if node == 0:
            src = remote[lr]
            for k in range(bulk):
                rows[base + int(rng.integers(rows_per_rank))].append(
                    src * rows_per_rank + 1 + k)
    indptr, indices = [0], []
    for rr in rows:
        indices.extend(sorted(set(rr)))
        indptr.append(len(indices))
    return (np.array(indptr, np.int64), np.array(indices, np.int64),
            rng.standard_normal(len(indices)), (n, n))


@pytest.mark.parametrize("topo_shape", [(2, 4), (2, 2), (3, 2)])
def test_comm_auto_resolves_like_reference(topo_shape):
    ind = _skewed(topo_shape)
    n = ind[3][0]
    n_procs = topo_shape[0] * topo_shape[1]
    ref = ref_api.operator(RefCSR(*ind), topo=RefTopology(*topo_shape),
                           part=ref_partition.contiguous_partition(n, n_procs),
                           backend="simulate", comm="auto", pairing="aligned")
    op = port_api.operator(PortCSR(*ind), Topology(*topo_shape),
                           port_partition.contiguous_partition(n, n_procs),
                           comm="auto", device="cpu")
    rr, pr = ref.autotune_report()["comm"], op.autotune_report()["comm"]
    for key in ("requested", "resolved", "transpose_resolved", "threshold"):
        assert pr[key] == rr[key], key
    for d in ("forward", "transpose"):
        assert {k: v["injected_inter_bytes"] for k, v in pr[d]["candidates"].items()} \
            == {k: v["injected_inter_bytes"] for k, v in rr[d]["candidates"].items()}
    assert op.method == pr["resolved"] and op.T.method == pr["transpose_resolved"]
    assert (op.transpose_executor is None) == (pr["resolved"] == pr["transpose_resolved"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 2))
    dense = sp.csr_matrix((ind[2], ind[1], ind[0]), shape=ind[3])
    np.testing.assert_allclose(op @ x, dense @ x, **TOL)
    np.testing.assert_allclose(op.T @ x, dense.T @ x, **TOL)
    pinned = port_api.operator(PortCSR(*ind), Topology(*topo_shape),
                               comm="standard", device="cpu")
    assert pinned.method == pinned.T.method == "standard"
    assert pinned.autotune_report()["comm_resolved"] == "standard"


@pytest.mark.parametrize("fwd,bwd", [("nap", "standard"), ("standard", "multistep")])
def test_transpose_view_reports_its_own_plan(fwd, bwd):
    """Where the two directions run different exchanges, ``op.T.stats()``
    and ``op.T.cost()`` describe the transpose executor's plan (the
    reference's view reports the forward plan in both directions)."""
    ind = _skewed((2, 4))
    a, topo = PortCSR(*ind), Topology(2, 4)
    op_f = port_api.operator(a, topo, comm=fwd, device="cpu")
    op_b = port_api.operator(a, topo, comm=bwd, device="cpu")
    mixed = dataclasses.replace(op_f, transpose_executor=op_b.executor)
    assert mixed.method == fwd and mixed.T.method == bwd
    assert mixed.stats() == op_f.stats() and mixed.T.stats() == op_b.stats()
    assert mixed.cost(BLUE_WATERS) == op_f.cost(BLUE_WATERS)
    assert mixed.T.cost(BLUE_WATERS) == op_b.cost(BLUE_WATERS)
    assert mixed.T.cost(BLUE_WATERS) != op_f.cost(BLUE_WATERS)
    chain = mixed.T @ mixed
    assert chain.cost(BLUE_WATERS)["total"] == pytest.approx(
        op_b.cost(BLUE_WATERS)["total"] + op_f.cost(BLUE_WATERS)["total"])
    x = np.random.default_rng(3).standard_normal(ind[3][0])
    dense = sp.csr_matrix((ind[2], ind[1], ind[0]), shape=ind[3])
    np.testing.assert_allclose(mixed.T @ x, dense.T @ x, **TOL)
