"""The port's float64 simulate backend and the paper's own surfaces
against the JAX package, bit for bit.

The message-passing simulators (standard, node-aware and multi-step,
forward and transpose), ``DistSpMV``, the ``backend="simulate"``
executors, the paper's balanced slot pairing, ``paper_example_topology``,
``balanced_partition`` and ``make_partition``: the same inputs, made from
a seed, go through both packages and the float64 results must be EQUAL
(``np.array_equal``), the plans identical.  The paper's Example 2.1
(``tests/test_paper_example.py``) runs on both, then a seeded sweep over
square, rectangular, empty-rank, strided and balanced layouts, both
pairings and all three methods.
"""
import dataclasses

import numpy as np
import pytest

import repro.api as ref_api
import repro.comm as ref_comm
import repro.core.comm_graph as ref_cg
import repro.core.cost_model as ref_cost
import repro.core.partition as ref_part
import repro.core.spmv as ref_spmv
import repro.core.topology as ref_topo
from repro.sparse.csr import CSR as RefCSR

import repro_torch.api as port_api
import repro_torch.comm as port_comm
import repro_torch.core.comm_graph as port_cg
import repro_torch.core.partition as port_part
import repro_torch.core.spmv as port_spmv
import repro_torch.core.topology as port_topo
from repro_torch.core.cost_model import BLUE_WATERS, BLUE_WATERS_POSTAL
from repro_torch.sparse.csr import CSR as PortCSR

METHODS = ("nap", "standard", "multistep")


def _both(dense):
    return RefCSR.from_dense(dense), PortCSR.from_dense(dense)


def _example_dense():
    """The 6 x 6 matrix of the paper's Fig. 4 (as test_paper_example.py)."""
    rows_cols = {0: [0, 1, 3, 4, 5], 1: [1], 2: [2, 3], 3: [0, 3],
                 4: [1, 2, 4], 5: [0, 1, 5]}
    dense = np.zeros((6, 6))
    k = 0
    for i, js in rows_cols.items():
        for j in js:
            dense[i, j] = 1.0 + 0.25 * k
            k += 1
    return dense


def _msgs(lists):
    return [[(m.src, m.dst, m.idx.tolist()) for m in msgs] for msgs in lists]


def assert_same_plan(ref, port):
    """Two plans (standard, node-aware or multi-step) field by field."""
    if hasattr(ref, "direct"):
        assert ref.threshold == port.threshold
        assert_same_plan(ref.nap, port.nap)
        assert_same_plan(ref.direct, port.direct)
        return
    if hasattr(ref, "sends"):
        assert _msgs(ref.sends) == _msgs(port.sends)
        assert _msgs(ref.recvs) == _msgs(port.recvs)
        return
    assert ref.node_dests == port.node_dests
    assert ref.T == port.T and ref.U == port.U
    assert sorted(ref.node_idx) == sorted(port.node_idx)
    for k, v in ref.node_idx.items():
        np.testing.assert_array_equal(v, port.node_idx[k])
    for name in ("inter_sends", "inter_recvs", "local_init_sends",
                 "local_init_recvs", "local_final_sends", "local_final_recvs",
                 "local_full_sends", "local_full_recvs"):
        assert _msgs(getattr(ref, name)) == _msgs(getattr(port, name)), name


# ------------------------- the paper's Example 2.1 --------------------------

def test_paper_example_topology_and_partition():
    r, p = ref_topo.paper_example_topology(), port_topo.paper_example_topology()
    assert (r.n_nodes, r.ppn) == (p.n_nodes, p.ppn) == (3, 2)
    for kind in ("contiguous", "strided"):
        np.testing.assert_array_equal(
            ref_part.make_partition(kind, 6, 6).owner,
            port_part.make_partition(kind, 6, 6).owner)
    with pytest.raises(ValueError):
        port_part.make_partition("balanced", 6, 6)
    with pytest.raises(ValueError):
        port_part.make_partition("diagonal", 6, 6)


@pytest.mark.parametrize("pairing", ["balanced", "aligned"])
def test_paper_example_plans_and_simulators(pairing):
    """Example 2.1 on both packages: DistSpMV's plans equal, every
    simulator bit-equal in both directions, exact against A v (as
    tests/test_paper_example.py::test_spmv_exactness)."""
    a_ref, a_port = _both(_example_dense())
    t_ref, t_port = ref_topo.paper_example_topology(), port_topo.paper_example_topology()
    d_ref = ref_spmv.DistSpMV.build(a_ref, ref_part.contiguous_partition(6, 6),
                                    t_ref, pairing=pairing)
    d_port = port_spmv.DistSpMV.build(a_port, port_part.contiguous_partition(6, 6),
                                      t_port, pairing=pairing)
    assert_same_plan(d_ref.standard, d_port.standard)
    assert_same_plan(d_ref.nap, d_port.nap)
    v = np.random.default_rng(0).standard_normal(6)
    for fwd, tr, plan in (("simulate_standard_spmv", "simulate_standard_spmv_transpose",
                           "standard"),
                          ("simulate_nap_spmv", "simulate_nap_spmv_transpose", "nap")):
        got = getattr(port_spmv, fwd)(a_port, v, getattr(d_port, plan))
        np.testing.assert_array_equal(
            got, getattr(ref_spmv, fwd)(a_ref, v, getattr(d_ref, plan)))
        np.testing.assert_allclose(got, a_port.matvec(v), rtol=1e-13)
        np.testing.assert_array_equal(
            getattr(port_spmv, tr)(a_port, v, getattr(d_port, plan)),
            getattr(ref_spmv, tr)(a_ref, v, getattr(d_ref, plan)))
    # the headline claim: node-aware injects no more than standard
    s = port_cg.standard_stats(d_port.standard)
    n = port_cg.nap_stats(d_port.nap)
    assert n["inter"].total_bytes < s["inter"].total_bytes


# ------------------------- seeded layout sweep ------------------------------

def _layout(seed):
    """A random matrix and (topology, row / column partitions) in both
    packages: square or rectangular, contiguous / strided / balanced /
    empty-rank ownership, 1-3 nodes of 1-3 processes."""
    rng = np.random.default_rng(seed)
    nn, ppn = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    if nn * ppn == 1:
        nn = 2
    n_procs = nn * ppn
    m = int(rng.integers(6, 40))
    square = seed % 3 != 2
    n = m if square else int(rng.integers(4, 40))
    dense = (rng.random((m, n)) < rng.uniform(0.08, 0.4)) * rng.standard_normal((m, n))
    a_ref, a_port = _both(dense)
    kind = ["contiguous", "strided", "balanced", "empty"][seed % 4]
    if kind == "balanced" and not square:
        kind = "strided"

    def parts(rows, structure):
        if kind == "empty":
            # every row on the ranks of the first half: the rest own nothing
            owner = rng.integers(0, max(1, n_procs // 2), rows)
            return (ref_part._from_owner(owner, n_procs, "owner"),
                    port_part.partition_from_owner(owner, n_procs))
        kw = dict(indptr=a_ref.indptr, indices=a_ref.indices, seed=seed) \
            if structure else {}
        return (ref_part.make_partition(kind, rows, n_procs, **kw),
                port_part.make_partition(kind, rows, n_procs, **kw))

    rp = parts(m, True)
    cp = rp if square else parts(n, False)
    return (a_ref, a_port, rp, cp, ref_topo.Topology(nn, ppn),
            port_topo.Topology(nn, ppn), rng)


@pytest.mark.parametrize("seed", range(12))
def test_simulators_match_reference(seed):
    """Every simulator, forward and transpose, over both pairings and all
    three methods: plans identical, results bit-equal in float64, and
    within 1e-12 of the dense product."""
    a_ref, a_port, (rp_r, rp_p), (cp_r, cp_p), t_ref, t_port, rng = _layout(seed)
    np.testing.assert_array_equal(rp_r.owner, rp_p.owner)
    v = rng.standard_normal(a_port.shape[1])
    u = rng.standard_normal(a_port.shape[0])
    dense = a_port.to_dense()
    for pairing in ("aligned", "balanced"):
        plans = {
            "standard": (ref_cg.build_standard_plan(a_ref.indptr, a_ref.indices, rp_r,
                                                    t_ref, col_part=cp_r),
                         port_cg.build_standard_plan(a_port.indptr, a_port.indices,
                                                     rp_p, t_port, col_part=cp_p)),
            "nap": (ref_cg.build_nap_plan(a_ref.indptr, a_ref.indices, rp_r, t_ref,
                                          pairing=pairing, col_part=cp_r),
                    port_cg.build_nap_plan(a_port.indptr, a_port.indices, rp_p,
                                           t_port, pairing=pairing, col_part=cp_p)),
            "multistep": (ref_comm.build_multistep_plan(
                a_ref.indptr, a_ref.indices, rp_r, t_ref, pairing=pairing,
                col_part=cp_r, threshold=2),
                port_comm.build_multistep_plan(
                a_port.indptr, a_port.indices, rp_p, t_port, pairing=pairing,
                col_part=cp_p, threshold=2)),
        }
        sims = {
            "standard": ((ref_spmv.simulate_standard_spmv,
                          ref_spmv.simulate_standard_spmv_transpose),
                         (port_spmv.simulate_standard_spmv,
                          port_spmv.simulate_standard_spmv_transpose)),
            "nap": ((ref_spmv.simulate_nap_spmv, ref_spmv.simulate_nap_spmv_transpose),
                    (port_spmv.simulate_nap_spmv, port_spmv.simulate_nap_spmv_transpose)),
            "multistep": ((ref_comm.simulate_multistep_spmv,
                           ref_comm.simulate_multistep_spmv_transpose),
                          (port_comm.simulate_multistep_spmv,
                           port_comm.simulate_multistep_spmv_transpose)),
        }
        for method in METHODS:
            p_ref, p_port = plans[method]
            assert_same_plan(p_ref, p_port)
            (rf, rt), (pf, pt) = sims[method]
            w = pf(a_port, v, p_port)
            z = pt(a_port, u, p_port)
            np.testing.assert_array_equal(w, rf(a_ref, v, p_ref), err_msg=method)
            np.testing.assert_array_equal(z, rt(a_ref, u, p_ref), err_msg=method)
            np.testing.assert_allclose(w, dense @ v, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(z, dense.T @ u, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_simulate_operator_matches_reference(seed):
    """``operator(backend="simulate")`` of both packages: forward and
    ``.T`` for 1 and 3 right-hand sides bit-equal, float64; message
    statistics and the Blue Waters model equal; ``comm="auto"`` picks
    the same exchange with the same postal constants."""
    a_ref, a_port, (rp_r, rp_p), (cp_r, cp_p), t_ref, t_port, rng = _layout(seed)
    pairing = ("aligned", "balanced")[seed % 2]
    method = METHODS[seed % 3]
    kw_r = dict(topo=t_ref, row_part=rp_r, col_part=cp_r, backend="simulate",
                pairing=pairing)
    kw_p = dict(row_part=rp_p, col_part=cp_p, backend="simulate", pairing=pairing)
    ref = ref_api.operator(a_ref, method=method, **kw_r)
    port = port_api.operator(a_port, t_port, method=method, **kw_p)
    for nv in (1, 3):
        shape = lambda k: (k,) if nv == 1 else (k, nv)
        v = rng.standard_normal(shape(a_port.shape[1]))
        u = rng.standard_normal(shape(a_port.shape[0]))
        w, z = port @ v, port.T @ u
        assert w.dtype == np.float64 and z.dtype == np.float64
        np.testing.assert_array_equal(w, ref @ v)
        np.testing.assert_array_equal(z, ref.T @ u)
    assert port.local_compute == "numpy" and port.T.local_compute == "numpy"
    r_stats, p_stats = ref.stats(), port.stats()
    assert sorted(r_stats) == sorted(p_stats)
    for k in r_stats:
        assert dataclasses.asdict(r_stats[k]) == dataclasses.asdict(p_stats[k]), k
    assert ref.cost(ref_cost.BLUE_WATERS) == port.cost(BLUE_WATERS)
    verdict = ref_comm.choose_comm(a_ref.indptr, a_ref.indices, rp_r, t_ref, pairing=pairing,
                         col_part=cp_r,
                         params=ref_cost.PostalParams(**dataclasses.asdict(
                             BLUE_WATERS_POSTAL)))
    auto = port_api.operator(a_port, t_port, comm="auto", **kw_p)
    assert auto.method == verdict["forward"]["chosen"]
    assert auto.T.method == verdict["transpose"]["chosen"]
    v = rng.standard_normal(a_port.shape[1])
    np.testing.assert_array_equal(auto @ v, ref_api.operator(
        a_ref, method=verdict["forward"]["chosen"], **kw_r) @ v)


@pytest.mark.parametrize("seed", range(4))
def test_balanced_partition_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(20, 120))
    dense = (rng.random((n, n)) < 0.08) * rng.standard_normal((n, n))
    dense = dense + dense.T + np.eye(n)
    a_ref, a_port = _both(dense)
    n_procs = (2, 3, 4, 8)[seed]
    r = ref_part.balanced_partition(a_ref.indptr, a_ref.indices, n_procs, seed=seed)
    p = port_part.balanced_partition(a_port.indptr, a_port.indices, n_procs, seed=seed)
    np.testing.assert_array_equal(r.owner, p.owner)
    np.testing.assert_array_equal(r.perm, p.perm)
    np.testing.assert_array_equal(r.first, p.first)
    assert p.kind == "balanced"


@pytest.mark.parametrize("topo_shape", [(2, 2), (3, 2), (2, 4), (4, 3)])
def test_balanced_pairing_plans_match_reference(topo_shape):
    """The paper's T/U rule: the node-aware and multi-step plans built
    with ``pairing="balanced"`` are the reference's, message for message,
    and pair the inter-node receivers differently from the aligned rule
    once there are three or more nodes."""
    rng = np.random.default_rng(sum(topo_shape))
    n = 12 * topo_shape[0] * topo_shape[1]
    dense = (rng.random((n, n)) < 0.05) * rng.standard_normal((n, n))
    a_ref, a_port = _both(dense)
    t_ref, t_port = ref_topo.Topology(*topo_shape), port_topo.Topology(*topo_shape)
    rp, pp = (ref_part.contiguous_partition(n, t_ref.n_procs),
              port_part.contiguous_partition(n, t_port.n_procs))
    ref = ref_cg.build_nap_plan(a_ref.indptr, a_ref.indices, rp, t_ref,
                                pairing="balanced")
    port = port_cg.build_nap_plan(a_port.indptr, a_port.indices, pp, t_port,
                                  pairing="balanced")
    assert_same_plan(ref, port)
    assert_same_plan(
        ref_comm.build_multistep_plan(a_ref.indptr, a_ref.indices, rp, t_ref,
                                      pairing="balanced", threshold=2),
        port_comm.build_multistep_plan(a_port.indptr, a_port.indices, pp, t_port,
                                       pairing="balanced", threshold=2))
    d_ref = ref_spmv.DistSpMV.build(a_ref, rp, t_ref)
    d_port = port_spmv.DistSpMV.build(a_port, pp, t_port)
    assert_same_plan(d_ref.nap, d_port.nap)
    assert_same_plan(d_ref.standard, d_port.standard)
    aligned = port_cg.build_nap_plan(a_port.indptr, a_port.indices, pp, t_port)
    if topo_shape[0] > 2:   # with 3+ nodes the two rules pair differently
        assert _msgs(aligned.inter_recvs) != _msgs(port.inter_recvs)


def test_simulate_precision_and_guards():
    a_ref, a_port = _both(_example_dense())
    topo = port_topo.paper_example_topology()
    op = port_api.operator(a_port, topo, backend="simulate")
    v = np.random.default_rng(1).standard_normal(6)
    assert op(v).dtype == np.float64
    assert op(v, precision="float32").dtype == np.float32
    np.testing.assert_array_equal(op(v, precision="float64"), op @ v)
    with pytest.raises(ValueError):
        op(v, precision="float16")
    dev = port_api.operator(a_port, topo, device="cpu")
    with pytest.raises(NotImplementedError, match="simulate"):
        dev(v, precision="float64")
    assert dev(v, precision="float32").dtype == np.float32
    chain = op @ op.T
    assert chain(v, precision="float32").dtype == np.float32
    np.testing.assert_array_equal(chain(v), op @ (op.T @ v))
    assert "note" in op.autotune_report()
