"""The port's host layout against the JAX package's, exactly.

Same matrix, same partition, same tuner values through both plan
compilers: every array, pad, layout field and autotuner verdict must be
equal, and ``pack_vector`` / ``unpack_vector`` bit-equal.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.partition as ref_partition
import repro.core.spmv_jax as ref_spmv
import repro.sparse as ref_sparse
from repro.core.cost_model import TPU_V5E_LOCAL
from repro.core.topology import Topology as RefTopology

import repro_torch.core.partition as port_partition
import repro_torch.core.spmv_torch as port_spmv
import repro_torch.sparse as port_sparse
from repro_torch.core.cost_model import LocalComputeParams
from repro_torch.core.topology import Topology


def _owner_empty_rank(n, n_procs, seed):
    """Random ownership that leaves rank 1 without rows."""
    owner = np.random.default_rng(seed).integers(0, n_procs, size=n)
    owner[owner == 1] = 0
    return owner


# (name, matrix builder name + args, topology, partition kind)
CASES = [
    ("poisson_2x2", ("poisson_2d", (8,)), (2, 2), "contiguous"),
    ("aniso_2x4", ("rotated_anisotropic_2d", (12,)), (2, 4), "contiguous"),
    ("random_3x2_empty_rank", ("random_fixed_nnz", (50, 5)), (3, 2), "empty"),
    ("random_2x3_strided", ("random_fixed_nnz", (40, 4)), (2, 3), "strided"),
    ("aniso_3x2_strided", ("rotated_anisotropic_2d", (9,)), (3, 2), "strided"),
]


def _build(case):
    _, (gen, args), (nn, ppn), kind = case
    a_ref = getattr(ref_sparse, gen)(*args)
    a_port = getattr(port_sparse, gen)(*args)
    n = a_ref.shape[0]
    n_procs = nn * ppn
    if kind == "contiguous":
        parts = (ref_partition.contiguous_partition(n, n_procs),
                 port_partition.contiguous_partition(n, n_procs))
    elif kind == "strided":
        parts = (ref_partition.strided_partition(n, n_procs),
                 port_partition.strided_partition(n, n_procs))
    else:
        owner = _owner_empty_rank(n, n_procs, seed=n)
        parts = (ref_partition._from_owner(owner, n_procs, "owner"),
                 port_partition.partition_from_owner(owner, n_procs))
    return a_ref, a_port, parts, RefTopology(nn, ppn), Topology(nn, ppn)


def _compile_both(case):
    a_ref, a_port, (p_ref, p_port), t_ref, t_port = _build(case)
    ref = ref_spmv.compile_nap(a_ref, p_ref, t_ref, cache=False,
                               tuner=TPU_V5E_LOCAL)
    port = port_spmv.compile_nap(
        a_port, p_port, t_port, device="cpu",
        tuner=LocalComputeParams(**dataclasses.asdict(TPU_V5E_LOCAL)))
    for c in (ref, port):
        c.ensure_ell()
        c.ensure_ell_t()
        c.ensure_fused()
    return ref, port, (p_ref, p_port), (t_ref, t_port)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_generators_match(case):
    a_ref, a_port, *_ = _build(case)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a_port, f), getattr(a_ref, f))
    assert tuple(a_port.shape) == tuple(a_ref.shape)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compile_nap_arrays_equal(case):
    ref, port, _, _ = _compile_both(case)
    assert sorted(port.arrays) == sorted(ref.arrays)
    for k, v in ref.arrays.items():
        assert port.arrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port.arrays[k], v, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compile_nap_metadata_equal(case):
    ref, port, _, _ = _compile_both(case)
    assert (port.rows_pad, port.cols_pad) == (ref.rows_pad, ref.cols_pad)
    assert port.pads == ref.pads
    assert port.bsr_layout == ref.bsr_layout
    assert (port.ell_kmax, port.ell_t_kmax) == (ref.ell_kmax, ref.ell_t_kmax)
    assert port.autotune == ref.autotune


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pack_unpack_bit_equal(case):
    ref, port, (p_ref, p_port), (t_ref, t_port) = _compile_both(case)
    rng = np.random.default_rng(7)
    n = p_ref.n_rows
    for v in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        s_ref = ref_spmv.pack_vector(v, p_ref, t_ref, ref.rows_pad)
        s_port = port_spmv.pack_vector(v, p_port, t_port, port.rows_pad)
        assert s_port.dtype == s_ref.dtype
        np.testing.assert_array_equal(s_port, s_ref)
        np.testing.assert_array_equal(
            port_spmv.unpack_vector(s_port, p_port, t_port),
            ref_spmv.unpack_vector(s_ref, p_ref, t_ref))


def test_rectangular_layout_equal():
    """A [m, n] operator with independent row and column partitions."""
    rng = np.random.default_rng(3)
    m, n = 30, 44
    mat = (rng.random((m, n)) < 0.15) * rng.standard_normal((m, n))
    a_ref = ref_sparse.CSR.from_dense(mat)
    a_port = port_sparse.CSR.from_dense(mat)
    ref = ref_spmv.compile_nap(
        a_ref, ref_partition.contiguous_partition(m, 4), RefTopology(2, 2),
        col_part=ref_partition.strided_partition(n, 4), cache=False)
    port = port_spmv.compile_nap(
        a_port, port_partition.contiguous_partition(m, 4), Topology(2, 2),
        col_part=port_partition.strided_partition(n, 4), device="cpu",
        tuner=LocalComputeParams(**dataclasses.asdict(TPU_V5E_LOCAL)))
    for c in (ref, port):
        c.ensure_ell()
        c.ensure_ell_t()
    assert port.pads == ref.pads and port.autotune == ref.autotune
    for k, v in ref.arrays.items():
        np.testing.assert_array_equal(port.arrays[k], v, err_msg=k)


def test_default_tuner_picks_ell_on_stencil():
    """The H100 roofline keeps the paper's stencil on ELL both ways."""
    a = port_sparse.rotated_anisotropic_2d(64)
    c = port_spmv.compile_nap(a, port_partition.contiguous_partition(4096, 4),
                              Topology(2, 2), device="cpu")
    assert c.autotune["tuner"] == "h100_sxm_local"
    assert c.autotune["chosen"] == "ell"
    assert c.autotune["transpose"]["chosen"] == "ell"


# ---------------------------------------------------------------------------
# Standard (Algorithm 1) plan
# ---------------------------------------------------------------------------

import repro.core.comm_graph as ref_comm  # noqa: E402

import repro_torch.core.comm_graph as port_comm  # noqa: E402


def _msgs(lists):
    return [[(m.src, m.dst, m.idx.tolist()) for m in msgs] for msgs in lists]


def _compile_standard_both(case):
    a_ref, a_port, (p_ref, p_port), t_ref, t_port = _build(case)
    ref = ref_spmv.compile_standard(a_ref, p_ref, t_ref, cache=False,
                                    tuner=TPU_V5E_LOCAL)
    port = port_spmv.compile_standard(
        a_port, p_port, t_port, device="cpu",
        tuner=LocalComputeParams(**dataclasses.asdict(TPU_V5E_LOCAL)))
    for c in (ref, port):
        c.ensure_coo()
        c.ensure_ell()
        c.ensure_ell_t()
        c.ensure_fused()
    return ref, port


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_build_standard_plan_equal(case):
    a_ref, a_port, (p_ref, p_port), t_ref, t_port = _build(case)
    ref = ref_comm.build_standard_plan(a_ref.indptr, a_ref.indices, p_ref, t_ref)
    port = port_comm.build_standard_plan(a_port.indptr, a_port.indices, p_port,
                                         t_port)
    assert _msgs(port.sends) == _msgs(ref.sends)
    assert _msgs(port.recvs) == _msgs(ref.recvs)
    for r in range(t_port.n_procs):
        assert port.P(r) == ref.P(r)
        for t in port.P(r):
            np.testing.assert_array_equal(port.D(r, t), ref.D(r, t))
    want = {k: dataclasses.astuple(v) for k, v in ref_comm.standard_stats(ref).items()}
    got = {k: dataclasses.astuple(v) for k, v in port_comm.standard_stats(port).items()}
    assert got == want


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compile_standard_arrays_equal(case):
    ref, port = _compile_standard_both(case)
    assert sorted(port.arrays) == sorted(ref.arrays)
    for k, v in ref.arrays.items():
        assert port.arrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port.arrays[k], v, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compile_standard_metadata_equal(case):
    ref, port = _compile_standard_both(case)
    for f in ("rows_pad", "cols_pad", "buf_pad", "pair_pad", "nnz_pad",
              "ell_t_kmax", "n_x"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.autotune == ref.autotune
    sizes = [[m.size for m in ref.plan.sends[r] if m.dst == t]
             for r in range(port.topo.n_procs) for t in range(port.topo.n_procs)]
    np.testing.assert_array_equal(port.send_counts.reshape(-1),
                                  [s[0] if s else 0 for s in sizes])


@pytest.mark.parametrize("family", ["nap", "standard"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_padded_traffic_equal(case, family):
    a_ref, a_port, (p_ref, p_port), t_ref, t_port = _build(case)
    compile_ref = getattr(ref_spmv, f"compile_{family}")
    compile_port = getattr(port_spmv, f"compile_{family}")
    ref = compile_ref(a_ref, p_ref, t_ref, cache=False)
    port = compile_port(a_port, p_port, t_port, device="cpu")
    assert port_spmv.padded_traffic(port) == ref_spmv.padded_traffic(ref)


def test_rectangular_standard_layout_equal():
    """A [m, n] standard plan with independent row and column partitions."""
    rng = np.random.default_rng(4)
    m, n = 36, 28
    mat = (rng.random((m, n)) < 0.15) * rng.standard_normal((m, n))
    ref = ref_spmv.compile_standard(
        ref_sparse.CSR.from_dense(mat), ref_partition.contiguous_partition(m, 4),
        RefTopology(2, 2), col_part=ref_partition.strided_partition(n, 4),
        cache=False)
    port = port_spmv.compile_standard(
        port_sparse.CSR.from_dense(mat), port_partition.contiguous_partition(m, 4),
        Topology(2, 2), col_part=port_partition.strided_partition(n, 4),
        device="cpu", tuner=LocalComputeParams(**dataclasses.asdict(TPU_V5E_LOCAL)))
    for c in (ref, port):
        c.ensure_coo()
        c.ensure_ell()
        c.ensure_ell_t()
    assert (port.rows_pad, port.cols_pad, port.buf_pad, port.pair_pad) == \
        (ref.rows_pad, ref.cols_pad, ref.buf_pad, ref.pair_pad)
    assert port.autotune == ref.autotune
    for k, v in ref.arrays.items():
        np.testing.assert_array_equal(port.arrays[k], v, err_msg=k)
    assert port_spmv.padded_traffic(port) == ref_spmv.padded_traffic(ref)


def test_default_tuner_picks_ell_for_standard_on_stencil():
    a = port_sparse.rotated_anisotropic_2d(64)
    c = port_spmv.compile_standard(
        a, port_partition.contiguous_partition(4096, 4), Topology(2, 2),
        device="cpu")
    assert c.autotune["tuner"] == "h100_sxm_local"
    assert (c.autotune["chosen"], c.autotune["transpose"]["chosen"]) == ("ell", "ell")


def test_topology_helpers_match_reference():
    ref, port = RefTopology(3, 4), Topology(3, 4)
    ranks = np.arange(port.n_procs)
    np.testing.assert_array_equal(port.local_of_array(ranks), ref.local_of_array(ranks))
    np.testing.assert_array_equal(port.node_of_array(ranks), ref.node_of_array(ranks))
    for n in range(port.n_nodes):
        assert port.ranks_on_node(n) == ref.ranks_on_node(n)
    assert [[port.same_node(r, t) for t in ranks] for r in ranks] == \
        [[ref.same_node(r, t) for t in ranks] for r in ranks]


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (2, 4), (4, 3)])
def test_topology_rank_maps_match_reference(shape):
    ref, port = RefTopology(*shape), Topology(*shape)
    assert list(port.iter_ranks()) == list(ref.iter_ranks())
    for r in ref.iter_ranks():
        assert port.proc_node(r) == ref.proc_node(r)
        assert port.rank(*port.proc_node(r)) == r
    for bad in (-1, ref.n_procs):
        with pytest.raises(ValueError, match="out of range"):
            ref.proc_node(bad)
        with pytest.raises(ValueError, match="out of range"):
            port.proc_node(bad)
