"""The port's exchange strategies against the JAX package's.

The multi-step plan, its duplication counts, every array and pad of
``compile_multistep``, ``planned_traffic``, ``multistep_stats``,
``padded_traffic`` and the ``choose_comm`` verdicts (the same postal
constants passed to both packages) are equal to the reference's over
square, rectangular, empty-rank and strided layouts and thresholds 1, 2,
3 and "auto".  The multi-step forward and transpose match the
reference's float64 simulators and its shard_map program at rtol 1e-4 /
atol 1e-5; the live-slot direct exchange is bit-equal to the literal
padded one, and ``threshold=1`` to the nap exchange.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.comm as ref_comm
import repro.core.cost_model as ref_cost
import repro.core.partition as ref_partition
import repro.core.spmv_jax as ref_spmv
import repro.sparse as ref_sparse
from repro.core.cost_model import TPU_V5E_LOCAL, TPU_V5E_POSTAL
from repro.core.topology import Topology as RefTopology
from repro.sparse.csr import CSR as RefCSR

import repro_torch.api as port_api
import repro_torch.comm as port_comm
import repro_torch.core.cost_model as port_cost
import repro_torch.core.partition as port_partition
import repro_torch.core.spmv_torch as port_spmv
import repro_torch.sparse as port_sparse
from repro_torch.core.topology import Topology
from repro_torch.sparse.csr import CSR as PortCSR

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
THRESHOLDS = [1, 2, 3, "auto"]
WIRE_DTYPES = ("f32", "bf16", "fp8_e4m3")
PORT_TUNER = port_cost.LocalComputeParams(**dataclasses.asdict(TPU_V5E_LOCAL))


def skewed_rows(topo, rows_per_rank=16, bulk=12, seed=0):
    """Rows of the matrix of ``tests/test_comm.py::skewed_matrix``: every
    rank needs one column of each remote rank that its whole node needs
    too (d = ppn), and each node-0 rank pulls ``bulk`` columns of its
    node-1 peer that nobody else wants (d = 1)."""
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
    data = rng.standard_normal(len(indices))
    return (np.array(indptr, np.int64), np.array(indices, np.int64), data,
            (n, n))


def _dense_rect(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((m, n)) < density) * rng.standard_normal((m, n))


def _parts(kind, n, n_procs, seed):
    if kind == "empty":
        owner = np.random.default_rng(seed).integers(0, n_procs, size=n)
        owner[owner == 1] = 0
        return (ref_partition._from_owner(owner, n_procs, "owner"),
                port_partition.partition_from_owner(owner, n_procs))
    mk = f"{kind}_partition"
    return (getattr(ref_partition, mk)(n, n_procs),
            getattr(port_partition, mk)(n, n_procs))


def make_layout(name):
    """(a_ref, a_port, (rp_ref, rp_port), (cp_ref, cp_port), t_ref, t_port)."""
    if name == "skewed_2x4":
        nn, ppn = 2, 4
        ind = skewed_rows(Topology(nn, ppn))
        a_ref, a_port = RefCSR(*ind), PortCSR(*ind)
        rk = ck = "contiguous"
    elif name in ("aniso_2x2", "random_2x3_strided", "random_3x2_empty"):
        gen, args, (nn, ppn), rk = {
            "aniso_2x2": ("rotated_anisotropic_2d", (10,), (2, 2), "contiguous"),
            "random_2x3_strided": ("random_fixed_nnz", (60, 6), (2, 3), "strided"),
            "random_3x2_empty": ("random_fixed_nnz", (50, 5), (3, 2), "empty"),
        }[name]
        a_ref, a_port = getattr(ref_sparse, gen)(*args), getattr(port_sparse, gen)(*args)
        ck = rk
    else:
        m, n, (nn, ppn), rk, ck = {
            "rect_tall_2x2": (40, 13, (2, 2), "contiguous", "strided"),
            "rect_wide_3x2": (18, 45, (3, 2), "strided", "contiguous"),
            "rect_empty_2x3": (30, 4, (2, 3), "contiguous", "contiguous"),
        }[name]
        dense = _dense_rect(m, n, 0.3, seed=m * n)
        a_ref, a_port = RefCSR.from_dense(dense), PortCSR.from_dense(dense)
    m, n = a_ref.shape
    rows = _parts(rk, m, nn * ppn, seed=m)
    cols = rows if (m == n and rk == ck) else _parts(ck, n, nn * ppn, seed=n + 1)
    return a_ref, a_port, rows, cols, RefTopology(nn, ppn), Topology(nn, ppn)


LAYOUTS = ["skewed_2x4", "aniso_2x2", "random_2x3_strided", "random_3x2_empty",
           "rect_tall_2x2", "rect_wide_3x2", "rect_empty_2x3"]


def _ms_plans(layout, thr):
    a_ref, a_port, (rp_r, rp_p), (cp_r, cp_p), t_ref, t_port = make_layout(layout)
    ref = ref_comm.build_multistep_plan(a_ref.indptr, a_ref.indices, rp_r, t_ref,
                                        pairing="aligned", col_part=cp_r,
                                        threshold=thr)
    port = port_comm.build_multistep_plan(a_port.indptr, a_port.indices, rp_p,
                                          t_port, col_part=cp_p, threshold=thr)
    return ref, port


def _same_messages(ref_lists, port_lists):
    assert len(ref_lists) == len(port_lists)
    for rm, pm in zip(ref_lists, port_lists):
        assert [(m.src, m.dst) for m in rm] == [(m.src, m.dst) for m in pm]
        for x, y in zip(rm, pm):
            np.testing.assert_array_equal(x.idx, y.idx)


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_multistep_plan_matches_reference(layout, thr):
    ref, port = _ms_plans(layout, thr)
    assert port.threshold == ref.threshold
    for field in ("inter_sends", "inter_recvs", "local_init_sends",
                  "local_init_recvs", "local_final_sends", "local_final_recvs",
                  "local_full_sends", "local_full_recvs"):
        _same_messages(getattr(ref.nap, field), getattr(port.nap, field))
    _same_messages(ref.direct.sends, port.direct.sends)
    _same_messages(ref.direct.recvs, port.direct.recvs)
    rs, ps = ref_comm.multistep_stats(ref), port_comm.multistep_stats(port)
    assert {k: dataclasses.asdict(v) for k, v in rs.items()} == \
        {k: dataclasses.asdict(v) for k, v in ps.items()}
    for direction in ("forward", "transpose"):
        for nv in (1, 3):
            _same_traffic(ref_comm.planned_traffic(ref, nv=nv, direction=direction),
                          port_comm.planned_traffic(port, nv=nv, direction=direction))
    machine = ref_cost.BLUE_WATERS
    assert ref_cost.multistep_cost(ref, machine) == \
        port_cost.multistep_cost(port, port_cost.BLUE_WATERS)


def _same_traffic(ref, port):
    """Both payloads name their wire dtype (f32 here)."""
    assert ref["wire_dtype"] == port["wire_dtype"] == "f32"
    assert ref == port


@pytest.mark.parametrize("layout", LAYOUTS)
def test_duplication_counts_match(layout):
    a_ref, a_port, (rp_r, rp_p), (cp_r, cp_p), t_ref, t_port = make_layout(layout)
    from repro.core.comm_graph import _offproc_pairs
    t, _, j = _offproc_pairs(a_ref.indptr, a_ref.indices, rp_r, cp_r)
    np.testing.assert_array_equal(
        ref_comm.duplication_counts(t, j, t_ref, a_ref.shape[1]),
        port_comm.duplication_counts(t, j, t_port, a_port.shape[1]))


def _compile_both(layout, thr):
    a_ref, a_port, (rp_r, rp_p), (cp_r, cp_p), t_ref, t_port = make_layout(layout)
    ref = ref_spmv.compile_multistep(a_ref, rp_r, t_ref, cache=False,
                                     tuner=TPU_V5E_LOCAL, col_part=cp_r,
                                     threshold=thr)
    port = port_spmv.compile_multistep(a_port, rp_p, t_port, tuner=PORT_TUNER,
                                       col_part=cp_p, threshold=thr, device="cpu")
    return ref, port, a_port, (rp_p, cp_p, t_port)


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_compile_multistep_matches_reference(layout, thr):
    ref, port, *_ = _compile_both(layout, thr)
    assert port.comm == ref.comm == "multistep"
    assert (port.rows_pad, port.cols_pad) == (ref.rows_pad, ref.cols_pad)
    assert port.pads == ref.pads
    assert sorted(port.arrays) == sorted(ref.arrays)
    for k, v in ref.arrays.items():
        np.testing.assert_array_equal(port.arrays[k], np.asarray(v), err_msg=k)
        assert port.arrays[k].dtype == np.asarray(v).dtype, k
    assert port.autotune == ref.autotune
    assert port_spmv.padded_traffic(port) == ref_spmv.padded_traffic(ref)


def _apply(c, shards, direction, fmt, **kw):
    fn = port_spmv.nap_forward if direction == "forward" else port_spmv.nap_transpose
    return fn(c, shards, local_compute=fmt, **kw)


@pytest.mark.parametrize("fmt", ["ell", "coo"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_multistep_matches_reference_simulator(layout, fmt):
    """Forward and transpose, nv = 1 and 3, against the reference's float64
    multi-step simulators; the live-slot direct exchange bit-equal to the
    literal padded one."""
    ref, port, a, (rp, cp, topo) = _compile_both(layout, "auto")
    rng = np.random.default_rng(7)
    m, n = a.shape
    a_ref = make_layout(layout)[0]
    for nv in (1, 3):
        v = rng.standard_normal((n, nv))
        u = rng.standard_normal((m, nv))
        want_w = np.stack([ref_comm.simulate_multistep_spmv(a_ref, v[:, i], ref.ms_plan)
                           for i in range(nv)], axis=1)
        want_z = np.stack([ref_comm.simulate_multistep_spmv_transpose(
            a_ref, u[:, i], ref.ms_plan) for i in range(nv)], axis=1)
        for direction, x, part_in, pad, part_out, want in (
                ("forward", v, cp, port.cols_pad, rp, want_w),
                ("transpose", u, rp, port.rows_pad, cp, want_z)):
            shards = port_spmv.pack_vector(x, part_in, topo, pad)
            live = _apply(port, shards, direction, fmt)
            literal = _apply(port, shards, direction, fmt, live_direct=False)
            assert torch.equal(live, literal), (direction, nv)
            got = port_spmv.unpack_vector(live.numpy(), part_out, topo)
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_threshold_one_is_nap_bit_for_bit(layout):
    a_ref, a, (_, rp), (_, cp), _, topo = make_layout(layout)
    ms = port_api.operator(a, topo, row_part=rp, col_part=cp,
                           method="multistep", threshold=1, device="cpu")
    nap = port_api.operator(a, topo, row_part=rp, col_part=cp, device="cpu")
    c_ms, c_nap = ms.executor.compiled, nap.executor.compiled
    assert c_ms.pads["direct"] == 1 and not c_ms.arrays["direct_send"].any()
    for k, arr in c_nap.arrays.items():
        np.testing.assert_array_equal(c_ms.arrays[k], arr, err_msg=k)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((a.shape[1], 2))
    u = rng.standard_normal((a.shape[0], 2))
    np.testing.assert_array_equal(ms @ v, nap @ v)
    np.testing.assert_array_equal(ms.T @ u, nap.T @ u)


POSTAL = {
    "tpu_v5e_values": (TPU_V5E_POSTAL,
                       port_cost.PostalParams(**dataclasses.asdict(TPU_V5E_POSTAL))),
    "blue_waters": (ref_cost.PostalParams(**dataclasses.asdict(
        port_cost.BLUE_WATERS_POSTAL)), port_cost.BLUE_WATERS_POSTAL),
}


@pytest.mark.parametrize("postal", sorted(POSTAL))
@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_choose_comm_matches_reference(layout, thr, postal):
    a_ref, a_port, (rp_r, rp_p), (cp_r, cp_p), t_ref, t_port = make_layout(layout)
    p_ref, p_port = POSTAL[postal]
    ref_plans = port_plans = None
    for wd in WIRE_DTYPES:
        ref = ref_comm.choose_comm(a_ref.indptr, a_ref.indices, rp_r, t_ref,
                                   pairing="aligned", col_part=cp_r, threshold=thr,
                                   params=p_ref, plans=ref_plans, wire_dtype=wd)
        port = port_comm.choose_comm(a_port.indptr, a_port.indices, rp_p, t_port,
                                     col_part=cp_p, threshold=thr, params=p_port,
                                     plans=port_plans, wire_dtype=wd)
        ref_plans, port_plans = ref["plans"], port["plans"]
        assert port["threshold"] == ref["threshold"]
        for direction in ("forward", "transpose"):
            assert ref[direction]["wire_dtype"] == wd
            assert ref[direction] == port[direction], (direction, wd)


def test_skewed_matrix_takes_multistep():
    """The pattern the multi-step exchange exists for resolves to it."""
    a_ref, a, (_, rp), _, _, topo = make_layout("skewed_2x4")
    op = port_api.operator(a, topo, rp, comm="auto", device="cpu")
    assert op.autotune_report()["comm_resolved"] == "multistep"
    assert op.method == "multistep"
    assert op.stats()["direct_effective"] > 0


def test_pairing_balanced_raises():
    """The device backend refuses the paper's balanced pairing, as the
    reference's shard_map backend does; the simulate backend and the
    chooser take it (the reference's verdict, exactly)."""
    a = port_sparse.poisson_2d(6)
    with pytest.raises(ValueError, match="balanced"):
        port_api.operator(a, Topology(2, 2), pairing="balanced", device="cpu")
    with pytest.raises(ValueError, match="balanced"):
        port_api.operator(a, Topology(2, 2), comm="auto", pairing="balanced",
                          device="cpu")
    with pytest.raises(ValueError, match="pairing"):
        port_api.operator(a, Topology(2, 2), pairing="diagonal",
                          backend="simulate")
    op = port_api.operator(a, Topology(2, 2), pairing="balanced",
                           backend="simulate")
    assert op.shape == (36, 36)
    a_ref = ref_sparse.poisson_2d(6)
    ref = ref_comm.choose_comm(a_ref.indptr, a_ref.indices,
                               ref_partition.contiguous_partition(36, 4),
                               RefTopology(2, 2), pairing="balanced",
                               params=ref_cost.PostalParams(**dataclasses.asdict(
                                   port_cost.BLUE_WATERS_POSTAL)))
    port = port_comm.choose_comm(a.indptr, a.indices,
                                 port_partition.contiguous_partition(36, 4),
                                 Topology(2, 2), pairing="balanced")
    for direction in ("forward", "transpose"):
        assert ref[direction]["wire_dtype"] == "f32"
        assert ref[direction] == port[direction], direction


_SHARDMAP_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import repro.api as nap
    from repro.core.partition import RowPartition
    from repro.core.topology import Topology
    from repro.sparse.csr import CSR
    d = np.load(sys.argv[1])
    topo = Topology(2, 2)
    out = {}
    for case in ("sq", "rect"):
        a = CSR(d[case + "_indptr"], d[case + "_indices"], d[case + "_data"],
                tuple(d[case + "_shape"]))
        parts = [RowPartition(int(d[f"{case}_{w}_n"]), 4, d[f"{case}_{w}_owner"],
                              d[f"{case}_{w}_perm"], d[f"{case}_{w}_first"])
                 for w in ("row", "col")]
        op = nap.operator(a, topo=topo, row_part=parts[0], col_part=parts[1],
                          method="multistep", backend="shardmap",
                          local_compute="ell")
        for k in ("v1", "v3"):
            out[f"{case}_w_{k}"] = op @ d[f"{case}_{k}"]
            out[f"{case}_z_{k}"] = op.T @ d[f"{case}_u_{k}"]
    np.savez(sys.argv[2], **out)
""")


@pytest.mark.multidev
def test_multistep_matches_reference_shardmap(tmp_path):
    """The reference's multi-step shard_map program on a 4-device host
    platform against the port, forward and transpose, nv = 1 and 3."""
    rng = np.random.default_rng(31)
    topo = Topology(2, 2)
    ind = skewed_rows(topo, rows_per_rank=12, bulk=8)
    sq = PortCSR(*ind)
    rect = PortCSR.from_dense(_dense_rect(26, 5, 0.4, seed=9))
    owner = np.repeat(np.arange(4), [2, 1, 0, 2])   # rank 2 owns no column
    cases = {"sq": (sq, port_partition.contiguous_partition(sq.shape[0], 4),
                    port_partition.contiguous_partition(sq.shape[1], 4)),
             "rect": (rect, port_partition.strided_partition(26, 4),
                      port_partition.partition_from_owner(owner, 4))}
    inputs, ops = {}, {}
    for case, (a, rp, cp) in cases.items():
        inputs.update({f"{case}_indptr": a.indptr, f"{case}_indices": a.indices,
                       f"{case}_data": a.data, f"{case}_shape": np.array(a.shape)})
        for w, part in (("row", rp), ("col", cp)):
            inputs.update({f"{case}_{w}_n": part.n_rows, f"{case}_{w}_owner": part.owner,
                           f"{case}_{w}_perm": part.perm,
                           f"{case}_{w}_first": part.first})
        for k, nv in (("v1", None), ("v3", 3)):
            shape_v = (a.shape[1],) if nv is None else (a.shape[1], nv)
            shape_u = (a.shape[0],) if nv is None else (a.shape[0], nv)
            inputs[f"{case}_{k}"] = rng.standard_normal(shape_v)
            inputs[f"{case}_u_{k}"] = rng.standard_normal(shape_u)
        ops[case] = port_api.operator(a, topo, row_part=rp, col_part=cp,
                                      method="multistep", local_compute="ell",
                                      device="cpu")
    assert ops["sq"].stats()["direct_effective"] > 0
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SHARDMAP_PROG, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(tmp_path / "out.npz")
    for case, op in ops.items():
        for k in ("v1", "v3"):
            np.testing.assert_allclose(op @ inputs[f"{case}_{k}"],
                                       ref[f"{case}_w_{k}"], **TOL)
            np.testing.assert_allclose(op.T @ inputs[f"{case}_u_{k}"],
                                       ref[f"{case}_z_{k}"], **TOL)


def test_available_strategies_match_reference():
    assert port_comm.available_strategies() == ref_comm.available_strategies()
    assert port_comm.COMM_CHOICES == ref_comm.COMM_CHOICES


@pytest.mark.parametrize("backend, method", [("shardmap", "nap"),
                                             ("simulate", "standard"),
                                             ("simulate", "multistep")])
def test_operator_backend_matches_reference(backend, method):
    """``op.backend`` names the backend of both views, as the reference's
    (the port's device backend is ``"torch"`` where the reference's is
    ``"shardmap"``)."""
    import repro.api as ref_api
    a_ref, a_port = ref_sparse.poisson_2d(6), port_sparse.poisson_2d(6)
    ref = ref_api.operator(a_ref, topo=RefTopology(2, 2), method=method,
                           backend=backend)
    port_backend = "torch" if backend == "shardmap" else backend
    port = port_api.operator(a_port, Topology(2, 2), method=method,
                             backend=port_backend, device="cpu")
    assert (ref.backend, ref.T.backend) == (backend, backend)
    assert (port.backend, port.T.backend) == (port_backend, port_backend)
    assert port.method == ref.method
