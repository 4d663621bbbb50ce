"""The hot value swap and the compile cache of the port against the JAX
package.

After ``swap_values`` every host array of a port plan (nap, standard and
multistep; with ELL, transposed ELL, fused BSR and ABFT materialised)
must EQUAL the arrays of a fresh reference compile of the new matrix,
and the staged tensors must hold them in place: same ``data_ptr()``, no
index tensor restaged, ``trace_counts`` flat.  A changed structure
raises.  The compile cache hits and misses as the reference's
``tests/test_plan_compile.py::test_compile_cache_hits_and_distinguishes``
and keys on the device too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.partition as ref_partition
import repro.core.spmv_jax as ref_spmv
import repro.sparse as ref_sparse
from repro.core.cost_model import TPU_V5E_LOCAL
from repro.core.topology import Topology as RefTopology

import repro_torch.api as port_api
import repro_torch.core.partition as port_partition
import repro_torch.core.spmv_torch as port_spmv
import repro_torch.sparse as port_sparse
from repro_torch.core.cost_model import LocalComputeParams
from repro_torch.core.topology import Topology

PORT_TUNER = LocalComputeParams(**dataclasses.asdict(TPU_V5E_LOCAL))

# (name, matrix generator and args, topology, partition kind)
CASES = [
    ("poisson_2x2", ("poisson_2d", (8,)), (2, 2), "contiguous"),
    ("aniso_2x4", ("rotated_anisotropic_2d", (12,)), (2, 4), "contiguous"),
    ("random_2x3_strided", ("random_fixed_nnz", (40, 4)), (2, 3), "strided"),
]
METHODS = ("nap", "standard", "multistep")


def _with_values(a, data):
    return type(a)(indptr=a.indptr.copy(), indices=a.indices.copy(),
                   data=data.copy(), shape=a.shape)


def _build(case, seed=0):
    _, (gen, args), (nn, ppn), kind = case
    a_ref = getattr(ref_sparse, gen)(*args)
    a_port = getattr(port_sparse, gen)(*args)
    n = a_ref.shape[0]
    p_ref = getattr(ref_partition, f"{kind}_partition")(n, nn * ppn)
    p_port = getattr(port_partition, f"{kind}_partition")(n, nn * ppn)
    new = np.random.default_rng(seed).standard_normal(a_ref.nnz)
    return (a_port, _with_values(a_ref, new), _with_values(a_port, new),
            p_ref, p_port, RefTopology(nn, ppn), Topology(nn, ppn))


def _compile(mod, method, a, part, topo, **kw):
    fn = {"nap": mod.compile_nap, "standard": mod.compile_standard,
          "multistep": mod.compile_multistep}[method]
    c = fn(a, part, topo, cache=False, **kw)
    for ensure in ("ensure_coo", "ensure_ell", "ensure_ell_t", "ensure_fused",
                   "ensure_abft"):
        if hasattr(c, ensure):
            getattr(c, ensure)()
    return c


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_swapped_plan_equals_fresh_reference_compile(case, method):
    a_old, a_new_ref, a_new, p_ref, p_port, t_ref, t_port = _build(case)
    port = _compile(port_spmv, method, a_old, p_port, t_port,
                    tuner=PORT_TUNER, device="cpu")
    staged = port.tensors(list(port.arrays))
    ptrs = {k: t.data_ptr() for k, t in staged.items()}
    builds = port.builds
    changed = port.swap_values(a_new)
    ref = _compile(ref_spmv, method, a_new_ref, p_ref, t_ref,
                   tuner=TPU_V5E_LOCAL)

    assert set(changed) <= port_spmv.VALUE_ARRAY_NAMES
    assert {"ell_vals", "ell_t_vals", "fused_blocks", "abft_col"} <= set(changed)
    assert set(port.arrays) == set(ref.arrays)
    for k, v in ref.arrays.items():
        np.testing.assert_array_equal(port.arrays[k], np.asarray(v), err_msg=k)
    after = port.tensors(list(port.arrays))
    for k, t in after.items():
        assert t is staged[k] and t.data_ptr() == ptrs[k], k
        np.testing.assert_array_equal(t.numpy(), port.arrays[k], err_msg=k)
    assert port.builds == builds
    assert port.a_ref is a_new


@pytest.mark.parametrize("comm", [None, "auto"])
@pytest.mark.parametrize("method", METHODS)
def test_operator_swap_keeps_builds_and_pointers(method, comm):
    a = port_sparse.rotated_anisotropic_2d(12)
    topo = Topology(2, 2)
    op = port_api.operator(a, topo, method=method, comm=comm, device="cpu",
                           cache=False)
    rng = np.random.default_rng(1)
    v = rng.standard_normal((a.shape[0], 3))
    u = rng.standard_normal((a.shape[0], 3))
    op @ v, op.T @ u
    counts = op.trace_counts()
    assert counts == {"forward": 1, "transpose": 1}
    execs = [e for e in (op.executor, op.transpose_executor) if e is not None]
    staged = [dict(e.compiled._tensors._bufs) for e in execs]
    ptrs = [{k: t.data_ptr() for k, t in s.items()
             if k in port_spmv.VALUE_ARRAY_NAMES} for s in staged]
    assert all(ptrs)
    a2 = _with_values(a, 3.0 * a.data - 1.0)
    op.T.swap_values(a2)                 # through the view: both pick it up
    assert op.a is a2
    dense = a2.to_dense()
    np.testing.assert_allclose(op @ v, dense @ v, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(op.T @ u, dense.T @ u, rtol=1e-5, atol=1e-4)
    assert op.trace_counts() == counts
    for e, before, ptr in zip(execs, staged, ptrs):
        now = e.compiled._tensors._bufs
        assert now.keys() == before.keys()
        assert all(now[k] is t for k, t in before.items())
        assert {k: now[k].data_ptr() for k in ptr} == ptr
    with pytest.raises(ValueError, match="identical sparsity"):
        op.swap_values(port_sparse.rotated_anisotropic_2d(11))


def test_swap_before_first_apply_and_simulate():
    a = port_sparse.poisson_2d(6)
    a2 = _with_values(a, 2.0 * a.data)
    v = np.arange(36, dtype=float)
    for kw in (dict(device="cpu", cache=False), dict(backend="simulate")):
        op = port_api.operator(a, Topology(2, 2), **kw)
        op.swap_values(a2)
        np.testing.assert_allclose(op @ v, a2.to_dense() @ v, rtol=1e-6)
        with pytest.raises(ValueError):
            op.swap_values(port_sparse.poisson_2d(5))
    assert op.trace_counts() == {}


def test_swap_on_a_plan_without_its_matrix_raises():
    a = port_sparse.poisson_2d(6)
    part = port_partition.contiguous_partition(36, 4)
    c = port_spmv.compile_nap(a, part, Topology(2, 2), device="cpu", cache=False)
    c.a_ref = None
    with pytest.raises(ValueError, match="lost its matrix reference"):
        c.swap_values(a)


def _problem(seed):
    a = port_sparse.random_fixed_nnz(60, 6, seed=seed)
    return Topology(2, 2), a, port_partition.contiguous_partition(60, 4)


def test_compile_cache_hits_and_distinguishes():
    """The reference's cache cases, plus the device in the key and a
    swap retiring its plan's entry."""
    port_spmv.clear_compile_cache()
    topo, a, part = _problem(9)
    c1 = port_spmv.compile_nap(a, part, topo, device="cpu")
    assert port_spmv.compile_nap(a, part, topo, device="cpu") is c1
    assert port_spmv.compile_nap(a, part, topo, block_shape=(8, 8),
                                 device="cpu") is not c1
    a2 = port_sparse.random_fixed_nnz(60, 6, seed=10)
    assert port_spmv.compile_nap(a2, part, topo, device="cpu") is not c1
    a3 = port_sparse.random_fixed_nnz(60, 6, seed=9)
    a3.data = a3.data * 2.0
    assert port_spmv.compile_nap(a3, part, topo, device="cpu") is not c1
    assert port_spmv.compile_nap(a, part, topo, cache=False,
                                 device="cpu") is not c1
    assert port_spmv.compile_nap(a, part, topo, device=torch.device("cpu")) is c1
    s1 = port_spmv.compile_standard(a, part, topo, device="cpu")
    assert port_spmv.compile_standard(a, part, topo, device="cpu") is s1
    m1 = port_spmv.compile_multistep(a, part, topo, device="cpu")
    assert port_spmv.compile_multistep(a, part, topo, device="cpu") is m1
    assert port_spmv.compile_multistep(a, part, topo, threshold=1,
                                       device="cpu") is not m1
    c1.swap_values(a3)       # carries a3's values now: retired from the cache
    c4 = port_spmv.compile_nap(a, part, topo, device="cpu")
    assert c4 is not c1
    port_spmv.clear_compile_cache()


def test_compile_cache_eviction_releases_staged_tensors():
    port_spmv.clear_compile_cache()
    topo, a, part = _problem(3)
    first = port_spmv.compile_nap(a, part, topo, device="cpu")
    first.tensors(["on_proc_rows", "on_proc_vals"])
    assert first._tensors.resident_bytes() > 0
    for seed in range(100, 100 + port_spmv._COMPILE_CACHE_MAX):
        port_spmv.compile_nap(port_sparse.random_fixed_nnz(60, 6, seed=seed),
                              part, topo, device="cpu")
    assert len(port_spmv._COMPILE_CACHE) == port_spmv._COMPILE_CACHE_MAX
    assert first._tensors.released and first._tensors.resident_bytes() == 0
    port_spmv.clear_compile_cache()
