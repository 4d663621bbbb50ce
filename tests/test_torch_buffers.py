"""The port's device-buffer registry (``repro_torch.mesh.buffers``)
against the lifecycle and plan-cache eviction cases of
``tests/test_mesh.py``: staged / reused / evicted counts and bytes,
idempotent release, the compiled plans' tensors in the default
registry, and a plan cache that releases what it evicts or rebuilds.
"""
import numpy as np
import torch

from repro.mesh.buffers import BufferRegistry as RefBufferRegistry

import repro_torch.api as nap
from repro_torch.core.partition import contiguous_partition
from repro_torch.core.topology import Topology
from repro_torch.mesh import BufferRegistry, default_registry
from repro_torch.serve.plancache import PlanCache, release_operator_buffers
from repro_torch.sparse import random_fixed_nnz


def test_buffer_namespace_lifecycle_and_stats():
    reg = BufferRegistry(name="t")
    ns = reg.namespace("plan-a")
    x = torch.zeros(16, dtype=torch.float32)
    assert "k" not in ns
    ns["k"] = x
    assert "k" in ns and ns["k"] is x
    assert reg.stats["staged"] == 1
    assert reg.stats["reused"] == 1          # the read above
    assert reg.resident_bytes() == x.nbytes == 64
    ns.pop("k")
    assert reg.stats["evicted"] == 1 and reg.resident_bytes() == 0
    ns["k2"] = x
    ns[("k3", 2)] = (x, torch.zeros(4, dtype=torch.int64))   # a tuple entry
    assert reg.resident_bytes() == 64 + 64 + 32
    freed = ns.release()
    assert freed == 160 and len(ns) == 0
    assert ns.release() == 0                 # idempotent
    rep = reg.report()
    assert rep["namespaces_created"] == 1 and rep["namespaces_released"] == 1
    ref = RefBufferRegistry(name="t").report()
    assert rep.keys() == ref.keys()


def test_compiled_plan_buffers_live_in_default_registry():
    reg = default_registry()
    staged_before = reg.stats["staged"]
    a = random_fixed_nnz(48, 5, seed=1)
    op = nap.operator(a, topo=Topology(1, 4), device="cpu", cache=False)
    _ = op @ np.ones(48)
    assert reg.stats["staged"] > staged_before
    ns = op.executor.compiled._tensors
    assert ns.label == "spmv-plan" and ns.resident_bytes() > 0
    assert reg.resident_bytes() >= ns.resident_bytes()


def test_plancache_eviction_releases_buffers():
    topo = Topology(1, 4)
    cache = PlanCache(topo, max_entries=1, device="cpu")
    a = random_fixed_nnz(48, 5, seed=1)
    b = random_fixed_nnz(48, 7, seed=2)
    part = contiguous_partition(48, topo.n_procs)
    op_a = cache.operator_for(a, part)
    want = op_a @ np.ones(48)
    resident = op_a.executor.compiled._tensors.resident_bytes()
    assert release_operator_buffers(op_a) == resident > 0   # on a live op
    np.testing.assert_array_equal(op_a @ np.ones(48), want)  # restages
    cache.operator_for(b, part)                  # evicts op_a's entry
    assert cache.stats["evictions"] == 1
    assert cache.stats["buffer_bytes_released"] == resident
    assert op_a.executor.compiled._tensors.resident_bytes() == 0
    assert "resident_bytes" in cache.buffer_report()
    op_b = cache.operator_for(b, part)
    op_b @ np.ones(48)
    held = op_b.executor.compiled._tensors.resident_bytes()
    assert cache.rebuild(Topology(2, 2)) == 1
    assert cache.stats["buffer_bytes_released"] == resident + held
    assert op_b.executor.compiled._tensors.resident_bytes() == 0


def test_release_is_safe_on_simulate_operators():
    a = random_fixed_nnz(48, 5, seed=1)
    op = nap.operator(a, topo=Topology(1, 4), backend="simulate")
    op @ np.ones(48)
    assert release_operator_buffers(op) == 0
