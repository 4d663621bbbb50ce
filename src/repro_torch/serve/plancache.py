"""Structure-keyed plan cache with hot value swaps.

The compile cache in :mod:`repro_torch.core.spmv_torch` keys on the full
matrix — **including values** — because a compiled plan carries value
arrays.  A long-lived service re-solving the same sparsity with
evolving coefficients (time stepping, Newton updates, per-tenant
variants) would miss that cache on every value change and pay a full
replan and restaging.

:class:`PlanCache` keys on STRUCTURE alone — sparsity pattern, partition
owners, topology, executor configuration — and keeps a values
fingerprint per entry:

* same structure, same values  → plain hit, the cached operator returns;
* same structure, new values   → **hot swap**: ``op.swap_values`` rebuilds
  the value arrays and writes them into the staged tensors in place, so
  the program re-runs with no build (see
  :data:`repro_torch.core.spmv_torch.VALUE_ARRAY_NAMES`); counted under
  ``stats["hot_swaps"]``;
* new structure                → miss, a fresh operator compiles.

``rebuild(new_topo)`` is the elastic path: every cached plan is stale
the moment the node layout changes (the paper's premise — comm plans are
functions of the topology), so the cache drops them wholesale and
retargets its factory at the survivor topology.

Device-buffer lifecycle: every compiled plan pins its staged tensors
in a :mod:`repro_torch.mesh.buffers` registry namespace.  LRU eviction
and elastic rebuilds RELEASE those namespaces explicitly (the bytes
show up in the registry's eviction stats, surfaced via
:meth:`PlanCache.buffer_report`) instead of waiting on the collector.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from repro_torch.core.partition import RowPartition
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device
from repro_torch.mesh.buffers import plan_mesh


def structure_key(a, row_part: RowPartition, col_part: RowPartition,
                  topo: Topology, method: str, backend: str,
                  local_compute: str = "auto", integrity: str = "off") -> str:
    """Digest of everything a compiled plan depends on EXCEPT the matrix
    values — two matrices with equal keys may hot-swap into each other's
    compiled program.  ``integrity`` keys too: the instrumented program
    is a different program than the bare one."""
    h = hashlib.sha1()
    for arr in (a.indptr, a.indices, row_part.owner, col_part.owner):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr((tuple(a.shape), topo.n_nodes, topo.ppn,
                   method, backend, local_compute, integrity)).encode())
    return h.hexdigest()


def values_fingerprint(a) -> str:
    """Digest of the matrix values alone (hot-swap change detection)."""
    return hashlib.sha1(np.ascontiguousarray(a.data).tobytes()).hexdigest()


def release_operator_buffers(op) -> int:
    """Release every device-buffer namespace an operator's executors pin
    (forward AND transpose, when split).  Returns bytes released; safe on
    simulate-backend operators (which pin nothing)."""
    freed = 0
    for ex in (getattr(op, "executor", None),
               getattr(op, "transpose_executor", None)):
        cache = getattr(getattr(ex, "_compiled", None), "_tensors", None)
        release = getattr(cache, "release", None)
        if release is not None:
            freed += release()
    return freed


class PlanCache:
    """LRU cache of live :class:`repro_torch.api.NapOperator`s,
    structure-keyed.  ``operator_kwargs`` go to every operator (e.g.
    ``device=``); the torch backend runs on CUDA unless ``device="cpu"``
    is passed, and raises here when CUDA is absent.

    ``mesh`` is the process mesh the torch backend's plans compile their
    node blocks for in a multi-process job (None in one process, and for
    the host simulators): a topology that does not split into whole-node
    blocks raises :class:`repro_torch.mesh.discover.DiscoveryError`, here
    or in :meth:`rebuild`."""

    def __init__(self, topo: Topology, *, method: str = "nap",
                 backend: str = "torch", local_compute: str = "auto",
                 max_entries: int = 8, integrity: str = "off",
                 **operator_kwargs):
        self.mesh = None
        if backend == "torch":
            resolve_device(operator_kwargs.get("device"))
            self.mesh = plan_mesh(topo)
        self.topo = topo
        self.method, self.backend = method, backend
        self.local_compute = local_compute
        self.max_entries = int(max_entries)
        self.integrity = integrity
        self.operator_kwargs = dict(operator_kwargs)
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self.stats: Dict[str, int] = {"hits": 0, "misses": 0, "hot_swaps": 0,
                                      "evictions": 0, "rebuilds": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def operator_for(self, a, row_part: RowPartition,
                     col_part: Optional[RowPartition] = None):
        """The cached operator for (structure, layout), values current.

        A structural hit with changed values hot-swaps in place; the
        caller gets a ready operator either way and never recompiles for
        a pure value update.
        """
        cpart = row_part if col_part is None else col_part
        key = structure_key(a, row_part, cpart, self.topo,
                            self.method, self.backend, self.local_compute,
                            self.integrity)
        ent = self._entries.get(key)
        if ent is not None:
            self._entries.move_to_end(key)
            fp = values_fingerprint(a)
            if fp != ent["fingerprint"]:
                ent["op"].swap_values(a)
                ent["fingerprint"] = fp
                self.stats["hot_swaps"] += 1
            else:
                self.stats["hits"] += 1
            return ent["op"]
        self.stats["misses"] += 1
        import repro_torch.api as nap
        op = nap.operator(a, topo=self.topo, row_part=row_part,
                          col_part=cpart, method=self.method,
                          backend=self.backend,
                          local_compute=self.local_compute,
                          integrity=self.integrity, **self.operator_kwargs)
        while len(self._entries) >= self.max_entries:
            _, old = self._entries.popitem(last=False)
            self.stats["buffer_bytes_released"] = (
                self.stats.get("buffer_bytes_released", 0)
                + release_operator_buffers(old["op"]))
            self.stats["evictions"] += 1
        self._entries[key] = {"op": op, "fingerprint": values_fingerprint(a)}
        return op

    def rebuild(self, new_topo: Topology) -> int:
        """Elastic rebuild: drop EVERY cached plan (all are stale on a
        changed topology) and retarget the factory at ``new_topo``.
        Returns the number of plans dropped; subsequent ``operator_for``
        calls recompile against the survivor layout.  The old mesh goes
        with them: the survivors' blocks are ``new_topo``'s (raises, with
        the cache untouched, when ``new_topo`` has no whole-node block per
        process)."""
        mesh = plan_mesh(new_topo) if self.backend == "torch" else None
        dropped = len(self._entries)
        for ent in self._entries.values():
            self.stats["buffer_bytes_released"] = (
                self.stats.get("buffer_bytes_released", 0)
                + release_operator_buffers(ent["op"]))
        self._entries.clear()
        self.topo, self.mesh = new_topo, mesh
        self.stats["rebuilds"] += 1
        return dropped

    def buffer_report(self) -> Dict[str, object]:
        """The process-wide buffer registry's accounting (staged/reused/
        evicted counts and bytes, live namespaces, resident bytes)."""
        from repro_torch.mesh.buffers import default_registry
        return default_registry().report()
