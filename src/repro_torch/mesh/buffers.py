"""Persistent device-buffer registry and process-mesh placement.

Two jobs, one seam, as in the JAX package's ``mesh.buffers``:

* :class:`BufferRegistry` / :class:`BufferNamespace` keep named plan
  tensors resident on the device across solves, with an explicit
  lifecycle and eviction stats.  A namespace speaks the dict protocol, so
  it is a compiled plan's staging cache (``_Staged._tensors`` in
  :mod:`repro_torch.core.spmv_torch`): the first use stages each host
  array once, every later use (and every hot value swap, which writes
  into the staged tensor in place) reuses the resident tensor.  Evicting
  a plan (the serve ``PlanCache`` LRU, an elastic ``rebuild``, the
  compile cache's LRU) releases its namespace, so the device memory is
  accounted and freed, not left to the collector.

* Placement: the ONE place that knows whether this process is part of a
  multi-process ``torch.distributed`` job.  A process owns a contiguous
  block of whole nodes (:class:`ProcessMesh`, :func:`mesh_for`) and
  batches their ranks on its device.  A compiled plan takes its mesh
  once, when it is compiled (:func:`plan_mesh`: None in one process),
  and its operands and results follow that mesh: with None staging is a
  plain ``torch.from_numpy(g).to(device)`` (bit-identical to the
  declared-topo path) and the result is fetched with ``.cpu()``; with a
  mesh :func:`stage_mesh_array` stages only the owned node rows and
  :func:`fetch_mesh_array` all-gathers the owned rows of every process,
  a copy, so the round trip is bitwise exact.
"""
from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topology import Topology

__all__ = ["BufferNamespace", "BufferRegistry", "default_registry",
           "ProcessMesh", "process_count", "is_multiprocess", "is_first_process",
           "job_barrier", "broadcast_from_first", "gather_from_all", "local_ranks",
           "mesh_for", "plan_mesh", "stage_mesh_array", "input_stager",
           "fetch_mesh_array"]


# ---------------------------------------------------------------------------
# Placement: one process vs a torch.distributed job
# ---------------------------------------------------------------------------

def _dist():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    """Processes in the ``torch.distributed`` job (1 when unattached)."""
    dist = _dist()
    return 1 if dist is None else int(dist.get_world_size())


def is_multiprocess() -> bool:
    return process_count() > 1


def is_first_process() -> bool:
    """Whether this is process 0 of the job (or the only process): the
    one that writes what every process must read, such as checkpoints."""
    dist = _dist()
    return dist is None or int(dist.get_rank()) == 0


def _group(mesh: Optional["ProcessMesh"]):
    return None if mesh is None else mesh.group


def job_barrier(mesh: Optional["ProcessMesh"] = None) -> None:
    """Wait until every process of the job reaches this call (over
    ``mesh.group``, else the default group); nothing in one process."""
    if is_multiprocess():
        _dist().barrier(group=_group(mesh))


def broadcast_from_first(obj, mesh: Optional["ProcessMesh"] = None):
    """``obj`` as the job's process 0 holds it, returned in every process
    (a picklable object, over ``mesh.group``, else the default group);
    ``obj`` itself in one process.  A collective: it also orders every
    process after process 0's work before the call."""
    if not is_multiprocess():
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=0, group=_group(mesh))
    return box[0]


def gather_from_all(obj, mesh: Optional["ProcessMesh"] = None) -> list:
    """``obj`` of every process of the job, in process order (a picklable
    object, over ``mesh.group``, else the default group); ``[obj]`` in
    one process."""
    if not is_multiprocess():
        return [obj]
    dist = _dist()
    out = [None] * int(dist.get_world_size(group=_group(mesh)))
    dist.all_gather_object(out, obj, group=_group(mesh))
    return out


def local_ranks() -> int:
    """Ranks this process batches on its device: ``REPRO_MESH_LOCAL_DEVICES``
    (the ppn of :func:`repro_torch.mesh.discover.discover_topology`), 1
    when unset."""
    from repro_torch.mesh.launcher import ENV_LOCAL_DEVICES
    return int(os.environ.get(ENV_LOCAL_DEVICES) or 1)


@dataclasses.dataclass(eq=False)
class ProcessMesh:
    """This process's place in a ``torch.distributed`` job over ``topo``:
    ``world`` processes, this one ``rank``, owning the contiguous node
    block ``nodes`` (``n_nodes / world`` whole nodes) and so the ranks
    ``ranks``, batched on the process's device; ``group`` is the process
    group of the exchanges (None: the default group) and ``backend`` its
    backend.

    ``stats`` counts what the communicator (:mod:`repro_torch.mesh.comm`)
    moved: bytes this process sent to OTHER processes per mesh axis
    (``sent_bytes_node``, ``sent_bytes_nodexproc``), bytes its ranks sent
    to ranks of other NODES per axis (``inter_node_bytes_node``,
    ``inter_node_bytes_nodexproc``, within the process too), bytes it
    staged through pinned host buffers (``staged_bytes``, both
    directions) and its collectives."""

    topo: Topology
    world: int
    rank: int
    backend: str
    group: object = None
    stats: Dict[str, int] = dataclasses.field(default_factory=lambda: {
        "sent_bytes_node": 0, "sent_bytes_nodexproc": 0,
        "inter_node_bytes_node": 0, "inter_node_bytes_nodexproc": 0,
        "staged_bytes": 0, "collectives": 0})
    _pinned: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_local_nodes(self) -> int:
        return self.topo.n_nodes // self.world

    @property
    def n_local_procs(self) -> int:
        return self.n_local_nodes * self.topo.ppn

    @property
    def nodes(self) -> Tuple[int, int]:
        n0 = self.rank * self.n_local_nodes
        return n0, n0 + self.n_local_nodes

    @property
    def ranks(self) -> Tuple[int, int]:
        n0, n1 = self.nodes
        return n0 * self.topo.ppn, n1 * self.topo.ppn

    @property
    def key(self) -> tuple:
        """What a compiled plan's cache key takes from the mesh: the owned
        block and the process group."""
        return (self.world, self.nodes, id(self.group))

    def pinned(self, role: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host buffer of ``shape`` for ``role`` and ``dtype``,
        kept and reused (grown when a larger one is asked for): pinning is
        slow, a blocking copy finishes before the buffer is used again, and
        the instrumented programs alternate float32 payloads with int64
        checksum words."""
        n = int(np.prod(shape, dtype=np.int64))
        key = (role, dtype)
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf[:n].view(shape)


_MESH_CACHE: Dict[tuple, ProcessMesh] = {}


def mesh_for(topo: Topology) -> ProcessMesh:
    """The shared process mesh of a topology in this job, memoized: every
    plan and stager bound to the same layout (and process group) reuses
    one mesh, and its byte counts.  In one process the mesh owns every
    node.  Raises :class:`repro_torch.mesh.discover.DiscoveryError` when
    ``topo.n_nodes`` is not a multiple of the process count (a ragged
    layout has no block of whole nodes per process)."""
    from repro_torch.mesh.discover import DiscoveryError
    dist = _dist()
    world = process_count()
    group = None if dist is None else dist.group.WORLD
    # the mesh holds its group, so a live key's id() is never reused
    key = (topo.n_nodes, topo.ppn, world, id(group))
    mesh = _MESH_CACHE.get(key)
    if mesh is not None:
        return mesh
    if topo.n_nodes % world:
        raise DiscoveryError(
            f"{topo} cannot be split into blocks of whole nodes over "
            f"{world} processes: n_nodes must be a multiple of the process "
            f"count")
    mesh = ProcessMesh(topo=topo, world=world,
                       rank=0 if dist is None else int(dist.get_rank()),
                       backend="none" if dist is None else str(dist.get_backend()),
                       group=group)
    _MESH_CACHE[key] = mesh
    return mesh


def plan_mesh(topo: Topology) -> Optional[ProcessMesh]:
    """The mesh a compiled plan stages its owned block for: None in one
    process (the plan holds the whole layout and its programs run no
    collective), else :func:`mesh_for`."""
    return mesh_for(topo) if is_multiprocess() else None


def stage_mesh_array(g: np.ndarray, mesh: Optional[ProcessMesh], dtype=None,
                     device=None) -> torch.Tensor:
    """Device-stage one mesh-shaped ``[n_nodes, ppn, ...]`` host array for
    a plan whose process mesh is ``mesh`` (a compiled plan's ``mesh``).

    None (the plan holds the whole layout): ``torch.from_numpy(g).to(device)``,
    bit-identical to the declared-topo path.  A mesh: only the node rows
    ``g[n0:n1]`` the process owns are staged, never the whole job's buffer.
    """
    if dtype is not None:
        g = np.asarray(g, dtype)
    if mesh is not None:
        n0, n1 = mesh.nodes
        g = np.ascontiguousarray(g[n0:n1])
    return torch.from_numpy(g).to(device)


def input_stager(mesh: Optional[ProcessMesh], device=None):
    """Per-call operand stager of a plan whose process mesh is ``mesh``.

    None for a whole-layout plan (the caller's
    ``torch.from_numpy(shards).to(device)`` stays untouched); for a block
    plan ``stage(shards, dtype=f32)``, which stages the owned node rows of
    the packed ``[n_nodes, ppn, pad(, nv)]`` operand.
    """
    if mesh is None:
        return None

    def stage(shards, dtype=np.float32):
        return stage_mesh_array(np.asarray(shards, dtype), mesh, device=device)

    return stage


def fetch_mesh_array(w: torch.Tensor, mesh: Optional[ProcessMesh] = None
                     ) -> np.ndarray:
    """Host copy of a program result, bitwise exact.

    No ``mesh`` (a whole-layout plan): ``w.cpu().numpy()``.  A mesh: ``w``
    holds this process's node rows ``[n_local_nodes, ppn, ...]``; the rows
    of every process are all-gathered over ``mesh.group`` (host tensors on
    gloo, device tensors on nccl) and concatenated in node order, so every
    process returns the whole ``[n_nodes, ppn, ...]`` result.
    """
    if mesh is None:
        return w.detach().cpu().numpy()
    t = w.detach().contiguous()
    if mesh.backend == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    _dist().all_gather(parts, t, group=mesh.group)
    return torch.cat(parts).cpu().numpy()


# ---------------------------------------------------------------------------
# The persistent buffer registry
# ---------------------------------------------------------------------------

def _nbytes(obj) -> int:
    """Bytes of a tensor (``.nbytes``) or of a tuple of tensors."""
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(o) for o in obj)
    return int(getattr(obj, "nbytes", 0))


class BufferNamespace:
    """One plan's named device buffers (dict protocol).

    Lifecycle: tensors enter via ``__setitem__`` (counted as ``staged``),
    are read back by every program via ``__getitem__`` (``reused``),
    leave individually via ``pop`` or wholesale via ``release()`` (plan
    eviction / elastic rebuild).  Byte counts are ``tensor.nbytes``.
    """

    def __init__(self, registry: "BufferRegistry", label: str):
        self._registry = registry
        self.label = label
        self._bufs: Dict[object, object] = {}
        self._nbytes: Dict[object, int] = {}
        self.released = False

    def __contains__(self, name) -> bool:
        return name in self._bufs

    def __getitem__(self, name):
        self._registry.stats["reused"] += 1
        return self._bufs[name]

    def __setitem__(self, name, arr) -> None:
        if name in self._bufs:
            self.pop(name)
        nb = _nbytes(arr)
        self._bufs[name] = arr
        self._nbytes[name] = nb
        st = self._registry.stats
        st["staged"] += 1
        st["staged_bytes"] += nb

    def pop(self, name, default=None):
        if name not in self._bufs:
            return default
        arr = self._bufs.pop(name)
        nb = self._nbytes.pop(name)
        st = self._registry.stats
        st["evicted"] += 1
        st["evicted_bytes"] += nb
        return arr

    def __len__(self) -> int:
        return len(self._bufs)

    def keys(self):
        return self._bufs.keys()

    def resident_bytes(self) -> int:
        return sum(self._nbytes.values())

    def release(self) -> int:
        """Drop every buffer in the namespace; returns bytes released.
        Idempotent: a plan may be released through several paths."""
        nb = self.resident_bytes()
        for name in list(self._bufs):
            self.pop(name)
        if not self.released:
            self.released = True
            self._registry.stats["namespaces_released"] += 1
        return nb


class BufferRegistry:
    """Process-wide accounting over every live :class:`BufferNamespace`.

    The registry holds its namespaces weakly and never holds a buffer:
    namespaces own them, so a plan that is garbage-collected frees its
    device memory with it.
    """

    def __init__(self, name: str = "default"):
        self.name = name
        self._namespaces: "weakref.WeakSet[BufferNamespace]" = weakref.WeakSet()
        self.stats: Dict[str, int] = {
            "staged": 0, "staged_bytes": 0,
            "reused": 0,
            "evicted": 0, "evicted_bytes": 0,
            "namespaces_created": 0, "namespaces_released": 0,
        }

    def namespace(self, label: str = "plan") -> BufferNamespace:
        ns = BufferNamespace(self, label)
        self._namespaces.add(ns)
        self.stats["namespaces_created"] += 1
        return ns

    def live_namespaces(self) -> int:
        return sum(1 for ns in self._namespaces if not ns.released)

    def resident_bytes(self) -> int:
        return sum(ns.resident_bytes() for ns in self._namespaces)

    def report(self) -> Dict[str, object]:
        return dict(self.stats, name=self.name,
                    live_namespaces=self.live_namespaces(),
                    resident_bytes=self.resident_bytes())


_DEFAULT: Optional[BufferRegistry] = None


def default_registry() -> BufferRegistry:
    """The process-wide registry every compiled plan stages into (tests
    may construct private registries)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = BufferRegistry()
    return _DEFAULT
