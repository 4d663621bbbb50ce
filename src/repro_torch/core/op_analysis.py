"""Operator-level cost of a program: FLOPs, bytes and exchanges, counted
as the program runs.  The port's counterpart of
``repro/core/hlo_analysis.py``.

The reference compiles each cell for a TPU mesh and reads XLA's HLO text,
recovering loop trip counts from the loop conditions.  The port compiles
no HLO: :func:`count_ops` counts the operators PyTorch actually dispatches
(a ``TorchDispatchMode``), so every iteration that runs is counted and no
trip count needs recovering.  It counts on any device: on ``meta`` the
operators compute nothing and hold no memory, so a full-size cell (a
405B-parameter training step) is counted on the host; on the CPU and on
the card the same program counts the same.

* ``dot_flops``: ``2 * prod(result) * prod(contraction)`` for ``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot`` and convolutions (a
  convolution's backward counts one forward for each gradient it makes),
  as the reference's ``_dot_flops``.
* ``hbm_bytes``: the input bytes plus the output bytes of every operator
  that is not a view (views, reshapes, expands, permutes, slices and
  aliases move nothing; ``empty`` writes nothing): the reference's proxy
  at operator boundaries.
* Hand-written kernels count their DECLARED work (:func:`kernel_work`):
  their FLOPs (into ``dot_flops``), each input byte read once and each
  output byte written once, whatever implements them: the kernel on the
  card, its plain version on the CPU (whose operators are not counted),
  an empty result on ``meta``.
* Exchanges count where the communicator moves them
  (:mod:`repro_torch.mesh.comm`): ``collective_bytes`` (the operand's
  bytes), ``collective_counts`` and ``group_sizes`` by kind
  (``all-to-all``, ``collective-permute``), and ``dci_bytes``, the bytes
  whose source and destination node differ, counted at the same call as
  ``comm.inter_node_bytes()`` (``dci_by_axis`` per axis), so the two
  agree by construction.
* Activation specs (:mod:`repro_torch.models.actsharding`) report their
  site, shape, spec and per-device bytes while a counter is active.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

@dataclasses.dataclass
class OpCost:
    """What a program did, summed over the operators it ran (the fields of
    the reference's ``HLOCost``, then the port's own)."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    group_sizes: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    dci_bytes: float = 0.0       # exchanged bytes whose nodes (pods) differ
    dci_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)
    # hand-written kernels: name -> {"calls", "flops", "bytes"} declared
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    operators: int = 0           # operators counted
    # activation specs: "site shape spec" -> {"count", "bytes_per_device"}
    activations: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # every activation report in order, when counted with trace_sites=True
    sites: Optional[List[tuple]] = None

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def add(self, other: "OpCost", mult: float) -> None:
        self.dot_flops += other.dot_flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.dci_bytes += other.dci_bytes * mult
        self.operators += int(other.operators * mult)
        for mine, theirs in ((self.collective_bytes, other.collective_bytes),
                             (self.collective_counts, other.collective_counts),
                             (self.dci_by_axis, other.dci_by_axis)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0.0) + v * mult
        for k, v in other.group_sizes.items():
            self.group_sizes.setdefault(k, []).extend(v)
        for name, w in other.kernels.items():
            mine = self.kernels.setdefault(name, {"calls": 0.0, "flops": 0.0, "bytes": 0.0})
            for k in mine:
                mine[k] += w[k] * mult
        for key, a in other.activations.items():
            mine = self.activations.setdefault(key, {"count": 0.0, "bytes_per_device": a["bytes_per_device"]})
            mine["count"] += a["count"] * mult

    def as_dict(self) -> Dict:
        """The JSON-ready record (the dry run's ``ops``)."""
        return {"dot_flops": self.dot_flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "group_sizes": {k: sorted(set(v)) for k, v in self.group_sizes.items()},
                "dci_bytes": self.dci_bytes, "dci_by_axis": dict(self.dci_by_axis),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "operators": self.operators}


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

# the active counters, outermost first: process-wide, so that what the
# autograd engine's device threads run in a backward counts too (the
# dispatch mode itself follows the engine into them)
_COUNTERS: List["_Counter"] = []

# operators that move no bytes though they are not views: allocations, a
# host read of a scalar, a reshape of a fresh copy, a constant's lift
_NO_WRITE = {"empty", "empty_like", "empty_strided", "_local_scalar_dense",
             "_unsafe_view", "lift_fresh"}


def active() -> bool:
    """Is a counter active?"""
    return bool(_COUNTERS)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def _dot_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm", "mv", "dot"):
        a = args[0]
        return 2.0 * _prod(out.shape) * int(a.shape[-1])
    if name in ("addmm", "baddbmm", "addmv"):
        a = args[1]
        return 2.0 * _prod(out.shape) * int(a.shape[-1])
    if name == "convolution":
        w = args[1]
        return 2.0 * _prod(out.shape) * _prod(w.shape[1:])
    if name == "convolution_backward":
        grad_out, w, mask = args[0], args[2], args[-1]
        fwd = 2.0 * _prod(grad_out.shape) * _prod(w.shape[1:])
        return fwd * sum(bool(m) for m in mask[:2])
    return 0.0


_PRODUCTS = {"mm", "bmm", "mv", "dot", "addmm", "baddbmm", "addmv",
             "convolution", "convolution_backward"}


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.suspended = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        name = func.overloadpacket.__name__
        cost = self.cost
        cost.operators += 1
        if name in _PRODUCTS:
            cost.dot_flops += _dot_flops(name, args, out)
        if func.is_view or name in _NO_WRITE:
            return out
        ins, _ = tree_flatten((args, kwargs))
        outs, _ = tree_flatten(out)
        cost.hbm_bytes += sum(_nbytes(t) for t in ins if isinstance(t, torch.Tensor))
        cost.hbm_bytes += sum(_nbytes(t) for t in outs if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def count_ops(trace_sites: bool = False) -> Iterator[OpCost]:
    """``with count_ops() as cost: program()``: every operator the program
    dispatches (and the autograd backward it runs) is counted into
    ``cost``.  ``trace_sites`` also keeps every activation
    report in order in ``cost.sites``."""
    cost = OpCost(sites=[] if trace_sites else None)
    counter = _Counter(cost)
    _COUNTERS.append(counter)
    try:
        with counter:
            yield cost
    finally:
        _COUNTERS.remove(counter)


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """Nothing dispatched inside counts (a kernel's plain version)."""
    counters = _COUNTERS
    for c in counters:
        c.suspended += 1
    try:
        yield
    finally:
        for c in counters:
            c.suspended -= 1


@contextlib.contextmanager
def kernel_work(name: str, flops: float, read: float, written: float) -> Iterator[None]:
    """A hand-written kernel's call: its declared FLOPs and bytes count
    once, and nothing dispatched inside (its plain version, its empty
    meta result, its output allocation on the card) counts."""
    for c in _COUNTERS:
        if c.suspended:
            continue
        c.cost.dot_flops += flops
        c.cost.hbm_bytes += read + written
        w = c.cost.kernels.setdefault(name, {"calls": 0.0, "flops": 0.0, "bytes": 0.0})
        w["calls"] += 1
        w["flops"] += flops
        w["bytes"] += read + written
    with suspended():
        yield


def kernel(name: str, work) -> contextlib.AbstractContextManager:
    """A kernel wrapper's body runs inside this: with no counter active,
    nothing happens (``work`` is not called); else ``work()`` gives the
    call's declared ``(flops, bytes read, bytes written)``, computed
    uncounted, and :func:`kernel_work` counts it."""
    if not _COUNTERS:
        return contextlib.nullcontext()
    with suspended():
        flops, read, written = work()
    return kernel_work(name, flops, read, written)


def note_collective(kind: str, nbytes: int, group: int = 0,
                    crossing: int = 0, axis: Optional[str] = None) -> None:
    """One exchange: its kind, its operand's bytes, its group size (0:
    none recorded, as for a permute) and the bytes of it that cross a
    node, under the communicator's ``axis``.  An exchange within a group
    of one (a one-pod island's node axis) moves nothing between chips
    and is not counted, as XLA emits no collective over such a group."""
    if group == 1:
        return
    for c in _COUNTERS:
        if c.suspended:
            continue
        cost = c.cost
        cost.collective_bytes[kind] = cost.collective_bytes.get(kind, 0.0) + nbytes
        cost.collective_counts[kind] = cost.collective_counts.get(kind, 0.0) + 1
        if group:
            cost.group_sizes.setdefault(kind, []).append(group)
        if crossing:
            cost.dci_bytes += crossing
        if axis is not None:
            cost.dci_by_axis[axis] = cost.dci_by_axis.get(axis, 0.0) + crossing


def note_activation(site: str, shape, spec, per_device_bytes: float) -> None:
    """One activation spec of :mod:`repro_torch.models.actsharding`."""
    for c in _COUNTERS:
        if c.suspended:
            continue
        key = f"{site} {tuple(shape)} {tuple(spec)}"
        rec = c.cost.activations.setdefault(
            key, {"count": 0.0, "bytes_per_device": float(per_device_bytes)})
        rec["count"] += 1
        if c.cost.sites is not None:
            c.cost.sites.append((site, tuple(shape), tuple(spec)))
