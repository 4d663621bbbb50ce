"""One linear-operator front end over the port's executors::

    import repro_torch.api as nap

    op = nap.operator(a, Topology(n_nodes=32, ppn=16))
    w = op @ v         # forward SpMV ([n] or [n, nv] multi-RHS)
    z = op.T @ u       # transpose SpMV, the same compiled plan reversed
    op.stats(), op.autotune_report()
    op.cost(BLUE_WATERS)   # the paper's message model (Eqs. 10-12)

``method="nap"`` is the node-aware exchange (Algorithm 3),
``method="standard"`` the paper's baseline (Algorithm 1).

The program runs on the GPU; ``device="cpu"`` is the only way off it.
Operands are global numpy arrays (or CPU tensors); results are numpy
float32.  The plan compiles at the first apply.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import MachineParams
from repro_torch.core.executors import (OperatorSpec, available_executors,
                                        bind_executor, register_executor)
from repro_torch.core.partition import RowPartition, contiguous_partition
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike

__all__ = ["operator", "NapOperator", "available_executors",
           "register_executor"]


def operator(a, topo: Topology, part: Optional[RowPartition] = None, *,
             method: str = "nap", backend: str = "torch",
             local_compute: str = "auto",
             device: DeviceLike = None) -> "NapOperator":
    """Build a :class:`NapOperator` for the square matrix ``a``.

    ``topo`` is the (n_nodes, ppn) rank grid; ``part`` the row partition,
    contiguous by default.  ``method`` is ``"nap"`` or ``"standard"``.
    ``local_compute`` is ``"auto"`` (the format
    autotuner's verdict, per direction), ``"ell"``, ``"bsr"`` or ``"coo"``;
    the transpose has no BSR kernel and resolves ``"bsr"`` to the ell/coo
    verdict.  ``device`` defaults to CUDA and raises when it is absent.
    """
    m, n = a.shape
    if m != n:
        raise ValueError(f"the operator is square-only for now; a is {a.shape}")
    if topo is None:
        raise ValueError("pass the rank grid topo= explicitly")
    if part is None:
        part = contiguous_partition(m, topo.n_procs)
    if part.n_rows != m:
        raise ValueError(f"partition has {part.n_rows} rows, a has {m}")
    spec = OperatorSpec(method=method, backend=backend,
                        local_compute=local_compute,
                        device=None if device is None else str(device))
    exec_ = bind_executor(backend, method, a, part, part, topo, spec)
    return NapOperator(a=a, part=part, topo=topo, spec=spec, executor=exec_)


@dataclasses.dataclass
class NapOperator:
    """Distributed SpMV as a linear operator: ``op @ x`` applies ``A``,
    ``op.T @ x`` applies ``A.T`` through the SAME compiled plan."""

    a: object
    part: RowPartition
    topo: Topology
    spec: OperatorSpec
    executor: object
    transposed: bool = False
    _parent: Optional["NapOperator"] = dataclasses.field(default=None, repr=False)

    def __call__(self, x, materialize_x: bool = False) -> np.ndarray:
        """Apply the operator.  ``materialize_x=True`` concatenates the
        packed x before the forward local compute instead of passing its
        three segments (an A/B switch, bit-equal on the BSR path)."""
        if self.transposed:
            return self.executor.transpose(x)
        return self.executor.forward(x, materialize_x)

    def __matmul__(self, x) -> np.ndarray:
        return self(x)

    def matvec(self, x) -> np.ndarray:
        return self(x)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.a.shape)

    @property
    def T(self) -> "NapOperator":
        """Transpose view sharing the executor (``op.T.T is op``)."""
        if self._parent is not None:
            return self._parent
        return dataclasses.replace(self, transposed=not self.transposed,
                                   _parent=self)

    @property
    def local_compute(self) -> str:
        """Resolved local-compute format of THIS direction."""
        if self.transposed:
            return self.executor.transpose_local_compute
        return self.executor.local_compute

    def stats(self):
        """Plan message statistics and padded traffic."""
        return self.executor.stats()

    def cost(self, machine: MachineParams):
        """Modeled communication time of the plan on ``machine`` (paper
        Eqs. 10-12): a model of that machine, not a time on the GPU."""
        return self.executor.cost(machine)

    def autotune_report(self):
        """Format verdict (forward at the top, transpose under
        ``"transpose"``), its stats and modeled times, and the resolved
        formats of both directions."""
        return self.executor.autotune_report()

    def __repr__(self) -> str:
        t = ".T" if self.transposed else ""
        m, n = self.shape
        return (f"NapOperator{t}(shape=({m}, {n}), method={self.spec.method!r}, "
                f"backend={self.spec.backend!r}, "
                f"topo=({self.topo.n_nodes}x{self.topo.ppn}))")
