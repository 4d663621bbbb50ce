"""Executor registry behind :class:`repro_torch.api.NapOperator`.

An executor binds one (backend, method) pair to a matrix and a layout
and exposes what the operator front-end needs: ``forward(v)`` (global
``A @ v``, 1-RHS or multi-RHS), ``transpose(u)`` (global ``A.T @ u`` on
the same plan), ``stats()``, ``cost(machine)`` and ``autotune_report()``.

Registered here, both rank-batched programs of
:mod:`repro_torch.core.spmv_torch` on one device:

* ``("torch", "nap")`` — the node-aware exchange (Algorithm 3);
* ``("torch", "standard")`` — the flat exchange (Algorithm 1), the
  paper's baseline;
* ``("torch", "multistep")`` — the node-aware exchange for columns that
  several processes of a node need, a direct owner -> requester hop for
  the rest (:mod:`repro_torch.comm.multistep`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm_graph import nap_stats, standard_stats
from repro_torch.core.cost_model import (MachineParams, multistep_cost,
                                         nap_cost, standard_cost)
from repro_torch.core.partition import RowPartition
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """Everything an executor factory needs beyond (a, partitions, topo)."""

    method: str = "nap"
    backend: str = "torch"
    local_compute: str = "auto"
    device: Optional[str] = None    # None = CUDA; "cpu" only on request
    # duplication threshold of method="multistep" ("auto" or an int >= 1)
    threshold: object = "auto"


_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def register_executor(backend: str, method: str):
    """Class/factory decorator: ``factory(a, row_part, col_part, topo, spec,
    plan=None)`` becomes reachable through :func:`bind_executor`."""

    def deco(factory):
        _REGISTRY[(backend, method)] = factory
        return factory

    return deco


def available_executors() -> List[Tuple[str, str]]:
    return sorted(_REGISTRY)


def bind_executor(backend: str, method: str, a, row_part: RowPartition,
                  col_part: RowPartition, topo: Topology, spec: OperatorSpec,
                  plan=None):
    """Instantiate the registered executor for (backend, method); ``plan``
    is a prebuilt communication plan of that method (the comm chooser's
    candidate), else the executor builds its own."""
    try:
        factory = _REGISTRY[(backend, method)]
    except KeyError:
        avail = ", ".join(f"{b}/{m}" for b, m in available_executors())
        raise ValueError(
            f"no executor registered for backend={backend!r} "
            f"method={method!r}; available: {avail}") from None
    return factory(a, row_part, col_part, topo, spec, plan=plan)


def check_operand(n: int, v) -> np.ndarray:
    """A global [n] vector or [n, nv] multivector, as numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v)
    if v.shape[:1] != (n,) or v.ndim > 2:
        raise ValueError(f"operand must be [{n}] or [{n}, nv], got {v.shape}")
    return v


class _TorchExecutor:
    """One method's program on one device.  The plan compiles at the
    first apply; forward packs the operand by ``col_part`` and unpacks
    the result by ``row_part``, the transpose swaps both.  Subclasses
    give ``_compile()`` and ``_programs()`` (forward, transpose)."""

    backend = "torch"
    method = ""

    def __init__(self, a, row_part: RowPartition, col_part: RowPartition,
                 topo: Topology, spec: OperatorSpec, plan=None):
        self.a, self.topo, self.spec = a, topo, spec
        self.row_part, self.col_part = row_part, col_part
        self.device = resolve_device(spec.device)
        self._plan = plan       # a prebuilt plan of this method, or None
        self._compiled = None

    @property
    def compiled(self):
        if self._compiled is None:
            self._compiled = self._compile()
        return self._compiled

    def program(self, direction: str, **options
                ) -> Callable[[torch.Tensor], torch.Tensor]:
        """The device program of one direction: packed shards in, packed
        shards out, on the executor's device.  ``options`` go to the
        program function (``materialize_x`` forward; ``live_scatter``
        for the standard transpose; ``live_direct`` both ways on the
        multi-step plan)."""
        forward, transpose = self._programs()
        fn = forward if direction == "forward" else transpose
        c, lc = self.compiled, self.spec.local_compute
        return lambda s: fn(c, s, local_compute=lc, **options)

    def packed(self, direction: str, v) -> torch.Tensor:
        """Pack a global operand into device shards for :meth:`program`."""
        from repro_torch.core.spmv_torch import pack_vector
        c = self.compiled
        if direction == "forward":
            part, pad, n = self.col_part, c.cols_pad, self.a.shape[1]
        else:
            part, pad, n = self.row_part, c.rows_pad, self.a.shape[0]
        shards = pack_vector(check_operand(n, v), part, self.topo, pad)
        return torch.from_numpy(shards).to(self.device)

    def _apply(self, direction: str, v, **options) -> np.ndarray:
        from repro_torch.core.spmv_torch import unpack_vector
        w = self.program(direction, **options)(self.packed(direction, v))
        out_part = self.row_part if direction == "forward" else self.col_part
        return unpack_vector(w.cpu().numpy(), out_part, self.topo)

    def forward(self, v, materialize_x: bool = False) -> np.ndarray:
        return self._apply("forward", v, materialize_x=materialize_x)

    def transpose(self, u, **options) -> np.ndarray:
        return self._apply("transpose", u, **options)

    @property
    def local_compute(self) -> str:
        return self.compiled.resolve_local_compute(self.spec.local_compute)

    @property
    def transpose_local_compute(self) -> str:
        return self.compiled.resolve_transpose_local_compute(
            self.spec.local_compute)

    def autotune_report(self) -> Dict[str, object]:
        return dict(self.compiled.autotune, resolved=self.local_compute,
                    transpose_resolved=self.transpose_local_compute,
                    requested=self.spec.local_compute)


@register_executor("torch", "nap")
class NapTorchExecutor(_TorchExecutor):
    """Node-aware SpMV (Algorithm 3) on one device."""

    method = "nap"

    def _compile(self):
        from repro_torch.core.spmv_torch import compile_nap
        return compile_nap(self.a, self.row_part, self.topo, plan=self._plan,
                           local_compute=self.spec.local_compute,
                           col_part=self.col_part, device=self.device)

    def _programs(self):
        from repro_torch.core.spmv_torch import nap_forward, nap_transpose
        return nap_forward, nap_transpose

    def stats(self) -> Dict[str, object]:
        from repro_torch.core.spmv_torch import padded_traffic
        out = {f"messages_{k}": v for k, v in
               nap_stats(self.compiled.plan).items()}
        out.update(padded_traffic(self.compiled))
        return out

    def cost(self, machine: MachineParams) -> Dict[str, float]:
        return nap_cost(self.compiled.plan, machine)


@register_executor("torch", "standard")
class StandardTorchExecutor(_TorchExecutor):
    """Standard SpMV (Algorithm 1) on one device."""

    method = "standard"

    def _compile(self):
        from repro_torch.core.spmv_torch import compile_standard
        return compile_standard(self.a, self.row_part, self.topo,
                                plan=self._plan,
                                local_compute=self.spec.local_compute,
                                col_part=self.col_part, device=self.device)

    def _programs(self):
        from repro_torch.core.spmv_torch import (standard_forward,
                                                 standard_transpose)
        return standard_forward, standard_transpose

    def stats(self) -> Dict[str, object]:
        from repro_torch.core.spmv_torch import padded_traffic
        out = {f"messages_{k}": v for k, v in
               standard_stats(self.compiled.plan).items()}
        out.update(padded_traffic(self.compiled))
        return out

    def cost(self, machine: MachineParams) -> Dict[str, float]:
        return standard_cost(self.compiled.plan, machine)


@register_executor("torch", "multistep")
class MultistepTorchExecutor(_TorchExecutor):
    """The multi-step plan on the node-aware programs, which add the
    direct exchange when the compiled plan carries ``comm="multistep"``."""

    method = "multistep"

    def _compile(self):
        from repro_torch.core.spmv_torch import compile_multistep
        return compile_multistep(self.a, self.row_part, self.topo,
                                 plan=self._plan,
                                 local_compute=self.spec.local_compute,
                                 col_part=self.col_part,
                                 threshold=self.spec.threshold,
                                 device=self.device)

    def _programs(self):
        from repro_torch.core.spmv_torch import nap_forward, nap_transpose
        return nap_forward, nap_transpose

    def stats(self) -> Dict[str, object]:
        from repro_torch.comm.multistep import multistep_stats
        from repro_torch.core.spmv_torch import padded_traffic
        out = {f"messages_{k}": v for k, v in
               multistep_stats(self.compiled.ms_plan).items()}
        out.update(padded_traffic(self.compiled))
        return out

    def cost(self, machine: MachineParams) -> Dict[str, float]:
        return multistep_cost(self.compiled.ms_plan, machine)
