"""Executor registry behind :class:`repro_torch.api.NapOperator`.

An executor binds one (backend, method) pair to a matrix and a layout
and exposes what the operator front-end needs: ``forward(v)`` (global
``A @ v``, 1-RHS or multi-RHS), ``transpose(u)`` (global ``A.T @ u`` on
the same plan), ``stats()``, ``cost(machine)``, ``autotune_report()``,
``swap_values(a_new)`` and ``trace_counts()`` (the hot value swap and
the program builds it must leave flat), and with integrity on
``queue_fault`` and ``integrity_report()``.

Registered here:

* ``("torch", "nap")`` — the node-aware exchange (Algorithm 3);
* ``("torch", "standard")`` — the flat exchange (Algorithm 1), the
  paper's baseline;
* ``("torch", "multistep")`` — the node-aware exchange for columns that
  several processes of a node need, a direct owner -> requester hop for
  the rest (:mod:`repro_torch.comm.multistep`);

all three the rank-batched programs of :mod:`repro_torch.core.spmv_torch`
on one device (in a multi-process job, over the node block this process
owns: operands staged by :func:`repro_torch.mesh.buffers.input_stager`,
results all-gathered by :func:`~repro_torch.mesh.buffers.fetch_mesh_array`),
and

* ``("simulate", "nap" | "standard" | "multistep")`` — the exact float64
  message-passing simulators on the host (:mod:`repro_torch.core.spmv`,
  :mod:`repro_torch.comm.simulate`), the correctness oracles;
* ``("moe", "flat" | "nap" | "auto")`` — the MoE dispatch over a routing
  matrix (:mod:`repro_torch.moe`): the same simulators with the payloads
  quantized to ``spec.wire_dtype`` on the wire, on the host.

``integrity="detect"`` runs the instrumented programs (wire checksums
over every message, ABFT over every rank's local compute) and raises
:class:`repro_torch.core.integrity.IntegrityError` with the attributed
mismatches; ``"recover"`` retries a failed apply once from the retained
packed operand, which reproduces the fault-free result bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm_graph import (build_nap_plan, build_standard_plan,
                                         nap_stats, standard_stats)
from repro_torch.core.cost_model import (MachineParams, multistep_cost,
                                         nap_cost, standard_cost)
from repro_torch.core.integrity import (IntegrityError, IntegrityState,
                                        MessageFault, SimWire)
from repro_torch.core.partition import RowPartition
from repro_torch.core.spmv import (simulate_nap_spmv, simulate_nap_spmv_transpose,
                                   simulate_standard_spmv,
                                   simulate_standard_spmv_transpose)
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device
from repro_torch.mesh.buffers import fetch_mesh_array, input_stager


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """Everything an executor factory needs beyond (a, partitions, topo)."""

    method: str = "nap"
    backend: str = "torch"
    local_compute: str = "auto"
    device: Optional[str] = None    # None = CUDA; "cpu" only on request
    # duplication threshold of method="multistep" ("auto" or an int >= 1)
    threshold: object = "auto"
    pairing: str = "aligned"        # "balanced" on the simulate backend only
    integrity: str = "off"          # "off" | "detect" | "recover"
    cache: bool = True              # compile through the plan compile cache
    # payload encoding of the moe backend's wire: "f32" | "bf16" | "fp8_e4m3"
    wire_dtype: str = "f32"


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


def _integrity_state(spec: OperatorSpec, topo: Topology, method: str):
    return (IntegrityState(spec.integrity, topo, method)
            if spec.integrity != "off" else None)


def _mismatch_error(what: str, mism) -> IntegrityError:
    return IntegrityError(f"{what}: " + "; ".join(str(m) for m in mism), mism)


class _IntegritySurface:
    """``queue_fault`` and ``integrity_report`` over ``self._integrity``."""

    _integrity: Optional[IntegrityState] = None

    def queue_fault(self, fault: MessageFault) -> None:
        """Script a deterministic message fault for the NEXT matching
        apply (fires once; needs ``integrity != "off"``)."""
        if self._integrity is None:
            raise ValueError("fault injection requires integrity='detect' "
                             "or 'recover' on the operator")
        self._integrity.queue_fault(fault)

    def integrity_report(self) -> Dict[str, object]:
        if self._integrity is None:
            return {"mode": "off"}
        return self._integrity.report()


def check_operand(n: int, v) -> np.ndarray:
    """A global [n] vector or [n, nv] multivector, as numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v)
    if v.shape[:1] != (n,) or v.ndim > 2:
        raise ValueError(f"operand must be [{n}] or [{n}, nv], got {v.shape}")
    return v


class _TorchExecutor(_IntegritySurface):
    """One method's program on one device.  The plan compiles at the
    first apply; forward packs the operand by ``col_part`` and unpacks
    the result by ``row_part``, the transpose swaps both.  Subclasses
    give ``_compile()`` and ``_programs()`` (forward, transpose).

    With integrity on, every apply runs the instrumented program with the
    fault spec staged once on the device (``[n_nodes, ppn, n_phases,
    4]`` int32): arming a fault is a ``copy_`` into it, so the program
    never changes, and the spec is cleared after the apply."""

    backend = "torch"
    method = ""

    def __init__(self, a, row_part: RowPartition, col_part: RowPartition,
                 topo: Topology, spec: OperatorSpec, plan=None):
        self.a, self.topo, self.spec = a, topo, spec
        self.row_part, self.col_part = row_part, col_part
        self.device = resolve_device(spec.device)
        self._plan = plan       # a prebuilt plan of this method, or None
        self._compiled = None
        self._integrity = _integrity_state(spec, topo, type(self).method)
        self._fault_spec = None
        self._builds: Dict[str, int] = {}

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
        multi-step plan; ``fault_spec`` for the instrumented program,
        which returns ``(w, chk, abft)``)."""
        forward, transpose = self._programs()
        fn = forward if direction == "forward" else transpose
        c, lc = self.compiled, self.spec.local_compute
        return lambda s: fn(c, s, local_compute=lc, **options)

    def packed(self, direction: str, v) -> torch.Tensor:
        """Pack a global operand into device shards for :meth:`program`:
        for a plan that owns a node block of a multi-process job (its
        ``mesh``), the block's shards
        (:func:`repro_torch.mesh.buffers.input_stager`)."""
        from repro_torch.core.spmv_torch import pack_vector
        c = self.compiled
        if direction == "forward":
            part, pad, n = self.col_part, c.cols_pad, self.a.shape[1]
        else:
            part, pad, n = self.row_part, c.rows_pad, self.a.shape[0]
        shards = pack_vector(check_operand(n, v), part, self.topo, pad)
        stage = input_stager(c.mesh, self.device)
        if stage is None:
            return torch.from_numpy(shards).to(self.device)
        return stage(shards)

    def _apply(self, direction: str, v, **options) -> np.ndarray:
        """One apply: pack, run the program, fetch (in a multi-process job
        every process returns the whole result) and unpack."""
        from repro_torch.core.spmv_torch import unpack_vector
        before = None if self._compiled is None else self._compiled.builds
        shards = self.packed(direction, v)
        if self._integrity is not None:
            w = self._apply_verified(direction, shards, options)
        else:
            w = self.program(direction, **options)(shards)
        # the first apply of a direction builds its program, and so does
        # any apply that compiled the plan or staged an index tensor (a
        # new nv stages new element indices)
        built = (before is None or direction not in self._builds
                 or self._compiled.builds != before)
        self._builds[direction] = self._builds.get(direction, 0) + int(built)
        out_part = self.row_part if direction == "forward" else self.col_part
        return unpack_vector(fetch_mesh_array(w, self._compiled.mesh), out_part,
                             self.topo)

    def swap_values(self, a_new) -> None:
        """Hot-swap the matrix VALUES (the sparsity must be identical):
        the compiled plan writes its new value arrays into the staged
        tensors in place, so both directions' programs run on with no
        build.  Before the first apply there is no plan yet, and the
        swap only replaces the matrix the compile will read."""
        if self._compiled is None:
            from repro_torch.core.spmv_torch import check_same_structure
            check_same_structure(self.a, a_new)
        else:
            self._compiled.swap_values(a_new)
        self.a = a_new

    def trace_counts(self) -> Dict[str, int]:
        """Program builds per direction that has run: its first apply and
        every apply that compiled the plan or staged one of its index
        tensors (the port's analogue of the reference's jit traces).  A
        hot value swap leaves them flat."""
        return dict(self._builds)

    def _apply_verified(self, direction: str, shards: torch.Tensor,
                        options) -> torch.Tensor:
        """Arm the queued faults of this direction, run the instrumented
        program, verify its checksums and ABFT on the host; under
        ``"recover"`` retry once from the retained packed shards with the
        fault consumed (the same program on the same inputs, so the
        fault-free result bit for bit).  A mismatch that persists, or any
        under ``"detect"``, raises :class:`IntegrityError`.

        A plan that owns a node block of a multi-process job stages the
        block's rows of the (job-wide) fault spec, so a fault fires in the
        process that owns its sender, and all-gathers the checksum and ABFT
        words before it verifies them, as the reference fetches them: every
        process sees the same mismatches and takes the same branch (a
        process that retried alone would leave the others' collectives
        unmatched)."""
        st, c = self._integrity, self.compiled
        rows = slice(None) if c.mesh is None else slice(*c.mesh.nodes)
        if self._fault_spec is None:     # staged once, never aliasing host arrays
            self._fault_spec = torch.zeros(st.fetch_spec()[rows].shape,
                                           dtype=torch.int32, device=self.device)
        n_terms = c.rows_pad + c.packed_x_len
        prog = self.program(direction, fault_spec=self._fault_spec, **options)

        def run():
            self._fault_spec.copy_(torch.from_numpy(st.fetch_spec()[rows]))
            w, chk, abft = prog(shards)
            return w, st.verify(fetch_mesh_array(chk, c.mesh),
                                fetch_mesh_array(abft, c.mesh), direction, n_terms)

        st.counters["applies"] += 1
        st.arm(direction)
        try:
            w, mism = run()
            if not mism:
                return w
            if st.mode == "detect":
                raise _mismatch_error(f"{len(mism)} integrity mismatch(es) on "
                                      f"{direction} apply", mism)
            # recover: the faults were consumed at arm time
            st.counters["retries"] += 1
            st.disarm()
            w, mism = run()
            if mism:
                raise _mismatch_error(f"integrity mismatch persisted through "
                                      f"retry on {direction} apply", mism)
            st.counters["recovered"] += 1
            return w
        finally:
            st.disarm()
            self._fault_spec.zero_()

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
                           cache=self.spec.cache,
                           local_compute=self.spec.local_compute,
                           col_part=self.col_part, device=self.device)

    def _programs(self):
        from repro_torch.core.spmv_torch import nap_forward, nap_transpose
        return nap_forward, nap_transpose

    def stats(self) -> Dict[str, object]:
        from repro_torch.core.spmv_torch import padded_traffic
        out = {f"messages_{k}": v for k, v in
               nap_stats(self.compiled.plan).items()}
        out.update(padded_traffic(self.compiled, integrity=self.spec.integrity))
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
                                plan=self._plan, cache=self.spec.cache,
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
        out.update(padded_traffic(self.compiled, integrity=self.spec.integrity))
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
                                 plan=self._plan, cache=self.spec.cache,
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
        out.update(padded_traffic(self.compiled, integrity=self.spec.integrity))
        return out

    def cost(self, machine: MachineParams) -> Dict[str, float]:
        return multistep_cost(self.compiled.ms_plan, machine)


class _SimulateExecutor(_IntegritySurface):
    """The exact float64 message-passing simulators on the host (numpy;
    no device); a multi-RHS operand runs column by column.  The plan is
    built at the first apply."""

    backend = "simulate"
    method = ""
    local_compute = "numpy"
    transpose_local_compute = "numpy"

    def __init__(self, a, row_part: RowPartition, col_part: RowPartition,
                 topo: Topology, spec: OperatorSpec, plan=None):
        self.a, self.topo, self.spec = a, topo, spec
        self.row_part, self.col_part = row_part, col_part
        self._plan = plan
        self._integrity = _integrity_state(spec, topo, type(self).method)

    @property
    def plan(self):
        if self._plan is None:
            self._plan = self._build_plan()
        return self._plan

    def _columnwise(self, fn, v, n: int) -> np.ndarray:
        v = np.asarray(check_operand(n, v), dtype=np.float64)
        if v.ndim == 1:
            return fn(v)
        return np.stack([fn(v[:, i]) for i in range(v.shape[1])], axis=1)

    def forward(self, v, materialize_x: bool = False) -> np.ndarray:
        """``materialize_x`` is a device-program switch; the simulators
        have one packed x and ignore it."""
        if self._integrity is None:
            return self._columnwise(self._forward, v, self.a.shape[1])
        return self._forward_verified(v)

    def _forward_verified(self, v) -> np.ndarray:
        """Integrity over the numpy mailboxes: one :class:`SimWire` spans
        the whole (possibly multi-RHS) apply and a scripted fault fires on
        its first matching message.  Detect raises; recover re-runs
        clean (the faults are consumed), exact by construction."""
        st = self._integrity
        st.counters["applies"] += 1
        wire = SimWire(self.topo, st.take_pending("forward"))
        out = self._columnwise(lambda col: self._forward(col, wire=wire), v,
                               self.a.shape[1])
        mism = st.note_sim(wire)
        if not mism:
            return out
        if st.mode == "detect":
            raise _mismatch_error(f"{len(mism)} integrity mismatch(es) on "
                                  f"forward apply", mism)
        st.counters["retries"] += 1
        out = self._columnwise(self._forward, v, self.a.shape[1])
        st.counters["recovered"] += 1
        return out

    def transpose(self, u) -> np.ndarray:
        st = self._integrity
        if st is not None:
            if any(f.direction in ("any", "transpose") for f in st.pending):
                raise NotImplementedError(
                    "message-fault injection on the transpose direction runs "
                    "on backend='torch': the simulate transposes reverse the "
                    "exchange phases algebraically without mailboxes")
            st.counters["applies"] += 1
        return self._columnwise(self._transpose, u, self.a.shape[0])

    def swap_values(self, a_new) -> None:
        """Hot-swap the matrix VALUES; the plan is pure structure and is
        reused as it is.  Same structural contract as the device backend."""
        from repro_torch.core.spmv_torch import check_same_structure
        check_same_structure(self.a, a_new)
        self.a = a_new

    def trace_counts(self) -> Dict[str, int]:
        return {}   # nothing is built: exact numpy execution

    def autotune_report(self) -> Dict[str, object]:
        return {"resolved": self.local_compute,
                "transpose_resolved": self.transpose_local_compute,
                "note": "the simulate backend runs exact numpy local compute "
                        "in both directions; the format autotuner applies to "
                        "the device programs only"}


@register_executor("simulate", "nap")
class NapSimulateExecutor(_SimulateExecutor):
    method = "nap"

    def _build_plan(self):
        return build_nap_plan(self.a.indptr, self.a.indices, self.row_part,
                              self.topo, pairing=self.spec.pairing,
                              col_part=self.col_part)

    def _forward(self, v, wire=None):
        return simulate_nap_spmv(self.a, v, self.plan, wire=wire)

    def _transpose(self, u):
        return simulate_nap_spmv_transpose(self.a, u, self.plan)

    def stats(self) -> Dict[str, object]:
        return {f"messages_{k}": v for k, v in nap_stats(self.plan).items()}

    def cost(self, machine: MachineParams) -> Dict[str, float]:
        return nap_cost(self.plan, machine)


@register_executor("simulate", "multistep")
class MultistepSimulateExecutor(_SimulateExecutor):
    method = "multistep"

    def _build_plan(self):
        from repro_torch.comm.multistep import build_multistep_plan
        return build_multistep_plan(self.a.indptr, self.a.indices,
                                    self.row_part, self.topo,
                                    pairing=self.spec.pairing,
                                    col_part=self.col_part,
                                    threshold=self.spec.threshold)

    def _forward(self, v, wire=None):
        from repro_torch.comm.simulate import simulate_multistep_spmv
        return simulate_multistep_spmv(self.a, v, self.plan, wire=wire)

    def _transpose(self, u):
        from repro_torch.comm.simulate import simulate_multistep_spmv_transpose
        return simulate_multistep_spmv_transpose(self.a, u, self.plan)

    def stats(self) -> Dict[str, object]:
        from repro_torch.comm.multistep import multistep_stats
        return {f"messages_{k}": v for k, v in
                multistep_stats(self.plan).items()}

    def cost(self, machine: MachineParams) -> Dict[str, float]:
        return multistep_cost(self.plan, machine)


@register_executor("simulate", "standard")
class StandardSimulateExecutor(_SimulateExecutor):
    method = "standard"

    def _build_plan(self):
        return build_standard_plan(self.a.indptr, self.a.indices,
                                   self.row_part, self.topo,
                                   col_part=self.col_part)

    def _forward(self, v, wire=None):
        return simulate_standard_spmv(self.a, v, self.plan, wire=wire)

    def _transpose(self, u):
        return simulate_standard_spmv_transpose(self.a, u, self.plan)

    def stats(self) -> Dict[str, object]:
        return {f"messages_{k}": v for k, v in
                standard_stats(self.plan).items()}

    def cost(self, machine: MachineParams) -> Dict[str, float]:
        return standard_cost(self.plan, machine)


# ---------------------------------------------------------------------------
# MoE dispatch backend: a routing matrix over the simulate mailboxes, with
# quantized wire payloads (repro_torch.moe)
# ---------------------------------------------------------------------------

class _MoeDispatchExecutor(_SimulateExecutor):
    """The moe-dispatch executors over the numpy mailboxes.

    Beside the plain simulate backend:

    * every forward apply threads the wire of
      :func:`repro_torch.moe.wire.make_wire`: a narrow ``spec.wire_dtype``
      quantizes each payload at its send and accumulates it in float64
      on receive; ``"f32"`` without integrity threads none (bit-equal to
      the plain simulators);
    * the transpose (the weighted combine) quantizes its operand once
      before the reverse route: one combine hop (the island's nap
      combine pays up to 2, which ``wire_error_bound`` budgets);
    * integrity checksums the quantized words, and recover retries
      through a clean quantizing wire, so the retried result still
      carries the wire's rounding;
    * ``stats()`` adds the dispatch and combine injected bytes at the
      wire width.

    They run on the host and ignore ``spec.device``.
    """

    backend = "moe"

    def _wire(self, faults=()):
        from repro_torch.moe.wire import make_wire
        return make_wire(self.topo, self.spec.wire_dtype, faults,
                         force=self._integrity is not None)

    def forward(self, v, materialize_x: bool = False) -> np.ndarray:
        if self._integrity is None:
            wire = self._wire()
            return self._columnwise(lambda col: self._forward(col, wire=wire),
                                    v, self.a.shape[1])
        return self._forward_verified(v)

    def _forward_verified(self, v) -> np.ndarray:
        st = self._integrity
        st.counters["applies"] += 1
        wire = self._wire(st.take_pending("forward"))
        out = self._columnwise(lambda col: self._forward(col, wire=wire), v,
                               self.a.shape[1])
        mism = st.note_sim(wire)
        if not mism:
            return out
        if st.mode == "detect":
            raise _mismatch_error(f"{len(mism)} integrity mismatch(es) on "
                                  f"forward apply", mism)
        st.counters["retries"] += 1
        clean = self._wire()
        out = self._columnwise(lambda col: self._forward(col, wire=clean), v,
                               self.a.shape[1])
        st.counters["recovered"] += 1
        return out

    def transpose(self, u) -> np.ndarray:
        from repro_torch.moe.wire import quantize_np
        u = np.asarray(check_operand(self.a.shape[0], u), dtype=np.float64)
        return super().transpose(quantize_np(u, self.spec.wire_dtype))

    def stats(self) -> Dict[str, object]:
        from repro_torch.moe.plan import dispatch_traffic
        out = {f"messages_{k}": v for k, v in self._plan_stats().items()}
        for direction, name in (("forward", "dispatch"),
                                ("transpose", "combine")):
            t = dispatch_traffic(self.plan, wire_dtype=self.spec.wire_dtype,
                                 nv=1, direction=direction,
                                 integrity=self.spec.integrity)
            out[f"{name}_injected_inter_bytes"] = t["injected_inter_bytes"]
            out[f"{name}_injected_intra_bytes"] = t["injected_intra_bytes"]
            out["bytes_per_val"] = t["bytes_per_val"]
        out["wire_dtype"] = self.spec.wire_dtype
        return out

    def autotune_report(self) -> Dict[str, object]:
        rep = super().autotune_report()
        rep.update(wire_dtype=self.spec.wire_dtype,
                   dispatch_resolved=type(self).method,
                   combine_resolved=type(self).method)
        return rep


@register_executor("moe", "flat")
class FlatMoeDispatchExecutor(_MoeDispatchExecutor, StandardSimulateExecutor):
    """Algorithm-1 analogue: every (token, owning-chip) payload crosses
    the flat pairwise exchange directly."""

    method = "flat"

    def _plan_stats(self):
        return standard_stats(self.plan)


@register_executor("moe", "nap")
class NapMoeDispatchExecutor(_MoeDispatchExecutor, NapSimulateExecutor):
    """The three-step node-aware dispatch: a token bound for several
    experts of one remote pod crosses the pod boundary once (intra
    gather, one aggregated inter-pod exchange, intra scatter); the
    combine reverses every message."""

    method = "nap"

    def _plan_stats(self):
        return nap_stats(self.plan)


@register_executor("moe", "auto")
class AutoMoeDispatchExecutor:
    """Per-direction flat-vs-nap resolution of the MoE dispatch.

    Scores :func:`repro_torch.moe.plan.choose_dispatch` over the routing
    once, then delegates: ``forward`` runs the chosen dispatch executor,
    ``transpose`` the chosen combine executor (they may differ, as with
    ``comm="auto"``).  The candidate plans are built once and shared.
    """

    backend = "moe"
    method = "auto"
    local_compute = "numpy"
    transpose_local_compute = "numpy"

    def __init__(self, a, row_part: RowPartition, col_part: RowPartition,
                 topo: Topology, spec: OperatorSpec, plan=None):
        from repro_torch.moe.plan import build_dispatch_plans, choose_dispatch
        self.a, self.topo, self.spec = a, topo, spec
        self.row_part, self.col_part = row_part, col_part
        plans = build_dispatch_plans(a, row_part, col_part, topo,
                                     pairing=spec.pairing)
        verdict = choose_dispatch(a, row_part, col_part, topo,
                                  wire_dtype=spec.wire_dtype,
                                  integrity=spec.integrity, plans=plans)
        self.dispatch_report = {"dispatch": verdict["dispatch"],
                                "combine": verdict["combine"]}

        def sub(method: str):
            return _REGISTRY[("moe", method)](
                a, row_part, col_part, topo,
                dataclasses.replace(spec, method=method), plan=plans[method])

        fwd_m = verdict["dispatch"]["chosen"]
        bwd_m = verdict["combine"]["chosen"]
        self._fwd = sub(fwd_m)
        self._bwd = self._fwd if bwd_m == fwd_m else sub(bwd_m)

    def forward(self, v, materialize_x: bool = False) -> np.ndarray:
        return self._fwd.forward(v)

    def transpose(self, u) -> np.ndarray:
        return self._bwd.transpose(u)

    def queue_fault(self, fault: MessageFault) -> None:
        target = self._bwd if fault.direction == "transpose" else self._fwd
        target.queue_fault(fault)

    def integrity_report(self) -> Dict[str, object]:
        rep = dict(self._fwd.integrity_report())
        if self._bwd is not self._fwd:
            rep["combine"] = self._bwd.integrity_report()
        return rep

    def swap_values(self, a_new) -> None:
        self._fwd.swap_values(a_new)
        if self._bwd is not self._fwd:
            self._bwd.swap_values(a_new)
        self.a = a_new

    def trace_counts(self) -> Dict[str, int]:
        return {}

    def stats(self) -> Dict[str, object]:
        out = dict(self._fwd.stats())
        if self._bwd is not self._fwd:
            b = self._bwd.stats()
            out["combine_injected_inter_bytes"] = \
                b["combine_injected_inter_bytes"]
            out["combine_injected_intra_bytes"] = \
                b["combine_injected_intra_bytes"]
        out["dispatch_resolved"] = type(self._fwd).method
        out["combine_resolved"] = type(self._bwd).method
        return out

    def cost(self, machine: MachineParams) -> Dict[str, float]:
        return self._fwd.cost(machine)

    def autotune_report(self) -> Dict[str, object]:
        return {"resolved": "numpy", "transpose_resolved": "numpy",
                "requested": "auto",
                "wire_dtype": self.spec.wire_dtype,
                "dispatch_resolved": type(self._fwd).method,
                "combine_resolved": type(self._bwd).method,
                "moe_dispatch": self.dispatch_report}
