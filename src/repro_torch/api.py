"""One linear-operator front end over the port's executors::

    import repro_torch.api as nap

    op = nap.operator(a, Topology(n_nodes=32, ppn=16))
    w = op @ v         # forward SpMV ([n] or [n, nv] multi-RHS)
    z = op.T @ u       # transpose SpMV, the same compiled plan reversed
    op.stats(), op.autotune_report()
    op.cost(BLUE_WATERS)   # the paper's message model (Eqs. 10-12)

``method="nap"`` is the node-aware exchange (Algorithm 3),
``method="standard"`` the paper's baseline (Algorithm 1) and
``method="multistep"`` the duplication-split node-aware exchange
(:mod:`repro_torch.comm`).  ``comm=`` pins one of them, or ``"auto"``
lets the chooser pick one per direction.

**Rectangular operators.**  An operator is an ``[m, n]`` map over two
partitions: ``row_part`` lays out the m output rows, ``col_part`` the n
input entries; ``op.T`` swaps the two through the same compiled plan.
``part=`` is the square-case sugar that sets both::

    p_op = nap.operator(p, topo, row_part=fine, col_part=coarse)
    r = p_op.T @ residual      # node-aware AMG restriction

**Composition.**  ``@`` between operators is lazy: ``R @ A @ P`` is a
:class:`ComposedOperator` that applies the factors right to left, with
shapes and interface partitions checked when it is composed.
``.materialize()`` collapses it into one concrete operator through the
node-aware distributed SpGEMM (:mod:`repro_torch.spgemm`).

**Backends.**  ``backend="torch"`` runs the rank-batched program on the
GPU; ``device="cpu"`` is the only way off it.  ``backend="simulate"``
runs the float64 message-passing simulators on the host (numpy, no
device), the paper's exact semantics; it alone takes the paper's
``pairing="balanced"`` slot rule.  Operands are global numpy arrays (or
CPU tensors); results are numpy float32 on the device backend and
float64 on simulate (``precision=`` pins one).  The plan compiles at the
first apply.

**Integrity.**  ``integrity="detect"`` checksums every message of every
exchange and checks each rank's local compute by ABFT; a mismatch raises
:class:`IntegrityError` with its phase, message and rank.
``"recover"`` retries the apply once and returns the fault-free result
bit for bit.  ``op.inject_fault(...)`` scripts a deterministic fault for
the next apply (``op.T.inject_fault`` for the transpose), and
``op.integrity_report()`` counts checks, mismatches and strikes::

    op = nap.operator(a, topo, integrity="detect")
    op.inject_fault("inter", "bitflip", node=1, proc=0, slot=0)
    op @ v             # raises IntegrityError (wire, inter, off_node)
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.comm import COMM_CHOICES, choose_comm
from repro_torch.core.comm_graph import check_pairing
from repro_torch.core.cost_model import MachineParams
from repro_torch.core.executors import (OperatorSpec, available_executors,
                                        bind_executor, register_executor)
from repro_torch.core.integrity import IntegrityError, MessageFault
from repro_torch.core.partition import RowPartition, contiguous_partition
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike

__all__ = ["operator", "NapOperator", "ComposedOperator", "IntegrityError",
           "MessageFault", "available_executors", "register_executor"]

INTEGRITY_MODES = ("off", "detect", "recover")


def operator(a, topo: Topology, part: Optional[RowPartition] = None, *,
             row_part: Optional[RowPartition] = None,
             col_part: Optional[RowPartition] = None,
             method: str = "nap", backend: str = "torch",
             comm: Optional[str] = None, threshold: object = "auto",
             local_compute: str = "auto", pairing: str = "aligned",
             integrity: str = "off",
             device: DeviceLike = None) -> "NapOperator":
    """Build a :class:`NapOperator` for the ``[m, n]`` matrix ``a``.

    ``topo`` is the (n_nodes, ppn) rank grid.  ``row_part`` lays out the
    m output rows (contiguous by default); ``col_part`` the n input
    entries (``row_part`` when the matrix is square, else contiguous).
    Ranks may own no entry.  ``part`` sets both and needs ``m == n``.
    ``method`` is ``"nap"``, ``"standard"`` or ``"multistep"``;
    ``threshold`` is the multistep duplication threshold (``"auto"`` or
    an int >= 1: columns that fewer processes of a node need go direct).
    ``comm`` pins the exchange over ``method``, or with ``"auto"`` picks
    it per direction (:func:`repro_torch.comm.choose_comm`); when the
    two directions disagree the operator holds a second executor for
    the transpose, and the verdict rides in ``autotune_report()``.
    ``local_compute`` is ``"auto"`` (the format autotuner's verdict, per
    direction), ``"ell"``, ``"bsr"`` or ``"coo"``; the transpose has no
    BSR kernel and resolves ``"bsr"`` to the ell/coo verdict.
    ``backend`` is ``"torch"`` (the device programs) or ``"simulate"``
    (the float64 host simulators).  ``pairing`` is the inter-node slot
    rule of the node-aware plans: ``"aligned"``, or the paper's
    ``"balanced"`` on the simulate backend.  ``integrity`` is ``"off"``,
    ``"detect"`` or ``"recover"`` (module docstring); the chooser then
    charges the checksum wires.  ``device`` defaults to CUDA and raises
    when it is absent; the simulate backend runs on the host.
    """
    m, n = a.shape
    if topo is None:
        raise ValueError("pass the rank grid topo= explicitly")
    if part is not None:
        if row_part is not None or col_part is not None:
            raise ValueError("pass either part= (square sugar) or "
                             "row_part=/col_part=, not both")
        if m != n:
            raise ValueError(
                f"part= is the square-case sugar (sets row AND col "
                f"partition); a is {a.shape} — pass row_part=/col_part=")
        row_part = col_part = part
    if row_part is None:
        row_part = contiguous_partition(m, topo.n_procs)
    if col_part is None:
        col_part = (row_part if n == row_part.n_rows
                    else contiguous_partition(n, topo.n_procs))
    if row_part.n_rows != m or col_part.n_rows != n:
        raise ValueError(
            f"partition/matrix mismatch: a is {a.shape}, row_part has "
            f"{row_part.n_rows} rows, col_part {col_part.n_rows}")
    check_pairing(pairing, backend)
    if integrity not in INTEGRITY_MODES:
        raise ValueError(f"integrity must be one of {INTEGRITY_MODES}, "
                         f"got {integrity!r}")
    comm_report, t_method, plans = None, None, {}
    if comm is not None:
        if comm not in COMM_CHOICES:
            raise ValueError(f"comm must be one of {COMM_CHOICES}, got {comm!r}")
        if comm == "auto":
            verdict = choose_comm(a.indptr, a.indices, row_part, topo,
                                  pairing=pairing, col_part=col_part,
                                  threshold=threshold, integrity=integrity)
            plans = verdict["plans"]
            method = verdict["forward"]["chosen"]
            t_method = verdict["transpose"]["chosen"]
            comm_report = {
                "requested": "auto", "resolved": method,
                "transpose_resolved": t_method,
                "threshold": verdict["threshold"],
                "forward": verdict["forward"],
                "transpose": verdict["transpose"],
            }
        else:
            method = t_method = comm
            comm_report = {"requested": comm, "resolved": comm,
                           "transpose_resolved": comm}
    spec = OperatorSpec(method=method, backend=backend,
                        local_compute=local_compute,
                        device=None if device is None else str(device),
                        threshold=threshold, pairing=pairing,
                        integrity=integrity)
    exec_ = bind_executor(backend, method, a, row_part, col_part, topo, spec,
                          plan=plans.get(method))
    t_exec = None
    if t_method is not None and t_method != method:
        # the directions disagree: the transpose runs on its own plan
        t_exec = bind_executor(backend, t_method, a, row_part, col_part, topo,
                               dataclasses.replace(spec, method=t_method),
                               plan=plans.get(t_method))
    return NapOperator(a=a, row_part=row_part, col_part=col_part, topo=topo,
                       spec=spec, executor=exec_, transpose_executor=t_exec,
                       comm_report=comm_report)


def _check_precision(precision: Optional[str], backend: str) -> None:
    if precision not in (None, "float32", "float64"):
        raise ValueError(f"precision must be float32|float64, got {precision!r}")
    if precision == "float64" and backend != "simulate":
        raise NotImplementedError(
            f"backend={backend!r} computes in float32; use "
            f"backend='simulate' for float64 results")


def _is_operator(x) -> bool:
    return isinstance(x, (NapOperator, ComposedOperator))


@dataclasses.dataclass
class NapOperator:
    """Distributed SpMV as a linear operator: ``op @ x`` applies ``A``,
    ``op.T @ x`` applies ``A.T`` through the SAME compiled plan (or the
    transpose executor ``comm="auto"`` chose); ``op @ other_op`` composes
    lazily into a :class:`ComposedOperator`."""

    a: object
    row_part: RowPartition
    col_part: RowPartition
    topo: Topology
    spec: OperatorSpec
    executor: object
    # set when comm="auto" resolves the two directions to different
    # strategies: the transpose runs through its own executor
    transpose_executor: Optional[object] = None
    comm_report: Optional[dict] = None
    transposed: bool = False
    _parent: Optional["NapOperator"] = dataclasses.field(default=None, repr=False)

    @property
    def _transpose_executor(self):
        return self.transpose_executor or self.executor

    def __call__(self, x, materialize_x: bool = False,
                 precision: Optional[str] = None) -> np.ndarray:
        """Apply the operator.  ``materialize_x=True`` concatenates the
        packed x before the forward local compute instead of passing its
        three segments (an A/B switch, bit-equal on the BSR path).
        ``precision`` pins the result dtype, ``"float32"`` or
        ``"float64"`` (None: the backend's own, float32 on the device,
        float64 on simulate); the device programs compute in float32, so
        asking them for float64 raises."""
        _check_precision(precision, self.spec.backend)
        if self.transposed:
            out = self._transpose_executor.transpose(x)
        else:
            out = self.executor.forward(x, materialize_x)
        return out if precision is None else np.asarray(out, dtype=precision)

    def __matmul__(self, x):
        if _is_operator(x):
            return ComposedOperator.of(self, x)
        return self(x)

    def matvec(self, x) -> np.ndarray:
        return self(x)

    @property
    def shape(self) -> Tuple[int, int]:
        m, n = self.a.shape
        return (n, m) if self.transposed else (m, n)

    @property
    def range_part(self) -> RowPartition:
        """Partition of THIS view's output (``shape[0]`` entries)."""
        return self.col_part if self.transposed else self.row_part

    @property
    def domain_part(self) -> RowPartition:
        """Partition of THIS view's operand (``shape[1]`` entries)."""
        return self.row_part if self.transposed else self.col_part

    @property
    def method(self) -> str:
        """The exchange of THIS direction."""
        if self.transposed:
            return self._transpose_executor.method
        return self.executor.method

    @property
    def T(self) -> "NapOperator":
        """Transpose view sharing the executors (``op.T.T is op``)."""
        if self._parent is not None:
            return self._parent
        return dataclasses.replace(self, transposed=not self.transposed,
                                   _parent=self)

    @property
    def local_compute(self) -> str:
        """Resolved local-compute format of THIS direction."""
        if self.transposed:
            return self._transpose_executor.transpose_local_compute
        return self.executor.local_compute

    def stats(self):
        """Message statistics and padded traffic of THIS direction's plan."""
        return (self._transpose_executor if self.transposed
                else self.executor).stats()

    def cost(self, machine: MachineParams):
        """Modeled communication time of THIS direction's plan on
        ``machine`` (paper Eqs. 10-12): a model of that machine, not a
        time on the GPU."""
        return (self._transpose_executor if self.transposed
                else self.executor).cost(machine)

    def integrity_report(self):
        """Check and mismatch counters, scope attribution, per-node strikes
        and quarantine candidates (``{"mode": "off"}`` without integrity);
        the transpose executor's under ``"transpose_executor"``."""
        rep = self.executor.integrity_report()
        if self.transpose_executor is not None:
            rep = dict(rep)
            rep["transpose_executor"] = self.transpose_executor.integrity_report()
        return rep

    def inject_fault(self, phase: str, kind: str = "bitflip", *,
                     node: int = 0, proc: int = 0, slot: int = 0,
                     element: int = 0, bit: int = 30,
                     direction: Optional[str] = None) -> MessageFault:
        """Script ONE deterministic fault for the next matching apply
        (needs ``integrity != "off"``; it fires once).  ``(node, proc)``
        is the sender, ``slot`` the destination's message slot (its
        local rank for full / init / final, its node for inter, its flat
        rank for pair / direct); ``phase="compute"`` flips a bit of the
        sender's local result.  ``direction`` defaults to this view's."""
        if direction is None:
            direction = "transpose" if self.transposed else "forward"
        fault = MessageFault(phase=phase, kind=kind, node=node, proc=proc,
                             slot=slot, element=element, bit=bit,
                             direction=direction)
        self.queue_fault(fault)
        return fault

    def queue_fault(self, fault: MessageFault) -> None:
        """Script a prebuilt :class:`MessageFault`; a transpose fault goes
        to the transpose executor where ``comm="auto"`` gave it one."""
        if fault.direction == "transpose" and self.transpose_executor is not None:
            self.transpose_executor.queue_fault(fault)
        else:
            self.executor.queue_fault(fault)

    def autotune_report(self):
        """Format verdict (forward at the top, transpose under
        ``"transpose"``), its stats and modeled times, and the resolved
        formats of both directions; with ``comm=``, the exchange verdict
        under ``"comm"`` / ``"comm_resolved"`` /
        ``"comm_transpose_resolved"``."""
        rep = self.executor.autotune_report()
        if self.comm_report is None:
            return rep
        rep = dict(rep)
        rep["comm"] = self.comm_report
        rep["comm_resolved"] = self.comm_report["resolved"]
        rep["comm_transpose_resolved"] = self.comm_report["transpose_resolved"]
        return rep

    def __repr__(self) -> str:
        t = ".T" if self.transposed else ""
        m, n = self.shape
        return (f"NapOperator{t}(shape=({m}, {n}), method={self.method!r}, "
                f"backend={self.spec.backend!r}, "
                f"topo=({self.topo.n_nodes}x{self.topo.ppn}))")


@dataclasses.dataclass(frozen=True)
class ComposedOperator:
    """Lazy right-to-left chain: ``(R @ A @ P) @ x`` runs ``P @ x``, then
    ``A``, then ``R``, three node-aware SpMVs; the product is never
    formed.

    Composing checks that adjacent shapes chain (``left.shape[1] ==
    right.shape[0]``) and that the interface partitions match
    (``left.domain_part`` lays out the entries ``right.range_part``
    produces), so values flow stage to stage with no hidden
    repartition.  ``stats`` / ``cost`` / ``autotune_report`` report per
    stage, ``cost()["total"]`` summing the chain.
    """

    factors: Tuple  # application order: factors[0] @ (... @ (factors[-1] @ x))

    @staticmethod
    def of(left, right) -> "ComposedOperator":
        """Compose two operators (either may already be composed)."""
        lf = left.factors if isinstance(left, ComposedOperator) else (left,)
        rf = right.factors if isinstance(right, ComposedOperator) else (right,)
        factors = tuple(lf) + tuple(rf)
        for lo, ro in zip(factors[:-1], factors[1:]):
            if lo.shape[1] != ro.shape[0]:
                raise ValueError(
                    f"operator shapes do not chain: {lo.shape} @ {ro.shape}")
            lp, rp = lo.domain_part, ro.range_part
            if lp.n_procs != rp.n_procs or not np.array_equal(lp.owner, rp.owner):
                raise ValueError(
                    "incompatible partitions at a composition interface: "
                    f"{lo!r} consumes a different layout than {ro!r} "
                    "produces — rebuild one side so the interface "
                    "partitions match (no hidden repartition)")
        return ComposedOperator(factors=factors)

    def __call__(self, x, precision: Optional[str] = None) -> np.ndarray:
        """Apply the factors right to left; ``precision`` pins the dtype
        of the result."""
        for f in reversed(self.factors):
            x = f(x)
        return x if precision is None else np.asarray(x, dtype=precision)

    def __matmul__(self, x):
        if _is_operator(x):
            return ComposedOperator.of(self, x)
        return self(x)

    def matvec(self, x) -> np.ndarray:
        return self(x)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.factors[0].shape[0], self.factors[-1].shape[1])

    @property
    def range_part(self) -> RowPartition:
        return self.factors[0].range_part

    @property
    def domain_part(self) -> RowPartition:
        return self.factors[-1].domain_part

    @property
    def T(self) -> "ComposedOperator":
        """(ABC).T = C.T B.T A.T, each stage's node-aware transpose."""
        return ComposedOperator(factors=tuple(f.T for f in reversed(self.factors)))

    def stats(self) -> List[object]:
        """Per-stage plan statistics, left to right."""
        return [f.stats() for f in self.factors]

    def cost(self, machine: MachineParams):
        """Per-stage modeled comm times and their sum (the stages depend
        on each other, so the chain is sequential)."""
        stages = [f.cost(machine) for f in self.factors]
        return {"stages": stages, "total": float(sum(s["total"] for s in stages))}

    def autotune_report(self) -> List[object]:
        return [f.autotune_report() for f in self.factors]

    def materialize(self, *, spgemm_backend: Optional[str] = None,
                    spgemm_method: Optional[str] = None, dtype=None,
                    cross_check: bool = False) -> NapOperator:
        """Collapse the lazy chain into ONE concrete :class:`NapOperator`
        on the outer partitions, multiplying the factors right to left
        through the node-aware distributed SpGEMM
        (:mod:`repro_torch.spgemm`): remote B rows route through the same
        exchanges as the SpMV plans, carrying CSR row blocks.

        The lazy chain pays k SpMVs per apply; the concrete operator pays
        the SpGEMM once and one SpMV per apply.

        ``spgemm_backend`` is ``"simulate"`` (exact float64 products, bit
        for bit the host ``csr_matmul`` chain) or ``"torch"`` (the device
        program, in ``dtype`` payloads: float32 unless
        ``torch.float64``); it defaults to ``"simulate"`` when any factor
        runs the simulate backend, else ``"torch"``.  ``spgemm_method``
        defaults to the leftmost factor's method where the SpGEMM has it
        (``"nap"`` or ``"standard"``), else ``"nap"``.
        ``cross_check=True`` holds the product against the host
        ``csr_matmul`` chain.  The result reuses the leftmost factor's
        spec (method, backend, local compute, pairing, integrity,
        threshold) and device, on which the products run too.
        """
        from repro_torch.spgemm import assert_matches_host, distributed_spgemm

        factors = self.factors
        topo = factors[0].topo
        for f in factors:
            if (f.topo.n_nodes, f.topo.ppn) != (topo.n_nodes, topo.ppn):
                raise ValueError("cannot materialize a chain spanning "
                                 "different topologies")
        spec = factors[0].spec
        backend = spgemm_backend or (
            "simulate" if any(f.spec.backend == "simulate" for f in factors)
            else "torch")
        method = spgemm_method or (spec.method if spec.method in ("nap", "standard")
                                   else "nap")

        def csr_of(f: NapOperator):
            return f.a.transpose() if f.transposed else f.a

        cur = csr_of(factors[-1])
        for f in reversed(factors[:-1]):
            cur = distributed_spgemm(csr_of(f), cur, f.range_part,
                                     f.domain_part, topo, method=method,
                                     backend=backend, dtype=dtype,
                                     device=spec.device)
        if cross_check:
            from repro_torch.amg.matmul import csr_matmul
            want = csr_of(factors[-1])
            for f in reversed(factors[:-1]):
                want = csr_matmul(csr_of(f), want)
            assert_matches_host(cur, want, backend, "materialize")
        return operator(cur, topo, row_part=self.range_part,
                        col_part=self.domain_part, method=spec.method,
                        backend=spec.backend, threshold=spec.threshold,
                        local_compute=spec.local_compute, pairing=spec.pairing,
                        integrity=spec.integrity, device=spec.device)

    def __repr__(self) -> str:
        return f"ComposedOperator({' @ '.join(repr(f) for f in self.factors)})"
