"""The long-lived multi-tenant solve service over the NAP operator stack.

``SolverService`` fronts :func:`repro_torch.api.operator` with the production
concerns a persistent deployment needs, as ONE deterministic synchronous
pump — every externally visible decision happens at a ``step()``
boundary against an injectable clock, so fault scenarios replay exactly:

admit      ``submit()`` runs bounded admission: a full queue, an
           unmeetable deadline, an unknown matrix, or a degraded fleet
           reject immediately with a reason (never block, never
           deadlock).
batch      each step, the ready requests sort earliest-deadline-first
           and the head request's (matrix, kind) group executes as ONE
           multi-RHS apply — concurrent RHS vectors ride the device
           program's nv columns instead of looping 1-RHS calls.
solve      ``kind="spmv"`` applies A once; ``kind="solve"`` runs batched
           CG (per-column convergence, shared SpMVs), checkpointing the
           iterate block every ``checkpoint_every`` iterations through
           :class:`repro_torch.checkpoint.store.CheckpointManager`.
recover    dead nodes (heartbeat timeout) and stragglers (z-score) evict
           through one elastic path: survivor topology
           (``ElasticPolicy.survivor_topology``) → row repartition per
           matrix (``survivor_partition`` — survivors keep their rows)
           → plan-cache rebuild + eager recompile on the new layout →
           checkpoint restore of in-flight solver state → in-flight
           requests requeued for transparent re-execution.

Failures between detection windows surface as :class:`FabricError`
(a collective touching a dead rank); affected requests retry with
exponential backoff until ``max_attempts``, then fail with the error
recorded.  Matrix VALUES update through the structure-keyed
:class:`repro_torch.serve.plancache.PlanCache` — a value-only change
hot-swaps into the cached compiled program with no program build.

The service runs the device programs (``backend="torch"``) on CUDA
unless ``device="cpu"`` is passed; ``backend="simulate"`` runs the
float64 host simulators, the JAX package's default.

In a multi-process ``torch.distributed`` job every process runs the same
service: its plans compile the node block the process owns, every apply
returns the whole result in every process, so every decision (batches,
retries, recoveries, the log) is taken alike.  Checkpoints are written by
process 0 alone, which then tells the others how the save went; a
restore reads the directory in every process between two barriers.  A
recovery needs the survivors to split into whole-node blocks again
(:func:`repro_torch.mesh.buffers.mesh_for` raises ``DiscoveryError`` in
every process otherwise).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.core.integrity import IntegrityError, MessageFault
from repro_torch.core.partition import (RowPartition, contiguous_partition,
                                        survivor_partition)
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike
from repro_torch.mesh.buffers import (broadcast_from_first, is_first_process,
                                      job_barrier)
from repro_torch.runtime.fault import (ElasticPolicy, HeartbeatMonitor,
                                       StragglerDetector)
from repro_torch.serve.faultplan import FabricError, FaultPlan, ManualClock
from repro_torch.serve.plancache import PlanCache

REJECT_QUEUE_FULL = "queue_full"
REJECT_DEADLINE_UNMEETABLE = "deadline_unmeetable"
REJECT_UNKNOWN_MATRIX = "unknown_matrix"
REJECT_BAD_OPERAND = "bad_operand"
REJECT_FLEET_DEGRADED = "fleet_degraded"


@dataclasses.dataclass
class Request:
    """One admitted (or rejected) unit of work.  Mutated in place as it
    moves queued → running → done/expired/failed; the :class:`Ticket`
    handed back at submit time reads the same object."""

    id: int
    tenant: str
    matrix: str
    b: np.ndarray
    kind: str = "spmv"               # "spmv" (w = A v) | "solve" (CG)
    tol: float = 1e-10
    maxiter: int = 500
    deadline: float = float("inf")   # absolute service-clock time
    submitted_at: float = 0.0
    status: str = "queued"  # queued|running|done|expired|failed|rejected
    reason: Optional[str] = None     # reject/fail reason
    attempts: int = 0
    not_before: float = float("-inf")   # backoff gate
    x0: Optional[np.ndarray] = None     # restored warm start (recovery)
    result: Optional[np.ndarray] = None
    iters: int = 0
    completed_at: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Ticket:
    """Caller's handle on a request (live view — no polling protocol)."""

    request: Request

    @property
    def id(self) -> int:
        return self.request.id

    @property
    def status(self) -> str:
        return self.request.status

    @property
    def reason(self) -> Optional[str]:
        return self.request.reason

    def result(self) -> np.ndarray:
        if self.request.status != "done":
            raise ValueError(f"request {self.request.id} is "
                             f"{self.request.status} ({self.request.reason})")
        return self.request.result


def _colsum(M: np.ndarray) -> np.ndarray:
    """Per-column sums as independent contiguous 1-D reductions.  A
    blocked ``np.sum(M, axis=0)`` orders its accumulation by the array's
    width and strides, so the SAME column reduces differently in a k=1
    and a k=4 batch — which would break the batched-equals-solo
    bit-identity contract below.  Column-at-a-time sums don't."""
    return np.array([np.sum(np.ascontiguousarray(M[:, j]))
                     for j in range(M.shape[1])])


def batched_cg(mv: Callable, B: np.ndarray, tol: float = 1e-10,
               maxiter: int = 500, X0: Optional[np.ndarray] = None,
               callback: Optional[Callable[[int, np.ndarray], None]] = None):
    """Multi-RHS CG: one [n, k] iterate block, SHARED SpMVs.

    Each column runs an independent CG (every scalar is per-column and
    every reduction is column-at-a-time, see :func:`_colsum`), but the k
    systems pay ONE nv-tiled ``mv([n, k])`` per iteration — the batching
    win the service exists for.  Converged columns freeze (alpha=0), so
    under a columnwise ``mv`` a column's final iterate is bit-identical
    to the solo 1-RHS solve.  Returns ``(X, iters[k], relres[k])``.
    ``callback(it, X)`` fires per iteration — the checkpoint/fault seam.
    """
    B = np.asarray(B)
    X = np.zeros_like(B) if X0 is None else np.array(X0, dtype=B.dtype)
    R = B - mv(X)
    P = R.copy()
    rz = _colsum(R * R)
    b_norm = np.maximum(np.sqrt(_colsum(B * B)), 1e-30)
    rel = np.sqrt(_colsum(R * R)) / b_norm
    active = rel >= tol
    iters = np.zeros(B.shape[1], dtype=np.int64)
    for it in range(1, maxiter + 1):
        if not active.any():
            break
        AP = mv(P)
        pap = _colsum(P * AP)
        alpha = np.where(active, rz / np.maximum(np.abs(pap), 1e-300)
                         * np.sign(np.where(pap == 0, 1.0, pap)), 0.0)
        X = X + alpha * P
        R = R - alpha * AP
        if callback is not None:
            callback(it, X)
        rel = np.sqrt(_colsum(R * R)) / b_norm
        newly_done = active & (rel < tol)
        iters[newly_done] = it
        active = active & ~newly_done
        rz_new = _colsum(R * R)
        beta = np.where(active, rz_new / np.maximum(rz, 1e-300), 0.0)
        P = R + beta * P
        rz = rz_new
    iters[active] = maxiter
    return X, iters, rel


class SolverService:
    """See the module docstring for the lifecycle.  All configuration is
    constructor-time; ``step()`` advances the pump by one tick and
    ``run()`` pumps until the queue drains (bounded — never deadlocks)."""

    def __init__(self, topo: Topology, *, method: str = "nap",
                 backend: str = "torch", local_compute: str = "auto",
                 queue_limit: int = 32, batch_limit: int = 8,
                 clock=None, dt: float = 1.0,
                 heartbeat_timeout: float = 2.5,
                 straggler_z: float = 1.0, straggler_rel: float = 1.5,
                 straggler_window: int = 8,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 4,
                 fault_plan: Optional[FaultPlan] = None,
                 max_attempts: int = 4, backoff: float = 1.0,
                 plan_cache_max: int = 8, device: DeviceLike = None,
                 integrity: str = "off", quarantine_strikes: int = 3):
        self.clock = clock if clock is not None else ManualClock()
        self.dt = float(dt)
        self.topo = topo
        self.nodes: List[str] = [f"node{i}" for i in range(topo.n_nodes)]
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.monitor = HeartbeatMonitor(self.nodes, timeout=heartbeat_timeout,
                                        clock=self.clock)
        self._straggler_params = dict(window=straggler_window,
                                      z_thresh=straggler_z,
                                      rel_floor=straggler_rel)
        self.detector = StragglerDetector(**self._straggler_params)
        self.policy = ElasticPolicy()
        self.integrity = integrity
        self.quarantine_strikes = int(quarantine_strikes)
        self._pending_msg_faults: List[MessageFault] = []
        self._quarantine_pending: List[str] = []
        self.plans = PlanCache(topo, method=method, backend=backend,
                               local_compute=local_compute,
                               max_entries=plan_cache_max,
                               integrity=integrity, device=device)
        self.matrices: Dict[str, dict] = {}
        self.queue: "deque[Request]" = deque()
        self.requests: Dict[int, Request] = {}
        self._next_id = 0
        self.queue_limit = int(queue_limit)
        self.batch_limit = int(batch_limit)
        self.max_attempts = int(max_attempts)
        self.backoff = float(backoff)
        self.fault_plan = fault_plan if fault_plan is not None else FaultPlan()
        self.dead_now: set = set()          # scripted dead, not yet evicted
        self.slow_now: Dict[str, float] = {}
        self._midsolve_kill = None          # (node, at_iteration) armed
        self.degraded = False
        self.step_no = 0
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.checkpoint_every = int(checkpoint_every)
        self._save_seq = 0
        self._torn_next_save = False
        self.tenants: Dict[str, dict] = {}
        self.stats: Dict[str, float] = {
            "steps": 0, "completed": 0, "rejected": 0, "expired": 0,
            "failed": 0, "retries": 0, "recoveries": 0, "torn_saves": 0,
            "message_faults": 0, "integrity_detected": 0, "quarantines": 0,
            "last_recover_rebuild_s": 0.0}
        self.log: List[str] = []

    # -- registration ------------------------------------------------------
    def register_matrix(self, name: str, a,
                        row_part: Optional[RowPartition] = None,
                        col_part: Optional[RowPartition] = None) -> None:
        """Register (or re-register) a named matrix for tenants to solve
        against.  Partitions default to contiguous over the CURRENT
        fleet; elastic recovery repartitions them in place."""
        if row_part is None:
            row_part = contiguous_partition(a.shape[0], self.topo.n_procs)
        if col_part is None:
            col_part = (row_part if a.shape[1] == row_part.n_rows
                        else contiguous_partition(a.shape[1],
                                                  self.topo.n_procs))
        self.matrices[name] = {"a": a, "row_part": row_part,
                               "col_part": col_part, "version": 0}

    def update_values(self, name: str, a_new) -> None:
        """Value-only update of a registered matrix (same sparsity).  The
        plan cache hot-swaps the compiled program on next use — no
        recompile, no program build (asserted via ``plans.stats``)."""
        m = self.matrices[name]
        old = m["a"]
        if (tuple(a_new.shape) != tuple(old.shape)
                or not np.array_equal(a_new.indptr, old.indptr)
                or not np.array_equal(a_new.indices, old.indices)):
            raise ValueError(
                f"update_values({name!r}) changed the sparsity structure; "
                f"re-register the matrix instead")
        m["a"] = a_new
        m["version"] += 1

    # -- admission ---------------------------------------------------------
    def submit(self, tenant: str, matrix: str, b, *, kind: str = "spmv",
               tol: float = 1e-10, maxiter: int = 500,
               deadline: Optional[float] = None) -> Ticket:
        """Admit one request (or reject it with a reason — never block).

        ``deadline`` is an ABSOLUTE service-clock time; a request still
        queued past it is shed as ``expired``.  ``kind="spmv"`` returns
        ``A @ b``; ``kind="solve"`` returns CG's solution of ``A x = b``.
        """
        if kind not in ("spmv", "solve"):
            raise ValueError(f"kind must be spmv|solve, got {kind!r}")
        now = float(self.clock())
        self._next_id += 1
        req = Request(id=self._next_id, tenant=tenant, matrix=matrix,
                      b=np.asarray(b, dtype=np.float64), kind=kind, tol=tol,
                      maxiter=maxiter,
                      deadline=float("inf") if deadline is None
                      else float(deadline),
                      submitted_at=now)
        self.requests[req.id] = req
        acct = self._acct(tenant)
        acct["submitted"] += 1
        reason = None
        if self.degraded:
            reason = REJECT_FLEET_DEGRADED
        elif matrix not in self.matrices:
            reason = REJECT_UNKNOWN_MATRIX
        elif req.b.ndim != 1 or req.b.shape[0] != \
                self.matrices[matrix]["a"].shape[1 if kind == "spmv" else 0]:
            reason = REJECT_BAD_OPERAND
        elif req.deadline <= now:
            reason = REJECT_DEADLINE_UNMEETABLE
        elif len(self.queue) >= self.queue_limit:
            reason = REJECT_QUEUE_FULL
        if reason is not None:
            req.status, req.reason = "rejected", reason
            acct["rejected"] += 1
            self.stats["rejected"] += 1
            return Ticket(req)
        self.queue.append(req)
        return Ticket(req)

    # -- the pump ----------------------------------------------------------
    def step(self) -> Dict[str, object]:
        """One deterministic pump tick: clock → scripted faults →
        heartbeats → detection/recovery → deadline shedding → one batch
        execution.  Returns a small per-step report."""
        self.step_no += 1
        self.stats["steps"] += 1
        if hasattr(self.clock, "advance"):
            self.clock.advance(self.dt)
        now = float(self.clock())
        for ev in self.fault_plan.at(self.step_no):
            self._inject(ev)
        for n in self.nodes:
            if n in self.dead_now:
                continue             # dead nodes fall silent
            self.monitor.beat(n)
            self.detector.record(n, self.dt * self.slow_now.get(n, 1.0))
        evicted = sorted(set(self.monitor.dead_nodes())
                         | (set(self.detector.stragglers()) & set(self.nodes)))
        if evicted and not self.degraded:
            self._recover(evicted)
        self._shed_expired(now)
        executed = self._pump(now)
        if self._quarantine_pending and not self.degraded:
            cand = [n for n in self._quarantine_pending if n in self.nodes]
            self._quarantine_pending = []
            if cand:
                self.stats["quarantines"] += 1
                self.log.append(
                    f"step {self.step_no}: quarantining {cand} after "
                    f">={self.quarantine_strikes} integrity strikes")
                self._recover(cand)
                evicted = sorted(set(evicted) | set(cand))
        return {"step": self.step_no, "now": now, "executed": executed,
                "queued": len(self.queue), "evicted": evicted}

    def run(self, max_steps: int = 1000) -> int:
        """Pump until the queue drains or ``max_steps`` elapse (a hard
        bound — a wedged workload terminates with requests still queued
        rather than deadlocking).  Returns the number of steps taken."""
        for i in range(1, max_steps + 1):
            self.step()
            if not self.queue:
                return i
        return max_steps

    # -- internals ---------------------------------------------------------
    def _acct(self, tenant: str) -> dict:
        return self.tenants.setdefault(
            tenant, {"submitted": 0, "completed": 0, "rejected": 0,
                     "expired": 0, "failed": 0, "retries": 0,
                     "spmv_applies": 0, "cg_iters": 0, "plan": {}})

    def _inject(self, ev) -> None:
        if ev.kind == "dead_node":
            if ev.at_iteration is not None:
                self._midsolve_kill = (ev.node, int(ev.at_iteration))
                self.log.append(f"step {self.step_no}: armed mid-solve kill "
                                f"of {ev.node} at CG iteration "
                                f"{ev.at_iteration}")
            else:
                self.dead_now.add(ev.node)
                self.log.append(f"step {self.step_no}: {ev.node} died")
        elif ev.kind == "straggler":
            self.slow_now[ev.node] = ev.slowdown
            self.log.append(f"step {self.step_no}: {ev.node} straggling "
                            f"{ev.slowdown}x")
        elif ev.kind == "torn_checkpoint":
            self._torn_next_save = True
            self.log.append(f"step {self.step_no}: next checkpoint save "
                            f"will tear")
        elif ev.kind in ("corrupt_message", "drop_message",
                         "duplicate_message"):
            self.stats["message_faults"] += 1
            if self.integrity == "off":
                self.log.append(
                    f"step {self.step_no}: scripted {ev.kind} dropped — "
                    f"no integrity layer on this service (the corruption "
                    f"would have gone undetected)")
            else:
                self._pending_msg_faults.append(ev.fault)
                f = ev.fault
                self.log.append(
                    f"step {self.step_no}: scripted {ev.kind} armed "
                    f"(phase={f.phase} kind={f.kind} sender="
                    f"({f.node},{f.proc}) slot={f.slot})")

    def _shed_expired(self, now: float) -> None:
        keep = deque()
        for r in self.queue:
            if r.deadline <= now:
                r.status, r.reason = "expired", "deadline passed in queue"
                self._acct(r.tenant)["expired"] += 1
                self.stats["expired"] += 1
            else:
                keep.append(r)
        self.queue = keep

    def _pump(self, now: float) -> int:
        """Execute ONE earliest-deadline batch of ready requests."""
        ready = [r for r in self.queue if r.not_before <= now]
        if not ready:
            return 0
        ready.sort(key=lambda r: (r.deadline, r.id))
        head = ready[0]
        batch = [r for r in ready
                 if r.matrix == head.matrix and r.kind == head.kind
                 ][: self.batch_limit]
        for r in batch:
            self.queue.remove(r)
            r.status = "running"
        try:
            self._execute(batch, now)
        except (FabricError, IntegrityError) as e:
            if isinstance(e, IntegrityError):
                self.stats["integrity_detected"] += 1
            for r in batch:
                r.attempts += 1
                if r.attempts >= self.max_attempts:
                    r.status, r.reason = "failed", str(e)
                    self._acct(r.tenant)["failed"] += 1
                    self.stats["failed"] += 1
                else:
                    r.status = "queued"
                    r.not_before = now + self._backoff_delay(r.id, r.attempts)
                    self.queue.append(r)
                    self._acct(r.tenant)["retries"] += 1
                    self.stats["retries"] += 1
            kind = ("integrity" if isinstance(e, IntegrityError)
                    else "fabric")
            self.log.append(f"step {self.step_no}: batch of {len(batch)} "
                            f"hit {kind} error: {e}")
        return len(batch)

    def _backoff_delay(self, request_id: int, attempt: int) -> float:
        """Exponential backoff with DETERMINISTIC seeded jitter.  A bare
        ``backoff * 2**(attempt-1)`` synchronizes every request failed in
        the same step onto the same retry step — a thundering herd at
        exactly the moment the fleet is recovering.  The jitter spreads
        them over [1x, 1.25x] of the base delay, derived from
        (request id, attempt) so fault scenarios replay exactly."""
        base = self.backoff * 2 ** (attempt - 1)
        digest = hashlib.sha256(f"{request_id}:{attempt}".encode()).digest()
        jitter = int.from_bytes(digest[:8], "big") / 2.0 ** 64
        return base * (1.0 + 0.25 * jitter)

    def _execute(self, batch: List[Request], now: float) -> None:
        m = self.matrices[batch[0].matrix]
        op = self.plans.operator_for(m["a"], m["row_part"], m["col_part"])
        if self.dead_now:
            raise FabricError(f"collective timed out: "
                              f"{sorted(self.dead_now)} unreachable")
        if self._pending_msg_faults:
            for f in self._pending_msg_faults:
                # a fault scripted against coordinates the fleet no longer
                # has (sender evicted since it was armed) cannot fire
                if f.node >= self.topo.n_nodes or f.proc >= self.topo.ppn:
                    self.log.append(
                        f"step {self.step_no}: scripted fault on evicted "
                        f"sender ({f.node},{f.proc}) dropped")
                    continue
                op.queue_fault(f)
            self._pending_msg_faults = []
        V = np.stack([r.b for r in batch], axis=1)
        if batch[0].kind == "spmv":
            W = op @ V
            iters = np.zeros(len(batch), dtype=np.int64)
            rel = np.zeros(len(batch))
        else:
            X0 = None
            if any(r.x0 is not None for r in batch):
                X0 = np.stack(
                    [r.x0 if r.x0 is not None else np.zeros_like(r.b)
                     for r in batch], axis=1)
            cb = self._solve_callback(batch)
            W, iters, rel = batched_cg(
                op, V, tol=min(r.tol for r in batch),
                maxiter=max(r.maxiter for r in batch), X0=X0, callback=cb)
        for i, r in enumerate(batch):
            r.status = "done"
            r.result = np.ascontiguousarray(W[:, i])
            r.iters = int(iters[i])
            r.completed_at = float(self.clock())
            acct = self._acct(r.tenant)
            acct["completed"] += 1
            acct["spmv_applies"] += 1 if r.kind == "spmv" else int(iters[i]) + 1
            acct["cg_iters"] += int(iters[i])
            for k, v in op.stats().items():
                if dataclasses.is_dataclass(v):   # PhaseStats and friends
                    for f in dataclasses.fields(v):
                        x = getattr(v, f.name)
                        if isinstance(x, (int, float)):
                            kk = f"{k}.{f.name}"
                            acct["plan"][kk] = acct["plan"].get(kk, 0) + x
                elif isinstance(v, (int, float)):
                    acct["plan"][k] = acct["plan"].get(k, 0) + v
            self.stats["completed"] += 1
        if self.integrity == "recover":
            # k strikes against a node (attributed by the wire checksums)
            # propose it to the elastic path — a link that corrupts
            # repeatedly is treated like a failing node.
            strikes = op.integrity_report().get("strikes", {})
            cand = sorted(n for n, s in strikes.items()
                          if s >= self.quarantine_strikes and n in self.nodes)
            if cand:
                self._quarantine_pending = cand

    def _solve_callback(self, batch: List[Request]) -> Callable:
        ids = np.array([r.id for r in batch], dtype=np.int64)
        name = batch[0].matrix
        version = self.matrices[name]["version"]

        def cb(it: int, X: np.ndarray) -> None:
            if self.ckpt is not None and it % self.checkpoint_every == 0:
                self._save_solver_state(name, version, ids, it, X)
            if self._midsolve_kill is not None:
                node, at_it = self._midsolve_kill
                if it >= at_it:
                    self._midsolve_kill = None
                    self.dead_now.add(node)
                    self.log.append(f"step {self.step_no}: {node} died "
                                    f"mid-solve at CG iteration {it}")
                    raise FabricError(f"{node} died mid-solve "
                                      f"(iteration {it})")
        return cb

    def _save_solver_state(self, name: str, version: int, ids: np.ndarray,
                           it: int, X: np.ndarray) -> None:
        self._save_seq += 1
        hook = None
        if self._torn_next_save:
            self._torn_next_save = False

            def hook():
                raise OSError("scripted torn checkpoint: writer killed "
                              "before _COMMITTED")
        failed = None
        if is_first_process():      # two writers would race on one step
            try:
                self.ckpt.save(self._save_seq, {"x": np.asarray(X), "ids": ids},
                               extra={"matrix": name, "version": version,
                                      "iteration": it},
                               block=True, on_before_commit=hook)
            except RuntimeError as e:
                failed = str(e.__cause__)
        # every process learns process 0's outcome once its save is done
        failed = broadcast_from_first(failed, self.plans.mesh)
        if failed is not None:
            self.stats["torn_saves"] += 1
            self.log.append(f"step {self.step_no}: checkpoint save "
                            f"{self._save_seq} failed ({failed}); "
                            f"previous committed step stands")

    def _recover(self, evicted: List[str]) -> None:
        """The elastic path: survivor topology → repartition → plan
        rebuild → checkpoint restore → requeue in-flight requests."""
        t0 = time.perf_counter()
        new_topo = self.policy.survivor_topology(
            self.topo, [self.nodes.index(n) for n in evicted])
        if new_topo is None:
            self.degraded = True
            while self.queue:
                r = self.queue.popleft()
                r.status, r.reason = "failed", REJECT_FLEET_DEGRADED
                self._acct(r.tenant)["failed"] += 1
                self.stats["failed"] += 1
            self.log.append(f"step {self.step_no}: fleet fully degraded "
                            f"({evicted} evicted, nobody left)")
            return
        # first, so a survivor layout without a whole-node block per
        # process raises before anything changes
        dropped = self.plans.rebuild(new_topo)
        dead_ranks = sorted(
            r for n in evicted
            for r in self.topo.ranks_on_node(self.nodes.index(n)))
        for m in self.matrices.values():
            same = m["col_part"] is m["row_part"]
            m["row_part"] = survivor_partition(m["row_part"], dead_ranks)
            m["col_part"] = (m["row_part"] if same else
                             survivor_partition(m["col_part"], dead_ranks))
        survivors = [n for n in self.nodes if n not in set(evicted)]
        self.nodes = survivors
        self.topo = new_topo
        self.dead_now -= set(evicted)
        for n in evicted:
            self.slow_now.pop(n, None)
        self.monitor = HeartbeatMonitor(self.nodes,
                                        timeout=self.heartbeat_timeout,
                                        clock=self.clock)
        self.detector = StragglerDetector(**self._straggler_params)
        # eager recompile so the rebuild cost lands here, not on the next
        # tenant request (and so last_recover_rebuild_s measures it)
        for m in self.matrices.values():
            op = self.plans.operator_for(m["a"], m["row_part"], m["col_part"])
            if self.plans.backend == "torch":
                _ = op.executor.compiled    # the device plan compiles here
        self._restore_solver_state()
        now = float(self.clock())
        for r in self.queue:      # in-flight retries re-execute immediately
            if r.attempts > 0:
                r.not_before = now
        self.stats["recoveries"] += 1
        self.stats["last_recover_rebuild_s"] = time.perf_counter() - t0
        self.log.append(
            f"step {self.step_no}: evicted {evicted}, rebuilt {dropped} "
            f"plans on {new_topo.n_nodes}x{new_topo.ppn}, "
            f"{len(self.matrices)} matrices repartitioned")

    def _restore_solver_state(self) -> None:
        if self.ckpt is None:
            return
        # every process reads what process 0 committed, and none writes
        # (or collects old steps) until all have read
        job_barrier(self.plans.mesh)
        try:
            tree, extra = self.ckpt.restore()
        except FileNotFoundError:
            return                      # nothing committed yet
        finally:
            job_barrier(self.plans.mesh)
        name, version = extra.get("matrix"), extra.get("version")
        m = self.matrices.get(name)
        if m is None or m["version"] != version:
            return                      # stale values: cold-start instead
        by_id = {int(i): k for k, i in enumerate(np.asarray(tree["ids"]))}
        X = np.asarray(tree["x"])
        restored = 0
        for r in self.queue:
            col = by_id.get(r.id)
            if col is not None and r.kind == "solve" and r.matrix == name:
                r.x0 = np.ascontiguousarray(X[:, col])
                restored += 1
        if restored:
            self.log.append(
                f"step {self.step_no}: restored checkpointed iterates "
                f"(iteration {extra.get('iteration')}) for {restored} "
                f"in-flight solves")

    # -- introspection -----------------------------------------------------
    def report(self) -> Dict[str, object]:
        """Service-level stats + per-tenant accounting + plan-cache
        counters, one dict (the ops surface)."""
        return {"stats": dict(self.stats),
                "plan_cache": dict(self.plans.stats),
                "tenants": {t: dict(v) for t, v in self.tenants.items()},
                "fleet": {"nodes": list(self.nodes),
                          "topo": (self.topo.n_nodes, self.topo.ppn),
                          "degraded": self.degraded},
                "queue_depth": len(self.queue)}
