"""Wire checksums, ABFT and scripted faults: the host side of the
integrity layer of the distributed SpMV.

Each plan family moves its messages in named phases, in program order:
the node-aware exchange ``full``, ``init``, ``inter``, ``final``; the
standard exchange one flat ``pair``; the multi-step exchange the four
node-aware phases plus ``direct``, the flat owner -> requester hop of
its low-duplication columns.  Two checks cover them:

* **Wire checksums.**  A position-weighted Fletcher fold over the raw
  32-bit words of every message payload, taken by the SENDER before the
  fault boundary and again by the RECEIVER after delivery (the checksum
  words travel through the same exchange, one per message).  A bitflip,
  a zeroed or dropped payload, a stale (shifted) buffer or a duplicated
  message mismatches, attributed to (phase, message slot, receiving
  rank).  Checksums verify that what arrived is what was sent; they do
  not see compute faults.
* **ABFT.**  Each rank carries the column sums ``c_p = 1^T A_p`` over its
  packed x domain (and the row sums ``A_p 1`` for the transpose), so
  ``sum(y_p)`` is checked against ``c_p . x_packed`` within a
  dtype-aware tolerance, over the same received buffers the local
  compute read.  ABFT sees corruption inside the local compute.

Phase attribution follows the paper's data classes: ``full`` carries
on_node data, ``init`` / ``inter`` / ``final`` relay off_node data, and
a compute (ABFT) failure is on_proc; ``pair`` and ``direct`` attribute
per message from the sender and receiver ranks.

Faults are deterministic and replayable: a scripted :class:`MessageFault`
is encoded by :func:`build_fault_spec` into a small int32 array that the
instrumented device program takes as data (arming a fault never changes
the program), applied at the pack boundary and consumed once.
``integrity="recover"`` retries the apply from the retained packed
operand with the fault consumed, which reproduces the fault-free result
bit for bit.

Limits: a ``zero`` / ``drop`` fault on an all-zero payload and a
``stale`` roll of a constant payload are undetectable (the corrupted
payload is bit-identical to the clean one); a low mantissa bit flipped
in the compute hides below the ABFT tolerance.  ``bitflip`` wire faults
are always detected.  A dropped message is modelled as a zeroed payload.

This module is numpy only.  :class:`SimWire` threads the checksums and
faults through the float64 message simulators of
:mod:`repro_torch.core.spmv`; the device twins of the checksum and the
fault transform live in :mod:`repro_torch.core.spmv_torch`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FAULT_KINDS", "KIND_CODE", "MessageFault", "Mismatch", "IntegrityError",
    "checksum_np", "corrupt_payload_np", "message_phases", "phase_index",
    "build_fault_spec", "scope_for", "verify_wire", "verify_abft",
    "IntegrityState", "SimWire", "MULTISTEP_MESSAGE_PHASES",
]

_MASK32 = 0xFFFFFFFF

#: Scripted message-fault kinds (plus the compute-side "bitflip" applied
#: through the ``"compute"`` pseudo-phase).  Codes are the spec-array
#: encoding; 0 means "no fault".
FAULT_KINDS = ("bitflip", "zero", "stale", "drop", "duplicate")
KIND_CODE: Dict[str, int] = {k: i + 1 for i, k in enumerate(FAULT_KINDS)}

#: Exchange phases that carry messages, per plan family, in the canonical
#: order the instrumented programs stack their checksum rows.
NAP_MESSAGE_PHASES: Tuple[str, ...] = ("full", "init", "inter", "final")
STD_MESSAGE_PHASES: Tuple[str, ...] = ("pair",)
#: Multi-step NAP = the four NAP phases plus the "direct" exchange that
#: carries the low-duplication columns owner -> requester in one hop.
MULTISTEP_MESSAGE_PHASES: Tuple[str, ...] = NAP_MESSAGE_PHASES + ("direct",)
COMPUTE_PHASE = "compute"


def message_phases(method: str) -> Tuple[str, ...]:
    if method == "nap":
        return NAP_MESSAGE_PHASES
    if method == "multistep":
        return MULTISTEP_MESSAGE_PHASES
    return STD_MESSAGE_PHASES


def phase_index(method: str) -> Dict[str, int]:
    """Phase name -> row index in the fault-spec array (compute last)."""
    phases = message_phases(method) + (COMPUTE_PHASE,)
    return {p: i for i, p in enumerate(phases)}


# ---------------------------------------------------------------------------
# Checksums (host twin of the device fold)
# ---------------------------------------------------------------------------

def checksum_np(x: np.ndarray) -> int:
    """Position-weighted Fletcher-style fold over the raw bit pattern.

    ``s1`` is the wrapping u32 sum of the 32-bit words, ``s2`` the
    wrapping sum weighted by 1-based word position; the digest is
    ``s1 ^ rotl32(s2, 7)``.  The position weighting is what catches a
    ``stale`` (shifted) payload — a pure XOR fold is order-invariant and
    would pass any permutation of the same words.  Matches the device
    fold in :mod:`repro_torch.core.spmv_torch` bit-for-bit.
    """
    b = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
    pad = (-b.size) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    w = b.view("<u4").astype(np.uint64)
    idx = np.arange(1, w.size + 1, dtype=np.uint64)
    s1 = int(w.sum()) & _MASK32
    s2 = int((w * (idx & _MASK32)).sum()) & _MASK32
    rot = ((s2 << 7) & _MASK32) | (s2 >> 25)
    return (s1 ^ rot) & _MASK32


def corrupt_payload_np(values: np.ndarray, kind: str, element: int = 0,
                       bit: int = 30,
                       other: Optional[np.ndarray] = None) -> np.ndarray:
    """Numpy fault transform of the simulate backend's wire.

    ``other`` is the candidate payload for ``duplicate`` (another message
    from the same sender); ``duplicate`` degrades to zeros when the
    sender has no other message to confuse with.
    """
    v = np.array(values, copy=True)
    if kind in ("zero", "drop"):
        return np.zeros_like(v)
    if kind == "stale":
        return np.roll(v, 1)
    if kind == "duplicate":
        if other is None:
            return np.zeros_like(v)
        out = np.zeros_like(v).reshape(-1)
        src = np.asarray(other).reshape(-1)
        n = min(out.size, src.size)
        out[:n] = src[:n]
        return out.reshape(v.shape)
    if kind == "bitflip":
        flat = v.reshape(-1)
        e = int(element) % max(flat.size, 1)
        if flat.dtype == np.float64:
            word = flat[e: e + 1].view(np.uint64)
            word ^= np.uint64(1) << np.uint64(int(bit) % 64)
        else:
            word = flat[e: e + 1].view(np.uint32)
            word ^= np.uint32(1) << np.uint32(int(bit) % 32)
        return v
    raise ValueError(f"unknown fault kind {kind!r}")


# ---------------------------------------------------------------------------
# Scripted faults
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MessageFault:
    """One deterministic fault at the pack boundary of one exchange phase.

    ``(node, proc)`` are the SENDER device coordinates; ``slot`` the
    destination message slot within the phase — the destination's local
    rank for the intra-node phases (``full``/``init``/``final``), the
    destination NODE for ``inter``, the destination flat rank for the
    standard ``pair`` phase, and ignored for ``compute`` (which perturbs
    the sender's own local result; only ``kind="bitflip"`` is
    meaningful there, targeting ``element``/``bit`` of the flattened
    output — the corruption ABFT exists to catch).
    """

    phase: str
    kind: str = "bitflip"
    node: int = 0
    proc: int = 0
    slot: int = 0
    element: int = 0
    bit: int = 30
    direction: str = "forward"   # "forward" | "transpose" | "any"

    def __post_init__(self) -> None:
        known = MULTISTEP_MESSAGE_PHASES + STD_MESSAGE_PHASES \
            + (COMPUTE_PHASE,)
        if self.phase not in known:
            raise ValueError(f"unknown phase {self.phase!r}; one of {known}")
        if self.phase != COMPUTE_PHASE and self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.phase == COMPUTE_PHASE and self.kind != "bitflip":
            raise ValueError("compute faults model a corrupted local "
                             "result: kind must be 'bitflip'")
        if self.direction not in ("forward", "transpose", "any"):
            raise ValueError(f"direction must be forward|transpose|any, "
                             f"got {self.direction!r}")


N_SPEC_FIELDS = 4   # (kind_code, slot, element, bit)


def build_fault_spec(topo, faults: Sequence[MessageFault],
                     method: str) -> np.ndarray:
    """Encode scripted faults into the [n_nodes, ppn, n_phases, 4] int32
    spec array the instrumented device program takes as data (constant
    shape and dtype: arming or clearing faults never changes the program).
    At most one fault per (sender device, phase) per apply."""
    idx = phase_index(method)
    spec = np.zeros((topo.n_nodes, topo.ppn, len(idx), N_SPEC_FIELDS),
                    dtype=np.int32)
    for f in faults:
        if f.phase not in idx:
            raise ValueError(
                f"phase {f.phase!r} does not exist on method {method!r}")
        if not (0 <= f.node < topo.n_nodes and 0 <= f.proc < topo.ppn):
            raise ValueError(f"sender ({f.node}, {f.proc}) outside the "
                             f"({topo.n_nodes}, {topo.ppn}) topology")
        row = spec[f.node, f.proc, idx[f.phase]]
        if row[0] != 0:
            raise ValueError(
                f"two faults scripted for device ({f.node}, {f.proc}) "
                f"phase {f.phase!r} in one apply; queue them on separate "
                f"applies")
        code = KIND_CODE["bitflip"] if f.phase == COMPUTE_PHASE \
            else KIND_CODE[f.kind]
        row[:] = (code, f.slot, f.element, f.bit)
    return spec


# ---------------------------------------------------------------------------
# Verification (host side, over the instrumented program's aux outputs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mismatch:
    """One detected integrity failure, attributed."""

    check: str          # "wire" | "abft"
    phase: str          # exchange phase ("compute" for ABFT)
    scope: str          # "on_proc" | "on_node" | "off_node"
    node: int           # receiving / computing device coordinates
    proc: int
    slot: int           # message index within the phase (column for abft)
    direction: str = "forward"

    def __str__(self) -> str:
        return (f"{self.check} mismatch: phase={self.phase} ({self.scope}) "
                f"device=({self.node},{self.proc}) slot={self.slot} "
                f"direction={self.direction}")


class IntegrityError(RuntimeError):
    """A checksum / ABFT / stored-digest verification failed.

    ``mismatches`` carries the attributed failures (empty for
    checkpoint-digest errors, which name the corrupt shard in the
    message instead)."""

    def __init__(self, message: str,
                 mismatches: Sequence[Mismatch] = ()) -> None:
        super().__init__(message)
        self.mismatches: List[Mismatch] = list(mismatches)


#: Data-class attribution of the NAP phases (Eqs. 4-7 column classes):
#: the full-local phase moves on_node data; init/inter/final relay
#: off_node data; compute/ABFT failures are the rank's own (on_proc).
_NAP_PHASE_SCOPE = {"full": "on_node", "init": "off_node",
                    "inter": "off_node", "final": "off_node"}


def scope_for(phase: str, node: int, proc: int, slot: int, ppn: int) -> str:
    if phase == COMPUTE_PHASE:
        return "on_proc"
    if phase in _NAP_PHASE_SCOPE:
        return _NAP_PHASE_SCOPE[phase]
    # standard "pair": the slot is the sender's flat rank.
    me = node * ppn + proc
    if slot == me:
        return "on_proc"
    return "on_node" if slot // ppn == node else "off_node"


def verify_wire(chk: np.ndarray, phases: Sequence[str], ppn: int,
                direction: str) -> List[Mismatch]:
    """Compare sender-vs-receiver checksums.

    ``chk`` is the instrumented program's aux output
    ``[n_nodes, ppn, n_msg_phases, 2, max_slots]`` uint32 — row 0 the
    sender checksums as delivered through the collective, row 1 the
    receiver's recomputation.  Padded slots are zero on both rows.
    """
    chk = np.asarray(chk)
    bad = np.argwhere(chk[..., 0, :] != chk[..., 1, :])
    out = []
    for ni, pj, ph, slot in bad:
        phase = phases[int(ph)]
        out.append(Mismatch(check="wire", phase=phase,
                            scope=scope_for(phase, int(ni), int(pj),
                                            int(slot), ppn),
                            node=int(ni), proc=int(pj), slot=int(slot),
                            direction=direction))
    return out


def abft_tolerance(scale: np.ndarray, y: np.ndarray, d: np.ndarray,
                   n_terms: int) -> np.ndarray:
    """Dtype-aware ABFT tolerance: f32 rounding of two independently
    ordered ~n_terms-term sums, scaled by the |A||x| mass."""
    eps = float(np.finfo(np.float32).eps)
    return (64.0 * eps * np.sqrt(max(float(n_terms), 2.0))
            * (np.abs(scale) + np.abs(y) + np.abs(d)) + 1e-30)


def verify_abft(abft: np.ndarray, n_terms: int,
                direction: str) -> List[Mismatch]:
    """Check ``sum(y_p)`` against ``c_p · x_packed`` per device and RHS.

    ``abft`` is the aux output ``[n_nodes, ppn, 3, nv]`` float32:
    (result sum, checksum dot, |A||x| tolerance scale).
    """
    abft = np.asarray(abft, dtype=np.float64)
    y, d, scale = abft[..., 0, :], abft[..., 1, :], abft[..., 2, :]
    tol = abft_tolerance(scale, y, d, n_terms)
    bad = np.argwhere(~(np.abs(y - d) <= tol))   # NaN-safe: NaN fails
    out = []
    for ni, pj, col in bad:
        out.append(Mismatch(check="abft", phase=COMPUTE_PHASE,
                            scope="on_proc", node=int(ni), proc=int(pj),
                            slot=int(col), direction=direction))
    return out


# ---------------------------------------------------------------------------
# Per-executor integrity state (mode, fault queue, counters, strikes)
# ---------------------------------------------------------------------------

class IntegrityState:
    """Mutable integrity bookkeeping an executor carries per operator.

    Holds the scripted-fault queue (consumed one apply at a time — a
    fault fires ONCE), the currently armed spec array the instrumented
    program reads, check/mismatch counters with scope
    attribution, and per-node strike counts feeding the quarantine
    policy (``k`` strikes against a sender node propose it to the
    elastic path).
    """

    def __init__(self, mode: str, topo, method: str,
                 strikes_to_quarantine: int = 3) -> None:
        if mode not in ("detect", "recover"):
            raise ValueError(f"integrity mode must be detect|recover, "
                             f"got {mode!r}")
        self.mode = mode
        self.topo = topo
        self.method = method
        self.phases = message_phases(method)
        self.k = int(strikes_to_quarantine)
        self.pending: List[MessageFault] = []
        self.counters: Dict[str, int] = {
            "applies": 0, "wire_checks": 0, "abft_checks": 0,
            "wire_mismatches": 0, "abft_mismatches": 0,
            "faults_injected": 0, "retries": 0, "recovered": 0,
        }
        self.by_scope: Dict[str, int] = {"on_proc": 0, "on_node": 0,
                                         "off_node": 0}
        self.strikes: Dict[str, int] = {}
        self.last_mismatches: List[Mismatch] = []
        self._zero_spec = build_fault_spec(topo, (), method)
        self._current_spec = self._zero_spec

    # -- fault queue -------------------------------------------------------
    def queue_fault(self, fault: MessageFault) -> None:
        self.pending.append(fault)

    def take_pending(self, direction: str) -> List[MessageFault]:
        """Remove and return every queued fault matching ``direction``
        (scripted faults fire once)."""
        take = [f for f in self.pending
                if f.direction in ("any", direction)]
        self.pending = [f for f in self.pending
                        if f.direction not in ("any", direction)]
        return take

    def arm(self, direction: str) -> List[MessageFault]:
        """Consume every queued fault matching ``direction`` into the
        armed spec (the recover retry and all later applies run clean
        unless re-queued)."""
        take = self.take_pending(direction)
        if take:
            self._current_spec = build_fault_spec(self.topo, take,
                                                  self.method)
            self.counters["faults_injected"] += len(take)
        else:
            self._current_spec = self._zero_spec
        return take

    def disarm(self) -> None:
        self._current_spec = self._zero_spec

    def fetch_spec(self) -> np.ndarray:
        """The armed spec array, the instrumented program's per-call input."""
        return self._current_spec

    # -- verification ------------------------------------------------------
    def verify(self, chk: np.ndarray, abft: np.ndarray, direction: str,
               n_terms: int) -> List[Mismatch]:
        chk = np.asarray(chk)
        mism = verify_wire(chk, self.phases, self.topo.ppn, direction)
        mism += verify_abft(abft, n_terms, direction)
        self.counters["wire_checks"] += int(np.prod(chk.shape[:-2])
                                            * chk.shape[-1])
        self.counters["abft_checks"] += 1
        self.record(mism)
        return mism

    def record(self, mismatches: Sequence[Mismatch]) -> None:
        self.last_mismatches = list(mismatches)
        for m in mismatches:
            self.counters[f"{m.check}_mismatches"] += 1
            self.by_scope[m.scope] = self.by_scope.get(m.scope, 0) + 1
            self.strikes[self._strike_node(m)] = \
                self.strikes.get(self._strike_node(m), 0) + 1

    def _strike_node(self, m: Mismatch) -> str:
        """Name of the node a mismatch implicates (the SENDER side for
        wire faults — the inter phase's slot is the sending node; the
        intra-node phases stay on the receiver's node)."""
        if m.check == "wire" and m.phase == "inter":
            return f"node{m.slot}"
        if m.check == "wire" and m.phase in ("pair", "direct"):
            return f"node{m.slot // self.topo.ppn}"
        return f"node{m.node}"

    def quarantine_candidates(self) -> List[str]:
        """Nodes with >= k strikes — hand these to the elastic path
        (``survivor_partition`` -> ``PlanCache.rebuild``)."""
        return sorted(n for n, s in self.strikes.items() if s >= self.k)

    # -- simulate-backend bridge -------------------------------------------
    def note_sim(self, wire: "SimWire") -> List[Mismatch]:
        self.counters["wire_checks"] += wire.checks
        self.counters["faults_injected"] += wire.injected
        self.record(wire.mismatches)
        return wire.mismatches

    def report(self) -> Dict[str, object]:
        return dict(self.counters, mode=self.mode, by_scope=dict(self.by_scope),
                    strikes=dict(self.strikes),
                    quarantine=self.quarantine_candidates(),
                    pending_faults=len(self.pending),
                    last_mismatches=[str(m) for m in self.last_mismatches])


# ---------------------------------------------------------------------------
# Simulate-backend wire (checksums + faults over the numpy mailboxes)
# ---------------------------------------------------------------------------

class SimWire:
    """Checksum/fault layer threaded through the numpy message simulators.

    :class:`repro_torch.core.spmv._MailBox` calls ``send`` at post time (the
    sender checksums the CLEAN payload, then the scripted fault — if one
    targets this message — corrupts it) and ``recv`` at fetch time (the
    receiver recomputes and compares).  Mirrors the device wire layer
    exactly, for the forward simulators; the float64 payloads are
    checksummed at full width.
    """

    def __init__(self, topo, faults: Sequence[MessageFault] = ()) -> None:
        self.topo = topo
        self.faults = list(faults)
        self.sent: Dict[Tuple[str, int, int], int] = {}
        self.last_payload: Dict[Tuple[str, int], np.ndarray] = {}
        self.checks = 0
        self.injected = 0
        self.mismatches: List[Mismatch] = []

    def _match(self, phase: str, src: int, dst: int) -> Optional[MessageFault]:
        for i, f in enumerate(self.faults):
            if f.phase != phase:
                continue
            if f.node * self.topo.ppn + f.proc != src:
                continue
            if phase == "inter":
                ok = self.topo.node_of(dst) == f.slot
            elif phase in ("pair", "direct"):
                ok = dst == f.slot
            else:
                ok = self.topo.local_of(dst) == f.slot
            if ok:
                return self.faults.pop(i)
        return None

    def send(self, phase: str, msg, values: np.ndarray) -> np.ndarray:
        self.sent[(phase, msg.src, msg.dst)] = checksum_np(values)
        fault = self._match(phase, msg.src, msg.dst)
        prev = self.last_payload.get((phase, msg.src))
        self.last_payload[(phase, msg.src)] = np.array(values, copy=True)
        if fault is None:
            return values
        self.injected += 1
        return corrupt_payload_np(values, fault.kind, fault.element,
                                  fault.bit, other=prev)

    def recv(self, phase: str, msg, values: np.ndarray) -> None:
        self.checks += 1
        if checksum_np(values) == self.sent[(phase, msg.src, msg.dst)]:
            return
        ppn = self.topo.ppn
        slot = (self.topo.node_of(msg.src) if phase == "inter"
                else msg.src if phase in ("pair", "direct")
                else self.topo.local_of(msg.src))
        self.mismatches.append(Mismatch(
            check="wire", phase=phase,
            scope=scope_for(phase, self.topo.node_of(msg.dst),
                            self.topo.local_of(msg.dst), slot, ppn),
            node=self.topo.node_of(msg.dst), proc=self.topo.local_of(msg.dst),
            slot=slot, direction="forward"))
