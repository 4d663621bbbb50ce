"""Deterministic fault injection for the solver service.

A :class:`FaultPlan` is a script of :class:`FaultEvent`s keyed on the
service's step counter — the service pump consults it at every step
boundary, so a given (plan, workload) pair replays IDENTICALLY run after
run.  Faults act through the clock-injectable production scaffolding, not
through test monkey-patching:

* ``dead_node(step, node)`` — the node stops heartbeating at ``step``;
  :class:`repro_torch.runtime.fault.HeartbeatMonitor` times it out and the
  service's elastic recovery evicts it.  ``at_iteration=k`` delays the
  death until an in-flight solve reaches CG iteration k (the scripted
  *mid-solve* loss).  While a dead node is in the fleet, every collective
  raises :class:`FabricError` — exactly how a real all-to-all fails.
* ``straggler(step, node, slowdown)`` — the node starts reporting
  ``slowdown``× step times; :class:`repro_torch.runtime.fault.
  StragglerDetector` flags it and the service evicts it through the same
  recovery path as a death.
* ``torn_checkpoint(step)`` — the NEXT checkpoint save dies between the
  shard files and the ``_COMMITTED`` marker (via ``save_checkpoint``'s
  ``on_before_commit`` hook); restore must fall back to the previous
  committed step.
* ``corrupt_message(step, edge)`` / ``drop_message`` /
  ``duplicate_message`` — DATA-plane faults: the scripted
  :class:`repro_torch.core.integrity.MessageFault` is queued onto the serving
  operator at ``step`` and fires inside the next SpMV apply as a pure
  transform at the pack boundary (bitflip / zeroed / stale / dropped /
  duplicated payload on one exchange message).  What happens next is the
  operator's ``integrity`` mode: ``"detect"`` raises with phase+message
  attribution, ``"recover"`` retries clean and counts a strike against
  the implicated node.

``FaultPlan.random(seed, ...)`` draws a scripted plan from a seeded
generator: same seed, same plan, same eviction step — the determinism
the crash-consistency tests assert.  Pass ``ppn=`` to include the
message-fault kinds (they need sender device coordinates).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.integrity import MessageFault, NAP_MESSAGE_PHASES


class FabricError(RuntimeError):
    """A collective failed because a fleet member is unreachable."""


class ManualClock:
    """Deterministic injectable clock: ``clock()`` reads, ``advance``
    moves time forward.  Drop-in for ``time.monotonic`` everywhere the
    runtime scaffolding accepts a ``clock`` callable."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.t += float(dt)
        return self.t


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault, triggered when the service pump reaches
    ``step``.  ``node`` names the victim for dead_node/straggler;
    ``at_iteration`` (dead_node only) defers the death until an in-flight
    solve reaches that CG iteration; ``fault`` carries the scripted
    :class:`MessageFault` for the message kinds."""

    step: int
    kind: str                      # dead_node | straggler | torn_checkpoint
    node: Optional[str] = None     # | corrupt/drop/duplicate_message
    slowdown: float = 1.0
    at_iteration: Optional[int] = None
    fault: Optional[MessageFault] = None

    KINDS = ("dead_node", "straggler", "torn_checkpoint",
             "corrupt_message", "drop_message", "duplicate_message")
    MESSAGE_KINDS = ("corrupt_message", "drop_message", "duplicate_message")

    def __post_init__(self) -> None:
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {self.KINDS}")
        if self.kind in self.MESSAGE_KINDS:
            if self.fault is None:
                raise ValueError(f"{self.kind} needs a MessageFault payload")
        elif self.kind != "torn_checkpoint" and self.node is None:
            raise ValueError(f"{self.kind} needs a target node")


def dead_node(step: int, node: str,
              at_iteration: Optional[int] = None) -> FaultEvent:
    """Node death at ``step`` (optionally mid-solve at CG iteration k)."""
    return FaultEvent(step=step, kind="dead_node", node=node,
                      at_iteration=at_iteration)


def straggler(step: int, node: str, slowdown: float = 4.0) -> FaultEvent:
    """Node starts running ``slowdown``× slow at ``step``."""
    return FaultEvent(step=step, kind="straggler", node=node,
                      slowdown=float(slowdown))


def torn_checkpoint(step: int) -> FaultEvent:
    """The next checkpoint save after ``step`` tears before commit."""
    return FaultEvent(step=step, kind="torn_checkpoint")


Edge = Tuple[str, Union[int, Tuple[int, int]], int]


def _edge_fault(edge: Edge, kind: str, element: int, bit: int,
                direction: str) -> MessageFault:
    """``edge = (phase, sender, slot)`` — sender as (node, proc) device
    coordinates or a flat rank."""
    phase, sender, slot = edge
    if not isinstance(sender, tuple):
        raise ValueError("pass the sender as (node, proc) device "
                         "coordinates; a flat rank needs the topology's "
                         "ppn to split")
    node, proc = sender
    return MessageFault(phase=phase, kind=kind, node=int(node),
                        proc=int(proc), slot=int(slot), element=int(element),
                        bit=int(bit), direction=direction)


def corrupt_message(step: int, edge: Edge, kind: str = "bitflip",
                    element: int = 0, bit: int = 30,
                    direction: str = "forward") -> FaultEvent:
    """Corrupt ONE exchange message at ``step``: ``kind`` is
    ``"bitflip"`` | ``"zero"`` | ``"stale"``; ``edge`` is
    ``(phase, (node, proc), slot)`` — the sending device and destination
    message slot within the phase."""
    if kind not in ("bitflip", "zero", "stale"):
        raise ValueError(f"corrupt_message kind must be bitflip|zero|stale, "
                         f"got {kind!r} (use drop_message / "
                         f"duplicate_message for the other kinds)")
    return FaultEvent(step=step, kind="corrupt_message",
                      fault=_edge_fault(edge, kind, element, bit, direction))


def drop_message(step: int, edge: Edge,
                 direction: str = "forward") -> FaultEvent:
    """Drop ONE exchange message at ``step`` (the receiver sees a zeroed
    payload — the static-SPMD model of a lost send)."""
    return FaultEvent(step=step, kind="drop_message",
                      fault=_edge_fault(edge, "drop", 0, 0, direction))


def duplicate_message(step: int, edge: Edge,
                      direction: str = "forward") -> FaultEvent:
    """Deliver a DIFFERENT message from the same sender in place of this
    one (payload duplication / misrouting)."""
    return FaultEvent(step=step, kind="duplicate_message",
                      fault=_edge_fault(edge, "duplicate", 0, 0, direction))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable script of fault events, consulted per service step."""

    events: Tuple[FaultEvent, ...] = ()

    def at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    def __len__(self) -> int:
        return len(self.events)

    @staticmethod
    def of(*events: FaultEvent) -> "FaultPlan":
        return FaultPlan(events=tuple(sorted(events, key=lambda e: e.step)))

    @staticmethod
    def random(seed: int, nodes: Sequence[str], n_steps: int,
               n_events: int = 1, ppn: Optional[int] = None) -> "FaultPlan":
        """Seeded random plan over ``nodes`` within ``n_steps``.  Pure
        function of its arguments: same seed → same events, same steps,
        same corrupted edges — the determinism contract the tests pin
        down.  With ``ppn`` set the draw includes the message-fault
        kinds (sender device coordinates need the node width)."""
        rng = np.random.default_rng(seed)
        kinds = FaultEvent.KINDS if ppn else \
            tuple(k for k in FaultEvent.KINDS
                  if k not in FaultEvent.MESSAGE_KINDS)
        events = []
        for _ in range(n_events):
            kind = str(rng.choice(kinds))
            step = int(rng.integers(1, max(2, n_steps)))
            if kind == "torn_checkpoint":
                events.append(torn_checkpoint(step))
            elif kind == "straggler":
                events.append(straggler(step, str(rng.choice(list(nodes))),
                                        slowdown=float(rng.integers(3, 8))))
            elif kind in FaultEvent.MESSAGE_KINDS:
                edge = (str(rng.choice(NAP_MESSAGE_PHASES)),
                        (int(rng.integers(0, len(nodes))),
                         int(rng.integers(0, ppn))),
                        int(rng.integers(0, max(len(nodes), ppn))))
                if kind == "corrupt_message":
                    events.append(corrupt_message(
                        step, edge,
                        kind=str(rng.choice(("bitflip", "zero", "stale"))),
                        element=int(rng.integers(0, 64)),
                        bit=int(rng.integers(0, 31))))
                elif kind == "drop_message":
                    events.append(drop_message(step, edge))
                else:
                    events.append(duplicate_message(step, edge))
            else:
                events.append(dead_node(step, str(rng.choice(list(nodes)))))
        return FaultPlan.of(*events)
