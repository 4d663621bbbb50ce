"""The exchange-phase vocabulary of the distributed SpMV and the error
its self-verifying solvers raise.

Each plan family moves its messages in named phases, in program order:
the node-aware exchange ``full``, ``init``, ``inter``, ``final``; the
standard exchange one flat ``pair``; the multi-step exchange the four
node-aware phases plus ``direct``, the flat owner -> requester hop of
its low-duplication columns.  Wire checksums, ABFT and scripted faults
over these phases are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

NAP_MESSAGE_PHASES: Tuple[str, ...] = ("full", "init", "inter", "final")
STD_MESSAGE_PHASES: Tuple[str, ...] = ("pair",)
MULTISTEP_MESSAGE_PHASES: Tuple[str, ...] = NAP_MESSAGE_PHASES + ("direct",)
COMPUTE_PHASE = "compute"


def message_phases(method: str) -> Tuple[str, ...]:
    if method == "nap":
        return NAP_MESSAGE_PHASES
    if method == "multistep":
        return MULTISTEP_MESSAGE_PHASES
    return STD_MESSAGE_PHASES


def phase_index(method: str) -> Dict[str, int]:
    """Phase name -> row index, the compute pseudo-phase last."""
    phases = message_phases(method) + (COMPUTE_PHASE,)
    return {p: i for i, p in enumerate(phases)}


class IntegrityError(RuntimeError):
    """A verification failed: in the solvers, the true residual drifted
    from the recursive one at the same iterate twice (a persistent SpMV
    corruption that a replay cannot cure)."""
