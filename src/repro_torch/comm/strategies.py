"""Registry of the exchange strategies.

A :class:`CommStrategy` names one way to route the off-process columns
of a distributed SpMV: the flat ``standard`` exchange, the paper's
aggregated node-aware ``nap`` exchange, or the duplication-split
``multistep`` variant.  Each builds its plan through the same
``build_plan(indptr, indices, part, topo, pairing=, col_part=,
threshold=)``; ``"auto"`` is not a strategy but lets
:func:`repro_torch.comm.autotune.choose_comm` pick one per operator and
direction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.comm.multistep import build_multistep_plan
from repro_torch.core.comm_graph import build_nap_plan, build_standard_plan
from repro_torch.core.integrity import message_phases


def _build_standard(indptr, indices, part, topo, pairing="aligned",
                    col_part=None, threshold="auto"):
    del pairing, threshold  # one flat exchange: nothing to pair or split
    return build_standard_plan(indptr, indices, part, topo, col_part=col_part)


def _build_nap(indptr, indices, part, topo, pairing="aligned",
               col_part=None, threshold="auto"):
    del threshold
    return build_nap_plan(indptr, indices, part, topo, pairing=pairing,
                          col_part=col_part)


def _build_multistep(indptr, indices, part, topo, pairing="aligned",
                     col_part=None, threshold="auto"):
    return build_multistep_plan(indptr, indices, part, topo, pairing=pairing,
                                col_part=col_part, threshold=threshold)


@dataclasses.dataclass(frozen=True)
class CommStrategy:
    """One exchange strategy: its executor method, message phases (in
    program order) and plan builder."""

    name: str
    method: str
    phases: Tuple[str, ...]
    build_plan: Callable
    description: str


COMM_STRATEGIES: Dict[str, CommStrategy] = {
    "standard": CommStrategy(
        name="standard", method="standard",
        phases=message_phases("standard"), build_plan=_build_standard,
        description="one flat exchange over every (proc, proc) pair"),
    "nap": CommStrategy(
        name="nap", method="nap", phases=message_phases("nap"),
        build_plan=_build_nap,
        description="aggregated node-aware exchange "
                    "(intra init -> one inter exchange -> intra final)"),
    "multistep": CommStrategy(
        name="multistep", method="multistep",
        phases=message_phases("multistep"), build_plan=_build_multistep,
        description="node-aware exchange for high-duplication columns, "
                    "direct owner->requester hop for the rest"),
}

#: what ``operator(comm=...)`` accepts; "auto" resolves through the chooser.
COMM_CHOICES: Tuple[str, ...] = ("standard", "nap", "multistep", "auto")


def get_strategy(name: str) -> CommStrategy:
    try:
        return COMM_STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown comm strategy {name!r}; "
            f"expected one of {sorted(COMM_STRATEGIES)}") from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(COMM_STRATEGIES)
