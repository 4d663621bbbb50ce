"""Per-operator (and per-direction) choice of the exchange strategy.

:func:`choose_comm` builds the three plans once from the matrix
structure, scores each with :func:`repro_torch.comm.cost.planned_traffic`
plus the postal alpha-beta term, and picks the winner lexicographically:

1. fewest injected inter-node bytes (padded slots plus, with integrity
   on, the checksum side channel), the quantity the paper optimizes, an
   exact property of the plan;
2. then the lowest postal time (start-ups matter when bytes tie);
3. then the preference ``nap < multistep < standard``: the incumbent
   wins exact ties, so a multistep plan with no direct share never
   displaces plain nap.

The postal constants default to :data:`BLUE_WATERS_POSTAL`, the paper's
machine.  The verdict is merged into ``autotune_report()`` by the
operator front end.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from repro_torch.comm.cost import planned_traffic
from repro_torch.comm.strategies import COMM_STRATEGIES
from repro_torch.core.cost_model import (BLUE_WATERS_POSTAL, PostalParams,
                                         postal_comm_time)

#: tie-break order: the paper's strategy, then its refinement.
PREFERENCE = ("nap", "multistep", "standard")


def build_candidate_plans(indptr: np.ndarray, indices: np.ndarray, part,
                          topo, pairing: str = "aligned", col_part=None,
                          threshold: Union[int, str] = "auto") -> Dict:
    """One plan per registered strategy, from the same structure."""
    return {
        name: strat.build_plan(indptr, indices, part, topo, pairing=pairing,
                               col_part=col_part, threshold=threshold)
        for name, strat in COMM_STRATEGIES.items()
    }


def comm_verdict(plans: Dict, direction: str = "forward",
                 bytes_per_val: int = 4, nv: int = 1,
                 integrity: str = "off",
                 params: PostalParams = BLUE_WATERS_POSTAL,
                 wire_dtype: str = "f32") -> Dict:
    """Score prebuilt candidate plans for one exchange direction;
    ``integrity`` charges the checksum wires it adds and ``wire_dtype``
    the quantized payload width (a narrower wire shrinks every
    candidate's bytes alike, but not the postal start-ups, so the verdict
    can move toward the strategies that send fewer messages)."""
    candidates: Dict[str, Dict] = {}
    for name, plan in plans.items():
        traffic = planned_traffic(plan, bytes_per_val=bytes_per_val, nv=nv,
                                  direction=direction, integrity=integrity,
                                  wire_dtype=wire_dtype)
        times = postal_comm_time(traffic, params)
        candidates[name] = {
            "injected_inter_bytes": traffic["injected_inter_bytes"],
            "effective_inter_bytes": traffic["effective_inter_bytes"],
            "injected_intra_bytes": traffic["injected_intra_bytes"],
            "postal_time_s": times["total"],
            "postal_phase_s": {k: v for k, v in times.items() if k != "total"},
        }
    chosen = min(candidates,
                 key=lambda n: (candidates[n]["injected_inter_bytes"],
                                candidates[n]["postal_time_s"],
                                PREFERENCE.index(n)))
    return {"chosen": chosen, "direction": direction, "wire_dtype": wire_dtype,
            "postal_params": params.name, "candidates": candidates}


def choose_comm(indptr: np.ndarray, indices: np.ndarray, part, topo,
                pairing: str = "aligned", col_part=None,
                threshold: Union[int, str] = "auto",
                bytes_per_val: int = 4, nv: int = 1,
                integrity: str = "off",
                params: PostalParams = BLUE_WATERS_POSTAL,
                plans: Optional[Dict] = None,
                wire_dtype: str = "f32") -> Dict:
    """Verdicts of both directions for one operator's structure.

    Returns ``{"forward": verdict, "transpose": verdict, "threshold",
    "plans"}``; the two directions can disagree because the per-rank
    bottleneck flips roles when every message reverses.  ``plans``
    reuses candidate plans the caller already built; ``wire_dtype``
    scores both directions at that payload width.
    """
    if plans is None:
        plans = build_candidate_plans(indptr, indices, part, topo,
                                      pairing=pairing, col_part=col_part,
                                      threshold=threshold)
    kw = dict(bytes_per_val=bytes_per_val, nv=nv, integrity=integrity,
              params=params, wire_dtype=wire_dtype)
    ms = plans.get("multistep")
    return {
        "forward": comm_verdict(plans, direction="forward", **kw),
        "transpose": comm_verdict(plans, direction="transpose", **kw),
        "threshold": getattr(ms, "threshold", None),
        "plans": plans,
    }
