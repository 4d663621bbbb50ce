"""Token -> expert routing compiled into the node-aware plan machinery.

MoE dispatch is a distributed SpMV exchange: a top-k routing ``(ids
[T, K], weights [T, K])`` is the sparse routing matrix ``R [E, T]``
(values the router weights), and

* the dispatch is R's forward x-exchange: every chip that owns an
  expert receives the payload of every token routed to it, and the
  node-aware dedup applies as it is: a token bound for several experts
  of one remote pod crosses the pod boundary once under the nap plan,
  up to ``top_k`` times under the flat one;
* the weighted dispatch-sum ``R @ X`` is the float64-checkable linear
  surrogate, and the weighted combine is its transpose ``R.T @ Y``.

Layout (as the island of :mod:`repro_torch.moe.dispatch` lays it out):
experts pod-major contiguous (chip ``c = pod * chips_per_pod + inner``
holds experts ``[c * E_loc, (c + 1) * E_loc)``), tokens contiguous over
their gateway chips; so ``Topology(n_nodes=n_pods, ppn=chips_per_pod)``
with two contiguous partitions reproduces the island's communication.

:func:`choose_dispatch` is the per-direction verdict: flat vs nap scored
lexicographically on modeled injected inter-pod bytes at the wire width,
then postal time, then the nap preference.  Numpy only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.comm.cost import planned_traffic
from repro_torch.core.comm_graph import (build_nap_plan, build_standard_plan,
                                         nap_stats, standard_stats)
from repro_torch.core.cost_model import (BLUE_WATERS_POSTAL, PostalParams,
                                         postal_comm_time)
from repro_torch.core.partition import RowPartition, contiguous_partition
from repro_torch.core.topology import Topology
from repro_torch.moe.wire import check_wire_dtype
from repro_torch.sparse import CSR

__all__ = [
    "DISPATCH_MODES", "DISPATCH_PREFERENCE", "routing_matrix",
    "dispatch_partitions", "build_dispatch_plans", "dispatch_traffic",
    "dispatch_verdict", "choose_dispatch", "representative_routing",
]

#: Dispatch executor methods; "auto" resolves to one of the other two.
DISPATCH_MODES: Tuple[str, ...] = ("flat", "nap", "auto")

#: Tie-break order of the verdict (the node-aware plan wins exact ties).
DISPATCH_PREFERENCE: Tuple[str, ...] = ("nap", "flat")


def routing_matrix(ids: np.ndarray, weights: np.ndarray,
                   n_experts: int) -> CSR:
    """The CSR routing matrix ``R [E, T]`` of a top-k routing.

    ``ids [T, K]`` are global expert ids (a negative id marks a dropped
    choice and is skipped), ``weights [T, K]`` the router weights;
    duplicate (expert, token) pairs sum."""
    ids = np.asarray(ids)
    weights = np.asarray(weights, dtype=np.float64)
    if ids.shape != weights.shape or ids.ndim != 2:
        raise ValueError(f"ids/weights must both be [T, K], got "
                         f"{ids.shape} vs {weights.shape}")
    T = ids.shape[0]
    keep = ids >= 0
    tok = np.broadcast_to(np.arange(T)[:, None], ids.shape)[keep]
    exp = ids[keep].astype(np.int64)
    if exp.size and exp.max() >= n_experts:
        raise ValueError(f"expert id {int(exp.max())} out of range "
                         f"[0, {n_experts})")
    return CSR.from_coo(exp, tok, weights[keep], (n_experts, T))


def dispatch_partitions(n_experts: int, n_tokens: int,
                        topo: Topology) -> Tuple[RowPartition, RowPartition]:
    """(expert_part, token_part) of the island's pod-major layout."""
    if n_experts % topo.n_procs:
        raise ValueError(f"n_experts={n_experts} must divide over "
                         f"{topo.n_procs} chips (pod-major contiguous "
                         f"expert layout)")
    return (contiguous_partition(n_experts, topo.n_procs),
            contiguous_partition(n_tokens, topo.n_procs))


def build_dispatch_plans(r: CSR, expert_part: RowPartition,
                         token_part: RowPartition, topo: Topology,
                         pairing: str = "aligned") -> Dict[str, object]:
    """One plan per dispatch mode from the same routing: ``flat`` the
    standard pairwise exchange (Algorithm 1), ``nap`` the three-step
    node-aware plan (Algorithm 3)."""
    return {
        "flat": build_standard_plan(r.indptr, r.indices, expert_part, topo,
                                    col_part=token_part),
        "nap": build_nap_plan(r.indptr, r.indices, expert_part, topo,
                              pairing=pairing, col_part=token_part),
    }


def dispatch_traffic(plan, wire_dtype: str = "f32", nv: int = 1,
                     direction: str = "forward",
                     integrity: str = "off") -> Dict:
    """Slot-granular modeled traffic of one dispatch plan at the wire
    width (``"forward"`` the dispatch, ``"transpose"`` the combine)."""
    check_wire_dtype(wire_dtype)
    return planned_traffic(plan, nv=nv, direction=direction,
                           integrity=integrity, wire_dtype=wire_dtype)


def dispatch_verdict(plans: Dict[str, object], direction: str = "forward",
                     wire_dtype: str = "f32", nv: int = 1,
                     integrity: str = "off",
                     params: PostalParams = BLUE_WATERS_POSTAL) -> Dict:
    """Score the flat and nap plans for one direction: injected inter-pod
    bytes, then postal time, then the nap-first preference."""
    candidates: Dict[str, Dict] = {}
    for name, plan in plans.items():
        traffic = dispatch_traffic(plan, wire_dtype=wire_dtype, nv=nv,
                                   direction=direction, integrity=integrity)
        candidates[name] = {
            "injected_inter_bytes": traffic["injected_inter_bytes"],
            "effective_inter_bytes": traffic["effective_inter_bytes"],
            "injected_intra_bytes": traffic["injected_intra_bytes"],
            "postal_time_s": postal_comm_time(traffic, params)["total"],
        }
    chosen = min(
        candidates,
        key=lambda n: (candidates[n]["injected_inter_bytes"],
                       candidates[n]["postal_time_s"],
                       DISPATCH_PREFERENCE.index(n)))
    return {
        "chosen": chosen,
        "direction": direction,
        "wire_dtype": wire_dtype,
        "postal_params": params.name,
        "candidates": candidates,
    }


def choose_dispatch(r: CSR, expert_part: RowPartition,
                    token_part: RowPartition, topo: Topology,
                    wire_dtype: str = "f32", nv: int = 1,
                    integrity: str = "off",
                    params: PostalParams = BLUE_WATERS_POSTAL,
                    plans: Optional[Dict] = None) -> Dict:
    """Both directions' verdicts for one routing: ``{"dispatch",
    "combine", "plans", "stats"}``.  The directions can disagree (the
    per-rank bottleneck flips when every message reverses); the auto
    executor then runs a different plan each way."""
    if plans is None:
        plans = build_dispatch_plans(r, expert_part, token_part, topo)
    kw = dict(wire_dtype=wire_dtype, nv=nv, integrity=integrity, params=params)
    return {
        "dispatch": dispatch_verdict(plans, direction="forward", **kw),
        "combine": dispatch_verdict(plans, direction="transpose", **kw),
        "plans": plans,
        "stats": {
            "flat": {f"messages_{k}": v for k, v in
                     standard_stats(plans["flat"]).items()},
            "nap": {f"messages_{k}": v for k, v in
                    nap_stats(plans["nap"]).items()},
        },
    }


def representative_routing(n_tokens: int, n_experts: int, top_k: int,
                           seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded uniform top-k routing ``(ids, weights)``: the structure the
    ``"auto"`` mode models when the real routing is data-dependent."""
    k = min(top_k, n_experts)
    rng = np.random.default_rng(seed)
    scores = rng.random((n_tokens, n_experts))
    ids = np.argsort(-scores, axis=1)[:, :k].astype(np.int32)
    w = np.take_along_axis(scores, ids, axis=1)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-9)
    return ids, w
