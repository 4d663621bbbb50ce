"""Multi-step node-aware exchange: split off-node traffic by duplication.

The paper's aggregated inter-node exchange (:class:`NAPPlan`) pays off
for columns that several processes on the destination node need: each
crosses the network once and fans out locally.  Its follow-up
(arXiv:1904.05838) observes that columns needed by one (or few)
processes there gain nothing from the dedup, yet still pay the init and
final intra-node hops and stretch the aggregated exchange's slot pad.

:func:`build_multistep_plan` splits the deduped off-process triples
``(t, r, j)`` by a duplication threshold:

* ``d(j) >= threshold``: an ordinary :class:`NAPPlan` over that share
  (full / init / inter / final);
* ``d(j) < threshold``: the column ships owner -> requester in one
  network hop through a :class:`StandardPlan` sub-exchange, the
  ``"direct"`` phase.

On-node triples always ride the NAP sub-plan's full phase.  With
``threshold <= 1`` nothing goes direct and the plan is the single-step
NAP plan over the same triples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core.comm_graph import (NAPPlan, PhaseStats, StandardPlan,
                                         _offproc_pairs, build_nap_plan,
                                         build_standard_plan, nap_stats)
from repro_torch.core.partition import RowPartition
from repro_torch.core.topology import Topology

#: ``threshold="auto"``: the dedup pays as soon as a second process on
#: the destination node needs the column (one saved network crossing).
AUTO_THRESHOLD = 2


def resolve_threshold(threshold: Union[int, str], topo: Topology) -> int:
    if threshold == "auto":
        return AUTO_THRESHOLD
    thr = int(threshold)
    if thr < 1:
        raise ValueError(f"duplication threshold must be >= 1, got {thr}")
    return thr


def duplication_counts(t: np.ndarray, j: np.ndarray, topo: Topology,
                       n_cols: int) -> np.ndarray:
    """Per triple, how many distinct processes on its destination NODE
    request column j: triples are deduped per ``(t, r, j)`` and a column
    has one owner, so that is the count of triples sharing
    ``(node_of(t), j)``."""
    if t.size == 0:
        return np.zeros(0, dtype=np.int64)
    tn = topo.node_of_array(t).astype(np.int64)
    key = tn * np.int64(n_cols) + j
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    return counts[inv]


@dataclasses.dataclass
class MultistepPlan:
    """A NAP sub-plan for the high-duplication share and a direct
    (owner -> requester) sub-plan for the rest, over the same topology
    and partitions; their triple sets partition the off-process set."""

    topology: Topology
    partition: RowPartition
    nap: NAPPlan
    direct: StandardPlan
    threshold: int
    col_partition: Optional[RowPartition] = None

    @property
    def col_part(self) -> RowPartition:
        return self.col_partition if self.col_partition is not None \
            else self.partition


def build_multistep_plan(indptr: np.ndarray, indices: np.ndarray,
                         part: RowPartition, topo: Topology,
                         pairing: str = "aligned",
                         col_part: Optional[RowPartition] = None,
                         threshold: Union[int, str] = "auto",
                         pairs: Optional[Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]] = None
                         ) -> MultistepPlan:
    """Split the off-process triples by duplication and build both
    sub-plans (``pairs`` as in :func:`build_nap_plan`)."""
    thr = resolve_threshold(threshold, topo)
    cpart = part if col_part is None else col_part
    t, r, j = pairs if pairs is not None else \
        _offproc_pairs(indptr, indices, part, cpart)
    off_node = topo.node_of_array(t) != topo.node_of_array(r)
    d = duplication_counts(t[off_node], j[off_node], topo, cpart.n_rows)
    direct = np.zeros(t.shape, dtype=bool)
    direct[np.flatnonzero(off_node)[d < thr]] = True
    nap_sub = build_nap_plan(indptr, indices, part, topo, pairing=pairing,
                             col_part=col_part,
                             pairs=(t[~direct], r[~direct], j[~direct]))
    direct_sub = build_standard_plan(indptr, indices, part, topo,
                                     col_part=col_part,
                                     pairs=(t[direct], r[direct], j[direct]))
    return MultistepPlan(topology=topo, partition=part, nap=nap_sub,
                         direct=direct_sub, threshold=thr,
                         col_partition=col_part)


def multistep_stats(plan: MultistepPlan,
                    bytes_per_val: int = 8) -> Dict[str, PhaseStats]:
    """NAP phase stats plus the direct exchange (every direct message
    crosses the network by construction)."""
    out = nap_stats(plan.nap, bytes_per_val)
    out["direct"] = PhaseStats.of(plan.direct.sends, bytes_per_val)
    return out
