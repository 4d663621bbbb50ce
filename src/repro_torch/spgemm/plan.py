"""Communication plans for the node-aware distributed SpGEMM ``C = A @ B``.

The paper's insight — aggregate off-node traffic per *node*, not per
process — transfers verbatim from SpMV to sparse matrix-matrix products
(Bienz et al., "Reducing Communication in Algebraic Multigrid with
Multi-step Node Aware Communication", arXiv:1904.05838): the AMG setup's
Galerkin triple products need exactly the rows of ``B`` that an SpMV
would need *entries* of ``x``.  Rank r computes the C rows of its A rows
(the ROW partition) and therefore needs B row k for every off-process
column k of its local A — the same (receiver, owner, index) set the SpMV
comm graphs of :mod:`repro_torch.core.comm_graph` realise, with the vector
index j reinterpreted as the B-row id k.

We therefore REUSE the SpMV plan machinery unchanged — the standard plan
(Algorithm 1) and the three-step node-aware plan (on-process / on-node
gather / ONE aggregated inter-node exchange / on-node scatter) — and
change only the *payload*: each message slot carries the variable-length
CSR rows (indptr/indices/data triples) of the B rows it names, padded to
a compile-time value budget per phase, instead of one scalar per index.
Row *structure* (indices + counts) is exchanged once at plan-build time
("as the matrix is formed", Sec. 2.1 — exactly when MPI codes exchange
their send lists); only the VALUES flow through the runtime three-step.

:class:`SpGemmPlan` wraps the underlying SpMV plan plus the value-level
bookkeeping: per-phase value budgets and sorted row -> (start, count)
slot maps over each phase's flat padded value buffer.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.comm_graph import (Message, NAPPlan, PhaseStats,
                                         StandardPlan, build_nap_plan,
                                         build_standard_plan, lookup_slots)
from repro_torch.core.partition import RowPartition
from repro_torch.core.topology import Topology
from repro_torch.sparse.csr import CSR, expand_positions

__all__ = ["SpGemmPlan", "build_spgemm_plan", "value_slot_map",
           "lookup_row_starts", "local_value_index", "expand_positions",
           "message_value_size", "phase_value_pad"]


def value_slot_map(msgs: Sequence[Message], slots: Sequence[int],
                   b_counts: np.ndarray, vpad: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted row-id -> flat value-buffer START position for one phase.

    The value-level analogue of :func:`repro_torch.core.comm_graph.flat_slot_map`:
    message i lands in buffer slot ``slots[i]``; its rows' values are
    concatenated in ``m.idx`` order, so row ``m.idx[t]`` starts at flat
    position ``slots[i] * vpad + sum(b_counts[m.idx[:t]])`` and spans
    ``b_counts[m.idx[t]]`` values.  Returns parallel ``(row, start)``
    arrays with ``row`` ascending (one ``np.searchsorted`` resolves whole
    row-id arrays).  Rows must be disjoint across the phase's messages.
    """
    if not msgs:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy()
    rows = np.concatenate([m.idx for m in msgs])
    starts = np.concatenate([
        s * vpad + np.concatenate([[0], np.cumsum(b_counts[m.idx])[:-1]])
        for s, m in zip(slots, msgs)])
    order = np.argsort(rows, kind="stable")
    rows, starts = rows[order], starts[order]
    assert rows.size < 2 or (np.diff(rows) > 0).all(), \
        "phase delivers one B row through two messages"
    return rows, starts.astype(np.int64)


def lookup_row_starts(table: Tuple[np.ndarray, np.ndarray],
                      query: np.ndarray) -> np.ndarray:
    """Resolve row ids against a :func:`value_slot_map` table (the same
    sorted-parallel-array lookup as the SpMV slot maps)."""
    return lookup_slots(table, query)


def message_value_size(msg: Message, b_counts: np.ndarray) -> int:
    """Number of B values one message carries (sum of its rows' nnz)."""
    return int(b_counts[msg.idx].sum())


def phase_value_pad(msg_lists: List[List[Message]],
                    b_counts: np.ndarray) -> int:
    """Compile-time value budget per message slot for one phase: the max
    total value payload over the phase's messages (>= 1 so empty phases
    still shape a [slots, 1] buffer)."""
    sizes = [message_value_size(m, b_counts)
             for msgs in msg_lists for m in msgs]
    return max(1, max(sizes, default=1))


def local_value_index(mid_part: RowPartition,
                      b_counts: np.ndarray) -> np.ndarray:
    """global B row -> START of its values within its owner's local
    concatenated value array (rows concatenated in ascending-row order) —
    the value-weighted analogue of :meth:`RowPartition.local_index`."""
    start = np.zeros(mid_part.n_rows, dtype=np.int64)
    for r in range(mid_part.n_procs):
        rows = mid_part.rows_of(r)
        if rows.size:
            c = b_counts[rows]
            start[rows] = np.concatenate([[0], np.cumsum(c)[:-1]])
    return start


@dataclasses.dataclass
class SpGemmPlan:
    """A distributed-SpGEMM plan: the SpMV comm graph of A's off-process
    columns + the value-level payload bookkeeping for B's rows.

    ``row_part`` owns A's (and C's) rows; ``mid_part`` owns B's rows (the
    contraction dimension — A's column space).  ``comm`` is the
    underlying :class:`NAPPlan` or :class:`StandardPlan` whose message
    ``idx`` arrays are B-ROW ids; ``b_indptr``/``b_indices`` are the
    B structure snapshot exchanged at plan-build time (value payloads
    flow at run time).
    """

    method: str                       # "nap" | "standard"
    topo: Topology
    row_part: RowPartition
    mid_part: RowPartition
    comm: Union[NAPPlan, StandardPlan]
    b_indptr: np.ndarray
    b_indices: np.ndarray
    shape: Tuple[int, int]            # C = [a_rows, b_cols]

    @functools.cached_property
    def b_counts(self) -> np.ndarray:
        """nnz per B row (cached — compile walks this per rank/phase)."""
        return np.diff(self.b_indptr)

    def value_pads(self) -> Dict[str, int]:
        """Per-phase compile-time value budgets (max values per message)."""
        c = self.b_counts
        if self.method == "standard":
            return {"pair": phase_value_pad(self.comm.sends, c)}
        return {
            "full": phase_value_pad(self.comm.local_full_sends, c),
            "init": phase_value_pad(self.comm.local_init_sends, c),
            "inter": phase_value_pad(self.comm.inter_sends, c),
            "final": phase_value_pad(self.comm.local_final_sends, c),
        }

    def recv_value_map(self, rank: int, phase: str,
                       vpad: int) -> Tuple[np.ndarray, np.ndarray]:
        """Row -> flat value-buffer start map for one recv phase (slot =
        sender local id for intra-node phases / sender rank for the
        standard plan's single phase / sender node id for "inter")."""
        topo = self.topo
        if self.method == "standard":
            assert phase == "pair"
            msgs = self.comm.recvs[rank]
            slots = [m.src for m in msgs]
        else:
            msgs = {"full": self.comm.local_full_recvs,
                    "init": self.comm.local_init_recvs,
                    "final": self.comm.local_final_recvs,
                    "inter": self.comm.inter_recvs}[phase][rank]
            slot_of = topo.node_of if phase == "inter" else topo.local_of
            slots = [slot_of(m.src) for m in msgs]
        return value_slot_map(msgs, slots, self.b_counts, vpad)

    def stats(self, bytes_per_val: int = 8,
              bytes_per_idx: int = 8) -> Dict[str, PhaseStats]:
        """Per-phase message statistics with VALUE-weighted payloads.

        A message carrying rows ``idx`` moves ``sum(b_counts[idx])``
        values plus (one-time, at setup) the same number of column
        indices and one count per row; runtime products move only the
        value bytes, which is what these stats weigh.
        """
        c = self.b_counts

        def of(msg_lists: List[List[Message]]) -> PhaseStats:
            counts = [len(msgs) for msgs in msg_lists]
            sizes = [sum(message_value_size(m, c) for m in msgs) * bytes_per_val
                     for msgs in msg_lists]
            return PhaseStats(
                max_msgs=max(counts, default=0),
                max_bytes=max(sizes, default=0),
                total_msgs=sum(counts), total_bytes=sum(sizes))

        if self.method == "standard":
            topo = self.topo
            inter = [[m for m in msgs if not topo.same_node(m.src, m.dst)]
                     for msgs in self.comm.sends]
            intra = [[m for m in msgs if topo.same_node(m.src, m.dst)]
                     for msgs in self.comm.sends]
            return {"inter": of(inter), "intra": of(intra)}
        intra = [a + b + d for a, b, d in zip(self.comm.local_init_sends,
                                              self.comm.local_full_sends,
                                              self.comm.local_final_sends)]
        return {"inter": of(self.comm.inter_sends), "intra": of(intra)}


def build_spgemm_plan(a: CSR, b: CSR, row_part: RowPartition,
                      mid_part: RowPartition, topo: Topology,
                      method: str = "nap",
                      pairing: str = "aligned") -> SpGemmPlan:
    """Build the SpGEMM communication plan for ``C = A @ B``.

    ``row_part`` owns A's rows (and hence C's); ``mid_part`` owns B's
    rows — A's column dimension (for a Galerkin ``A @ P`` both are the
    fine partition; for ``R @ AP`` the row partition is coarse and the
    mid partition fine).  ``method="nap"`` routes remote B rows through
    the paper's three-step node-aware exchange, ``"standard"`` through
    Algorithm 1's direct point-to-point flow.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes do not chain: {a.shape} @ {b.shape}")
    if row_part.n_rows != a.shape[0] or mid_part.n_rows != b.shape[0]:
        raise ValueError(
            f"partition mismatch: a is {a.shape}, b is {b.shape}, row_part "
            f"has {row_part.n_rows} rows, mid_part {mid_part.n_rows}")
    if method == "nap":
        comm = build_nap_plan(a.indptr, a.indices, row_part, topo,
                              pairing=pairing, col_part=mid_part)
    elif method == "standard":
        comm = build_standard_plan(a.indptr, a.indices, row_part, topo,
                                   col_part=mid_part)
    else:
        raise ValueError(f"method must be 'nap'|'standard', got {method!r}")
    return SpGemmPlan(method=method, topo=topo, row_part=row_part,
                      mid_part=mid_part, comm=comm,
                      b_indptr=b.indptr.copy(), b_indices=b.indices.copy(),
                      shape=(a.shape[0], b.shape[1]))
