"""Rank-local block splitting (Eqs. 4-7) and the float64 message-passing
simulators of Algorithm 1 (standard) and Algorithms 2+3 (NAP).

Each rank's rows split into on-process / on-node / off-node *column*
blocks, the three ``local_spmv`` operands of Algorithm 3; each block's
columns are renumbered into the buffer it multiplies against.

The simulators run the comm plans of :mod:`repro_torch.core.comm_graph`
with exact MPI semantics in numpy float64: each rank touches only values
it owns or that arrived in a message, and the set of messages is the
plan itself.  They are the correctness oracle of the device programs
(:mod:`repro_torch.core.spmv_torch`) and the ``backend="simulate"``
executors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.comm_graph import (Message, NAPPlan, StandardPlan,
                                         build_nap_plan, build_standard_plan)
from repro_torch.core.partition import RowPartition
from repro_torch.core.topology import Topology
from repro_torch.sparse.csr import CSR


@dataclasses.dataclass
class LocalBlocks:
    """Rank-local matrix split by column class, with buffer-slot column maps.

    ``rows`` come from the ROW partition (output ownership), ``x_rows``
    from the COLUMN partition (x ownership).
    """

    rank: int
    rows: np.ndarray                 # global rows R(r), ascending
    on_proc: CSR                     # cols -> local x index on this rank
    on_node: CSR                     # cols -> slot in the on-node buffer
    off_node: CSR                    # cols -> slot in the off-node buffer
    on_node_cols: np.ndarray         # global col ids, buffer order (ascending)
    off_node_cols: np.ndarray
    x_rows: np.ndarray               # global x indices owned here, ascending


def split_local_blocks(a: CSR, part: RowPartition, topo: Topology, rank: int,
                       col_part: Optional[RowPartition] = None) -> LocalBlocks:
    cpart = part if col_part is None else col_part
    rows = part.rows_of(rank)
    x_rows = cpart.rows_of(rank)
    local = a.select_rows(rows)
    g_rows, g_cols, vals = local.to_coo()  # g_rows are positions within `rows`
    col_owner = cpart.owner[g_cols]
    col_node = topo.node_of_array(col_owner)
    me_node = topo.node_of(rank)

    on_proc_m = col_owner == rank
    on_node_m = (col_owner != rank) & (col_node == me_node)
    off_node_m = col_node != me_node

    # masked subsets of a row-major COO stay row-major: no re-sort
    op_cols = np.searchsorted(x_rows, g_cols[on_proc_m])
    on_proc = CSR.from_coo(g_rows[on_proc_m], op_cols, vals[on_proc_m],
                           (rows.size, x_rows.size), sum_duplicates=False,
                           assume_sorted=True)

    def buffer_block(mask: np.ndarray) -> Tuple[CSR, np.ndarray]:
        cols = np.unique(g_cols[mask])
        bc = np.searchsorted(cols, g_cols[mask])  # slot in ascending buffer
        blk = CSR.from_coo(g_rows[mask], bc, vals[mask],
                           (rows.size, max(int(cols.size), 1)),
                           sum_duplicates=False, assume_sorted=True)
        return blk, cols

    on_node, on_node_cols = buffer_block(on_node_m)
    off_node, off_node_cols = buffer_block(off_node_m)
    return LocalBlocks(rank=rank, rows=rows, on_proc=on_proc, on_node=on_node,
                       off_node=off_node, on_node_cols=on_node_cols,
                       off_node_cols=off_node_cols, x_rows=x_rows)


def split_all_blocks(a: CSR, part: RowPartition, topo: Topology,
                     col_part: Optional[RowPartition] = None) -> List[LocalBlocks]:
    return [split_local_blocks(a, part, topo, r, col_part=col_part)
            for r in range(topo.n_procs)]


# ---------------------------------------------------------------------------
# Message-passing simulation
# ---------------------------------------------------------------------------

class _MailBox:
    """Delivers plan messages; each value fetched from the *sender's* state.

    Keyed by ``(src, dst)``: every plan phase emits at most one message per
    ordered rank pair (grouped phases by construction; inter chunks because a
    chunk index never repeats an (len_senders, len_receivers) residue pair).
    A duplicate post is a plan bug and fails loudly instead of silently
    overwriting the first payload.

    An optional :class:`repro_torch.core.integrity.SimWire` sits at the post /
    fetch boundary: the sender checksums the clean payload (and a scripted
    fault may corrupt it in flight), the receiver re-checksums on fetch —
    the numpy twin of the instrumented device exchange.
    """

    def __init__(self, wire=None, phase: str = "") -> None:
        self.store: Dict[Tuple[int, int], np.ndarray] = {}
        self.wire, self.phase = wire, phase

    def post(self, msg: Message, values: np.ndarray) -> None:
        assert values.shape == msg.idx.shape
        key = (msg.src, msg.dst)
        assert key not in self.store, \
            f"duplicate message for rank pair {key}: plan emitted two messages " \
            f"in one phase for the same (src, dst)"
        if self.wire is not None:
            values = self.wire.send(self.phase, msg, values)
        self.store[key] = values

    def fetch(self, msg: Message) -> np.ndarray:
        vals = self.store[(msg.src, msg.dst)]
        if self.wire is not None:
            self.wire.recv(self.phase, msg, vals)
        return vals


def _gather_from(available: Dict[int, float], idx: np.ndarray) -> np.ndarray:
    missing = [int(j) for j in idx if int(j) not in available]
    if missing:
        raise AssertionError(f"rank accessed values it never received: {missing[:8]}")
    return np.array([available[int(j)] for j in idx], dtype=np.float64)


def simulate_standard_spmv(a: CSR, v: np.ndarray, plan: StandardPlan,
                           wire=None) -> np.ndarray:
    """Algorithm 1 with explicit message passing (numpy).

    ``v`` has length ``a.shape[1]`` and is owned by the plan's column
    partition; the output has length ``a.shape[0]`` laid out by the row
    partition (the two coincide for square single-partition systems).
    ``wire`` optionally threads a :class:`repro_torch.core.integrity.SimWire`
    through the mailbox (checksums + scripted faults).
    """
    part, topo = plan.partition, plan.topology
    cpart = plan.col_part
    blocks = split_all_blocks(a, part, topo, col_part=cpart)
    w = np.zeros(a.shape[0])
    # post all sends (Isend)
    box = _MailBox(wire, "pair")
    for r in range(topo.n_procs):
        mine = {int(j): float(v[j]) for j in cpart.rows_of(r)}
        for msg in plan.sends[r]:
            box.post(msg, _gather_from(mine, msg.idx))
    # receive + compute
    for r in range(topo.n_procs):
        blk = blocks[r]
        mine = {int(j): float(v[j]) for j in blk.x_rows}
        w_local = blk.on_proc.matvec(
            np.array([mine[int(j)] for j in blk.x_rows]))
        recvd: Dict[int, float] = {}
        for msg in plan.recvs[r]:
            for jj, val in zip(msg.idx, box.fetch(msg)):
                recvd[int(jj)] = float(val)
        # standard algorithm has ONE off-process buffer (on-node ∪ off-node)
        b_node = _gather_from(recvd, blk.on_node_cols)
        b_off = _gather_from(recvd, blk.off_node_cols)
        if blk.on_node_cols.size:
            w_local = w_local + blk.on_node.matvec(b_node)
        if blk.off_node_cols.size:
            w_local = w_local + blk.off_node.matvec(b_off)
        w[blk.rows] = w_local
    return w


def simulate_nap_spmv(a: CSR, v: np.ndarray, plan: NAPPlan,
                      wire=None) -> np.ndarray:
    """Algorithms 2+3 with explicit per-phase message passing (numpy).

    Phase order follows Algorithm 3: local full + local init first, then
    inter-node Isend, local SpMVs overlap, then the final local scatter.
    ``v`` is owned by the plan's column partition, the output by the row
    partition (identical for square single-partition systems).
    ``wire`` optionally threads a :class:`repro_torch.core.integrity.SimWire`
    through all four phase mailboxes (checksums + scripted faults).
    """
    part, topo = plan.partition, plan.topology
    cpart = plan.col_part
    blocks = split_all_blocks(a, part, topo, col_part=cpart)
    w = np.zeros(a.shape[0])

    owned = [{int(j): float(v[j]) for j in cpart.rows_of(r)}
             for r in range(topo.n_procs)]

    # -- phase A: fully-local exchange (on_node -> on_node) ------------------
    box_full = _MailBox(wire, "full")
    for r in range(topo.n_procs):
        for msg in plan.local_full_sends[r]:
            assert topo.same_node(msg.src, msg.dst), "full-local must stay on node"
            box_full.post(msg, _gather_from(owned[r], msg.idx))

    # -- phase B: local init redistribution (on_node -> off_node) ------------
    box_init = _MailBox(wire, "init")
    for r in range(topo.n_procs):
        for msg in plan.local_init_sends[r]:
            assert topo.same_node(msg.src, msg.dst), "init redistribution stays on node"
            box_init.post(msg, _gather_from(owned[r], msg.idx))
    staged = [dict(owned[r]) for r in range(topo.n_procs)]
    for r in range(topo.n_procs):
        for msg in plan.local_init_recvs[r]:
            for jj, val in zip(msg.idx, box_init.fetch(msg)):
                staged[r][int(jj)] = float(val)

    # -- phase C: inter-node exchange (the only network injection) -----------
    box_inter = _MailBox(wire, "inter")
    for r in range(topo.n_procs):
        for msg in plan.inter_sends[r]:
            assert not topo.same_node(msg.src, msg.dst), "inter phase crosses nodes"
            box_inter.post(msg, _gather_from(staged[r], msg.idx))
    arrived = [dict() for _ in range(topo.n_procs)]  # type: List[Dict[int, float]]
    for r in range(topo.n_procs):
        for msg in plan.inter_recvs[r]:
            for jj, val in zip(msg.idx, box_inter.fetch(msg)):
                arrived[r][int(jj)] = float(val)

    # -- phase D: local final scatter (off_node -> on_node) ------------------
    box_final = _MailBox(wire, "final")
    for r in range(topo.n_procs):
        for msg in plan.local_final_sends[r]:
            assert topo.same_node(msg.src, msg.dst)
            box_final.post(msg, _gather_from(arrived[r], msg.idx))
    for r in range(topo.n_procs):
        for msg in plan.local_final_recvs[r]:
            for jj, val in zip(msg.idx, box_final.fetch(msg)):
                arrived[r][int(jj)] = float(val)

    # -- compute: the three local_spmv calls of Algorithm 3 ------------------
    for r in range(topo.n_procs):
        blk = blocks[r]
        w_local = blk.on_proc.matvec(
            np.array([owned[r][int(j)] for j in blk.x_rows])
            if blk.x_rows.size else np.zeros(0))
        if blk.on_node_cols.size:
            b_ll: Dict[int, float] = {}
            for msg in plan.local_full_recvs[r]:
                for jj, val in zip(msg.idx, box_full.fetch(msg)):
                    b_ll[int(jj)] = float(val)
            w_local = w_local + blk.on_node.matvec(_gather_from(b_ll, blk.on_node_cols))
        if blk.off_node_cols.size:
            w_local = w_local + blk.off_node.matvec(_gather_from(arrived[r], blk.off_node_cols))
        w[blk.rows] = w_local
    return w


# ---------------------------------------------------------------------------
# Transpose simulation (reversed send/recv roles)
# ---------------------------------------------------------------------------
#
# ``z = A.T u`` against the SAME plan: each rank multiplies its local rows
# through the transposed column blocks, producing per-index *contributions*
# instead of consuming buffer values; every forward message then runs
# backwards (forward receiver -> forward sender) carrying partial sums,
# which the forward sender accumulates — until contributions reach the
# owner of each vector index, who adds them into z.  This is the MPI-exact
# mirror of the adjoint device program in :mod:`repro_torch.core.spmv_torch`.

def _block_transpose_contrib(blk: LocalBlocks, u: np.ndarray):
    """Per-rank transposed local products: (z-contribution on the rank's
    own x rows, on-node buffer contributions, off-node buffer
    contributions).  ``u`` is row-partition laid out; z lives in the
    column/x space."""
    u_r = u[blk.rows] if blk.rows.size else np.zeros(0)
    z_own = blk.on_proc.transpose().matvec(u_r)
    c_node = blk.on_node.transpose().matvec(u_r) if blk.on_node_cols.size \
        else np.zeros(0)
    c_off = blk.off_node.transpose().matvec(u_r) if blk.off_node_cols.size \
        else np.zeros(0)
    return z_own, c_node, c_off


def _reverse_phase(fwd_sends: List[List[Message]],
                   pending: List[Dict[int, float]],
                   deliver) -> None:
    """Run one forward phase backwards: for every forward message
    (src -> dst, idx), the forward *receiver* pops its accumulated
    contributions for idx and the forward *sender* consumes them via
    ``deliver(src, j, value)``.  Two-phase (post all, then deliver), so a
    rank that both forwards and consumes a value never double-routes."""
    posted = []
    for msgs in fwd_sends:
        for m in msgs:
            vals = np.array([pending[m.dst].pop(int(j)) for j in m.idx])
            posted.append((m.src, m.idx, vals))
    for src, idx, vals in posted:
        for j, val in zip(idx, vals):
            deliver(src, int(j), float(val))


def simulate_standard_spmv_transpose(a: CSR, u: np.ndarray,
                                     plan: StandardPlan) -> np.ndarray:
    """Algorithm 1 reversed: z = A.T u with explicit message passing.

    ``u`` has length ``a.shape[0]`` (row partition); the output has
    length ``a.shape[1]`` and is owned by the column partition.
    """
    part, topo = plan.partition, plan.topology
    cpart = plan.col_part
    blocks = split_all_blocks(a, part, topo, col_part=cpart)
    z = np.zeros(a.shape[1])
    pending: List[Dict[int, float]] = [dict() for _ in range(topo.n_procs)]
    for r in range(topo.n_procs):
        blk = blocks[r]
        z_own, c_node, c_off = _block_transpose_contrib(blk, u)
        z[blk.x_rows] += z_own[: blk.x_rows.size]
        for j, val in zip(blk.on_node_cols, c_node[: blk.on_node_cols.size]):
            pending[r][int(j)] = float(val)
        for j, val in zip(blk.off_node_cols, c_off[: blk.off_node_cols.size]):
            pending[r][int(j)] = float(val)

    # the standard algorithm has ONE phase: reverse it straight to owners.
    def to_owner(rank: int, j: int, val: float) -> None:
        assert cpart.owner[j] == rank, "reversed message missed the owner"
        z[j] += val

    _reverse_phase(plan.sends, pending, to_owner)
    assert all(not p for p in pending), "unrouted transpose contributions"
    return z


def simulate_nap_spmv_transpose(a: CSR, u: np.ndarray,
                                plan: NAPPlan) -> np.ndarray:
    """Algorithms 2+3 reversed, phase by phase: z = A.T u.

    Reverse order of Algorithm 3: final scatter first (consumers -> home
    ranks), then the inter-node exchange (home -> staging rank), then the
    init redistribution (staging rank -> owner); the fully-local phase
    reverses independently (on-node consumers -> owners).  ``u`` is
    row-partition laid out; z is column-partition laid out.
    """
    part, topo = plan.partition, plan.topology
    cpart = plan.col_part
    blocks = split_all_blocks(a, part, topo, col_part=cpart)
    z = np.zeros(a.shape[1])
    # contributions awaiting reverse routing toward the owner (off-node
    # path) and via the fully-local path (on-node buffer).
    pending: List[Dict[int, float]] = [dict() for _ in range(topo.n_procs)]
    node_pending: List[Dict[int, float]] = [dict() for _ in range(topo.n_procs)]
    for r in range(topo.n_procs):
        blk = blocks[r]
        z_own, c_node, c_off = _block_transpose_contrib(blk, u)
        z[blk.x_rows] += z_own[: blk.x_rows.size]
        for j, val in zip(blk.on_node_cols, c_node[: blk.on_node_cols.size]):
            node_pending[r][int(j)] = float(val)
        for j, val in zip(blk.off_node_cols, c_off[: blk.off_node_cols.size]):
            pending[r][int(j)] = float(val)

    def accumulate(rank: int, j: int, val: float) -> None:
        pending[rank][j] = pending[rank].get(j, 0.0) + val

    # -- reverse phase D: consumers return contributions to the home rank --
    _reverse_phase(plan.local_final_sends, pending, accumulate)
    # -- reverse phase C: home ranks return aggregates across the network --
    _reverse_phase(plan.inter_sends, pending, accumulate)

    # -- reverse phase B: staging ranks return contributions to the owners --
    def to_owner(rank: int, j: int, val: float) -> None:
        assert cpart.owner[j] == rank, "reversed init message missed the owner"
        z[j] += val

    _reverse_phase(plan.local_init_sends, pending, to_owner)
    # whatever remains was staged from the rank's own values: fold into z.
    for r in range(topo.n_procs):
        for j, val in pending[r].items():
            assert cpart.owner[j] == r, "unrouted transpose contribution"
            z[j] += val

    # -- reverse phase A: on-node consumers return directly to the owners --
    _reverse_phase(plan.local_full_sends, node_pending, to_owner)
    assert all(not p for p in node_pending), "unrouted on-node contributions"
    return z


# ---------------------------------------------------------------------------
# Convenience wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistSpMV:
    """A distributed SpMV problem: matrix + layout + both plans (apply
    through ``repro_torch.api.operator(a, topo, backend="simulate")`` or
    call the ``simulate_*`` oracles with ``.standard`` / ``.nap``)."""

    a: CSR
    partition: RowPartition
    topology: Topology
    standard: StandardPlan
    nap: NAPPlan
    col_partition: Optional[RowPartition] = None

    @staticmethod
    def build(a: CSR, part: RowPartition, topo: Topology,
              pairing: str = "balanced",
              col_part: Optional[RowPartition] = None) -> "DistSpMV":
        std = build_standard_plan(a.indptr, a.indices, part, topo,
                                  col_part=col_part)
        nap = build_nap_plan(a.indptr, a.indices, part, topo, pairing=pairing,
                             col_part=col_part)
        return DistSpMV(a=a, partition=part, topology=topo, standard=std,
                        nap=nap, col_partition=col_part)

