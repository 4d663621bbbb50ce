"""Float64 message-passing simulators for the multi-step strategy.

Mirror :func:`repro_torch.core.spmv.simulate_nap_spmv` (and its transpose)
phase by phase, adding the fifth "direct" exchange that carries the
low-duplication columns owner -> requester in one hop.  The local
blocks, delivered values, and compute order are identical to the
single-step simulator's, so the forward result is bit-for-bit equal to
``simulate_nap_spmv`` on the same matrix — the strategies differ in
routing, never in arithmetic.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.comm.multistep import MultistepPlan
from repro_torch.core.spmv import (_block_transpose_contrib, _gather_from,
                             _MailBox, _reverse_phase, split_all_blocks)
from repro_torch.sparse.csr import CSR


def simulate_multistep_spmv(a: CSR, v: np.ndarray, plan: MultistepPlan,
                            wire=None) -> np.ndarray:
    """w = A v through the five-phase multi-step exchange (numpy).

    ``v`` is owned by the plan's column partition, the output by the row
    partition.  ``wire`` optionally threads a
    :class:`repro_torch.core.integrity.SimWire` through all five mailboxes.
    """
    nap, direct = plan.nap, plan.direct
    part, topo = plan.partition, plan.topology
    cpart = plan.col_part
    blocks = split_all_blocks(a, part, topo, col_part=cpart)
    w = np.zeros(a.shape[0])

    owned = [{int(j): float(v[j]) for j in cpart.rows_of(r)}
             for r in range(topo.n_procs)]

    # -- phase A: fully-local exchange (on_node -> on_node) ------------------
    box_full = _MailBox(wire, "full")
    for r in range(topo.n_procs):
        for msg in nap.local_full_sends[r]:
            assert topo.same_node(msg.src, msg.dst), "full-local must stay on node"
            box_full.post(msg, _gather_from(owned[r], msg.idx))

    # -- phase B: local init redistribution (on_node -> off_node) ------------
    box_init = _MailBox(wire, "init")
    for r in range(topo.n_procs):
        for msg in nap.local_init_sends[r]:
            assert topo.same_node(msg.src, msg.dst), "init redistribution stays on node"
            box_init.post(msg, _gather_from(owned[r], msg.idx))
    staged = [dict(owned[r]) for r in range(topo.n_procs)]
    for r in range(topo.n_procs):
        for msg in nap.local_init_recvs[r]:
            for jj, val in zip(msg.idx, box_init.fetch(msg)):
                staged[r][int(jj)] = float(val)

    # -- phase C: aggregated inter-node exchange (high-duplication share) ----
    box_inter = _MailBox(wire, "inter")
    for r in range(topo.n_procs):
        for msg in nap.inter_sends[r]:
            assert not topo.same_node(msg.src, msg.dst), "inter phase crosses nodes"
            box_inter.post(msg, _gather_from(staged[r], msg.idx))
    arrived: List[Dict[int, float]] = [dict() for _ in range(topo.n_procs)]
    for r in range(topo.n_procs):
        for msg in nap.inter_recvs[r]:
            for jj, val in zip(msg.idx, box_inter.fetch(msg)):
                arrived[r][int(jj)] = float(val)

    # -- phase D: local final scatter (off_node -> on_node) ------------------
    box_final = _MailBox(wire, "final")
    for r in range(topo.n_procs):
        for msg in nap.local_final_sends[r]:
            assert topo.same_node(msg.src, msg.dst)
            box_final.post(msg, _gather_from(arrived[r], msg.idx))
    for r in range(topo.n_procs):
        for msg in nap.local_final_recvs[r]:
            for jj, val in zip(msg.idx, box_final.fetch(msg)):
                arrived[r][int(jj)] = float(val)

    # -- phase E: direct owner -> requester exchange (low duplication) -------
    box_direct = _MailBox(wire, "direct")
    for r in range(topo.n_procs):
        for msg in direct.sends[r]:
            assert not topo.same_node(msg.src, msg.dst), \
                "direct phase carries only off-node traffic"
            box_direct.post(msg, _gather_from(owned[r], msg.idx))
    for r in range(topo.n_procs):
        for msg in direct.recvs[r]:
            for jj, val in zip(msg.idx, box_direct.fetch(msg)):
                arrived[r][int(jj)] = float(val)

    # -- compute: identical to the single-step simulator ---------------------
    for r in range(topo.n_procs):
        blk = blocks[r]
        w_local = blk.on_proc.matvec(
            np.array([owned[r][int(j)] for j in blk.x_rows])
            if blk.x_rows.size else np.zeros(0))
        if blk.on_node_cols.size:
            b_ll: Dict[int, float] = {}
            for msg in nap.local_full_recvs[r]:
                for jj, val in zip(msg.idx, box_full.fetch(msg)):
                    b_ll[int(jj)] = float(val)
            w_local = w_local + blk.on_node.matvec(
                _gather_from(b_ll, blk.on_node_cols))
        if blk.off_node_cols.size:
            w_local = w_local + blk.off_node.matvec(
                _gather_from(arrived[r], blk.off_node_cols))
        w[blk.rows] = w_local
    return w


def simulate_multistep_spmv_transpose(a: CSR, u: np.ndarray,
                                      plan: MultistepPlan) -> np.ndarray:
    """z = A.T u through the reversed five-phase exchange.

    Reverse order: final scatter, inter-node aggregate, then the direct
    contributions go straight back to their owners, then init, then the
    fully-local phase — the exact mirror of the forward routing.
    """
    nap, direct = plan.nap, plan.direct
    part, topo = plan.partition, plan.topology
    cpart = plan.col_part
    blocks = split_all_blocks(a, part, topo, col_part=cpart)
    z = np.zeros(a.shape[1])
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

    def to_owner(rank: int, j: int, val: float) -> None:
        assert cpart.owner[j] == rank, "reversed message missed the owner"
        z[j] += val

    # -- reverse final: consumers return contributions to the home rank -----
    _reverse_phase(nap.local_final_sends, pending, accumulate)
    # -- reverse inter: home ranks return aggregates across the network ------
    _reverse_phase(nap.inter_sends, pending, accumulate)
    # -- reverse direct: requesters return contributions straight to owners --
    _reverse_phase(direct.sends, pending, to_owner)
    # -- reverse init: staging ranks return contributions to the owners ------
    _reverse_phase(nap.local_init_sends, pending, to_owner)
    # whatever remains was staged from the rank's own values: fold into z.
    for r in range(topo.n_procs):
        for j, val in pending[r].items():
            assert cpart.owner[j] == r, "unrouted transpose contribution"
            z[j] += val

    # -- reverse full: on-node consumers return directly to the owners -------
    _reverse_phase(nap.local_full_sends, node_pending, to_owner)
    assert all(not p for p in node_pending), "unrouted on-node contributions"
    return z
