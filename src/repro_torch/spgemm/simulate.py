"""Exact message-passing simulators for the distributed SpGEMM (float64).

These mirror the MPI flow of :func:`repro_torch.core.spmv.simulate_nap_spmv` /
``simulate_standard_spmv`` with the payload generalised from one scalar
per vector index to the variable-length value block of one B row per
index: each rank touches only B values it owns (``mid_part``) or that
arrived in a plan message, routes them through the plan's phases (for
the node-aware plan: fully-local exchange, init redistribution, ONE
aggregated inter-node exchange, final scatter), and multiplies its local
A rows against the gathered rows with the same vectorised row-expansion
+ stable duplicate merge as :func:`repro_torch.amg.matmul.csr_matmul` — so the
assembled global C is **bit-for-bit equal** to the host product in
float64 (identical product enumeration order, identical ``reduceat``
summation order).  This is the correctness oracle for the device
SpGEMM program and the float64 path of ``materialize=True`` AMG setups.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.comm_graph import Message
from repro_torch.spgemm.plan import SpGemmPlan, expand_positions
from repro_torch.sparse.csr import CSR


class _RowMailBox:
    """Delivers one message's concatenated B-row values, keyed (src, dst)
    like :class:`repro_torch.core.spmv._MailBox` (one message per ordered pair
    per phase by plan construction)."""

    def __init__(self, b_counts: np.ndarray) -> None:
        self.b_counts = b_counts
        self.store: Dict[tuple, np.ndarray] = {}

    def post(self, msg: Message, rows: Dict[int, np.ndarray]) -> None:
        vals = [rows[int(k)] for k in msg.idx]  # KeyError = never received
        payload = (np.concatenate(vals) if vals
                   else np.empty(0, dtype=np.float64))
        assert payload.size == int(self.b_counts[msg.idx].sum())
        key = (msg.src, msg.dst)
        assert key not in self.store, f"duplicate message for {key}"
        self.store[key] = payload

    def fetch(self, msg: Message) -> Dict[int, np.ndarray]:
        payload = self.store[(msg.src, msg.dst)]
        bounds = np.cumsum(self.b_counts[msg.idx])[:-1]
        return {int(k): v for k, v in zip(msg.idx, np.split(payload, bounds))}


def _owned_rows(b: CSR, plan: SpGemmPlan, rank: int) -> Dict[int, np.ndarray]:
    return {int(k): b.data[b.indptr[k]: b.indptr[k + 1]].astype(np.float64)
            for k in plan.mid_part.rows_of(rank)}


def _rank_product(a: CSR, plan: SpGemmPlan, rank: int,
                  rows_avail: Dict[int, np.ndarray]):
    """(global C rows, cols, merged vals) of rank's C rows, computed from
    its local A rows and the available B rows only.

    Product enumeration order is A row-major (rows ascending, then A's
    stored column order, then B-row order) and duplicates merge through
    ``CSR.from_coo``'s stable sort + ``reduceat`` — the exact order
    :func:`repro_torch.amg.matmul.csr_matmul` uses, hence bit-for-bit parity.
    """
    g_rows = plan.row_part.rows_of(rank)
    local = a.select_rows(g_rows)
    ai, ak, av = local.to_coo()
    if ai.size == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), np.empty(0, dtype=np.float64)
    b_counts, b_indptr, b_indices = (plan.b_counts, plan.b_indptr,
                                     plan.b_indices)
    # compact per-rank B store over the rows this rank's A references
    needed = np.unique(ak)
    missing = [int(k) for k in needed if int(k) not in rows_avail]
    assert not missing, f"rank {rank} accessed B rows it never " \
                        f"received: {missing[:8]}"
    store_vals = (np.concatenate([rows_avail[int(k)] for k in needed])
                  if needed.size else np.empty(0, dtype=np.float64))
    store_cols = (np.concatenate([b_indices[b_indptr[k]: b_indptr[k + 1]]
                                  for k in needed])
                  if needed.size else np.empty(0, dtype=np.int64))
    nc = b_counts[needed]
    store_start = np.concatenate([[0], np.cumsum(nc)[:-1]]).astype(np.int64)
    # vectorised row expansion (the csr_matmul kernel over the store)
    k_pos = np.searchsorted(needed, ak)
    counts = nc[k_pos]
    take = expand_positions(store_start[k_pos], counts)
    if take.size == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), np.empty(0, dtype=np.float64)
    rows = np.repeat(ai, counts)
    cols = store_cols[take]
    vals = np.repeat(av, counts) * store_vals[take]
    merged = CSR.from_coo(rows, cols, vals, (g_rows.size, plan.shape[1]))
    mr, mc, mv = merged.to_coo()
    return g_rows[mr], mc, mv


def _assemble(parts: List[tuple], shape) -> CSR:
    rows = np.concatenate([p[0] for p in parts]) if parts else np.empty(0, np.int64)
    cols = np.concatenate([p[1] for p in parts]) if parts else np.empty(0, np.int64)
    vals = np.concatenate([p[2] for p in parts]) if parts else np.empty(0)
    # per-rank results are already duplicate-merged and each C row is
    # computed by exactly one rank: a pure re-sort, never a re-sum
    return CSR.from_coo(rows, cols, vals, shape, sum_duplicates=False)


def simulate_standard_spgemm(a: CSR, b: CSR, plan: SpGemmPlan) -> CSR:
    """Algorithm 1's flat exchange carrying B-row value blocks."""
    assert plan.method == "standard", plan.method
    topo, comm = plan.topo, plan.comm
    box = _RowMailBox(plan.b_counts)
    owned = [_owned_rows(b, plan, r) for r in range(topo.n_procs)]
    for r in range(topo.n_procs):
        for msg in comm.sends[r]:
            box.post(msg, owned[r])
    parts = []
    for r in range(topo.n_procs):
        avail = dict(owned[r])
        for msg in comm.recvs[r]:
            avail.update(box.fetch(msg))
        parts.append(_rank_product(a, plan, r, avail))
    return _assemble(parts, plan.shape)


def simulate_nap_spgemm(a: CSR, b: CSR, plan: SpGemmPlan) -> CSR:
    """Algorithms 2+3 generalised to row-block payloads: fully-local and
    init exchanges first, then the single aggregated inter-node exchange,
    then the final on-node scatter — the only network injection is the
    inter phase, exactly as in the node-aware SpMV."""
    assert plan.method == "nap", plan.method
    topo, comm = plan.topo, plan.comm
    owned = [_owned_rows(b, plan, r) for r in range(topo.n_procs)]

    # -- phase A: fully-local exchange (on_node -> on_node) ------------------
    box_full = _RowMailBox(plan.b_counts)
    for r in range(topo.n_procs):
        for msg in comm.local_full_sends[r]:
            assert topo.same_node(msg.src, msg.dst)
            box_full.post(msg, owned[r])

    # -- phase B: init redistribution (owner -> staging rank, on node) -------
    box_init = _RowMailBox(plan.b_counts)
    for r in range(topo.n_procs):
        for msg in comm.local_init_sends[r]:
            assert topo.same_node(msg.src, msg.dst)
            box_init.post(msg, owned[r])
    staged = [dict(owned[r]) for r in range(topo.n_procs)]
    for r in range(topo.n_procs):
        for msg in comm.local_init_recvs[r]:
            staged[r].update(box_init.fetch(msg))

    # -- phase C: the ONE aggregated inter-node exchange ---------------------
    box_inter = _RowMailBox(plan.b_counts)
    for r in range(topo.n_procs):
        for msg in comm.inter_sends[r]:
            assert not topo.same_node(msg.src, msg.dst)
            box_inter.post(msg, staged[r])
    arrived: List[Dict[int, np.ndarray]] = [dict() for _ in range(topo.n_procs)]
    for r in range(topo.n_procs):
        for msg in comm.inter_recvs[r]:
            arrived[r].update(box_inter.fetch(msg))

    # -- phase D: final on-node scatter (home rank -> consumers) -------------
    box_final = _RowMailBox(plan.b_counts)
    for r in range(topo.n_procs):
        for msg in comm.local_final_sends[r]:
            assert topo.same_node(msg.src, msg.dst)
            box_final.post(msg, arrived[r])
    for r in range(topo.n_procs):
        for msg in comm.local_final_recvs[r]:
            arrived[r].update(box_final.fetch(msg))

    # -- local products: owned + on-node (full) + off-node (arrived) rows ----
    parts = []
    for r in range(topo.n_procs):
        avail = dict(owned[r])
        for msg in comm.local_full_recvs[r]:
            avail.update(box_full.fetch(msg))
        avail.update(arrived[r])
        parts.append(_rank_product(a, plan, r, avail))
    return _assemble(parts, plan.shape)


def simulate_spgemm(a: CSR, b: CSR, plan: SpGemmPlan) -> CSR:
    """Dispatch on the plan's method."""
    if plan.method == "nap":
        return simulate_nap_spgemm(a, b, plan)
    return simulate_standard_spgemm(a, b, plan)
