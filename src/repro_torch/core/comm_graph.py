"""Standard and node-aware communication plans (paper Secs. 2.1, 4.1, 4.2).

The paper's sets, computed once in numpy "as the matrix is formed":

* standard:     ``P(r)`` (Eq. 8), ``D(r, t)`` (Eq. 9)
* node level:   ``N(n)`` (Eq. 13), ``E(n, m)`` (Eq. 14)
* distribution: ``T((p,n))`` (Eq. 15), ``U((p,n))`` (Eq. 16)
* inter-node:   ``G((p,n))`` (Eq. 17), ``I((p,n),(q,m))`` (Eq. 18)
* intra-node:   the on->off (Eqs. 19/20), off->on (21/22) and on->on
  (23/24) redistributions.

The sets communicate the *vector* indices ``j`` owned by the sender (the
semantics the paper's Example 2.1 tables use).  Inter-node slots pair
``"aligned"`` (the receiving local id q equals the sending local id p,
so the inter-node phase is one exchange over the node axis of the rank
grid; the device programs need it) or ``"balanced"`` (the paper's T/U
rule, which the float64 simulators take).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partition import RowPartition
from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class Message:
    """One point-to-point message: global vector indices ``idx`` from src to dst."""

    src: int
    dst: int
    idx: np.ndarray  # global vector (column) indices, ascending

    @property
    def size(self) -> int:
        return int(self.idx.size)


def flat_slot_map(msgs: Sequence[Message], slots: Sequence[int],
                  pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted lookup table from global index -> flat padded-buffer position.

    ``msgs[i]`` lands in buffer slot ``slots[i]``; element k of a message
    sits at flat position ``slots[i] * pad + k``.  Returns parallel arrays
    ``(idx, pos)`` with ``idx`` ascending.  Indices must be disjoint across
    the phase's messages (asserted).
    """
    if not msgs:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy()
    idx = np.concatenate([m.idx for m in msgs])
    pos = np.concatenate([s * pad + np.arange(m.size, dtype=np.int64)
                          for s, m in zip(slots, msgs)])
    order = np.argsort(idx, kind="stable")
    idx, pos = idx[order], pos[order]
    assert idx.size < 2 or (np.diff(idx) > 0).all(), \
        "phase delivers one index through two messages"
    return idx, pos


def lookup_slots(table: Tuple[np.ndarray, np.ndarray],
                 query: np.ndarray) -> np.ndarray:
    """Resolve ``query`` indices against a :func:`flat_slot_map` table."""
    idx, pos = table
    query = np.asarray(query, dtype=np.int64)
    p = np.searchsorted(idx, query)
    ok = (p < idx.size) & (idx[np.minimum(p, max(idx.size - 1, 0))] == query) \
        if idx.size else np.zeros(query.shape, bool)
    assert bool(np.all(ok)), \
        f"indices never delivered to this rank: {query[~ok][:8]}"
    return pos[p]


def _group_sorted(keys: np.ndarray, vals: np.ndarray) -> Dict[int, np.ndarray]:
    """{key: sorted unique vals with that key} for parallel arrays."""
    out: Dict[int, np.ndarray] = {}
    if keys.size == 0:
        return out
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    bounds = np.flatnonzero(np.diff(keys)) + 1
    for chunk_keys, chunk_vals in zip(np.split(keys, bounds), np.split(vals, bounds)):
        out[int(chunk_keys[0])] = np.unique(chunk_vals)
    return out


def _offproc_pairs(indptr: np.ndarray, indices: np.ndarray,
                   row_part: RowPartition, col_part: RowPartition
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row owner t, col owner r, col j) for every off-process nonzero, deduped."""
    n_rows = len(indptr) - 1
    rows = np.repeat(np.arange(n_rows), np.diff(indptr))
    cols = indices
    t = row_part.owner[rows]
    r = col_part.owner[cols]
    off = t != r
    t, r, j = t[off], r[off], cols[off]
    key = (t.astype(np.int64) * row_part.n_procs + r) * col_part.n_rows + j
    _, uniq = np.unique(key, return_index=True)
    return t[uniq], r[uniq], j[uniq]


def check_pairing(pairing: str, backend: str = "torch") -> None:
    """The device programs need ``"aligned"`` slot pairing (the exchange
    over the node axis); the host simulators (the simulate and moe
    backends) take both pairings."""
    if pairing not in ("aligned", "balanced"):
        raise ValueError(f"unknown pairing {pairing!r}; one of "
                         f"'aligned', 'balanced'")
    if pairing == "balanced" and backend not in ("simulate", "moe"):
        raise ValueError(
            f"backend={backend!r} runs pairing='aligned' only (its "
            f"inter-node exchange pairs slots over the node axis); "
            f"pairing='balanced', the paper's T/U rule, runs on "
            f"backend='simulate'")


@dataclasses.dataclass
class StandardPlan:
    """Algorithm 1's plan: ``P(r)`` and ``D(r, t)`` as message lists per
    rank.  ``partition`` is the ROW partition, ``col_partition`` the
    COLUMN/x partition (``None`` = square)."""

    topology: Topology
    partition: RowPartition
    sends: List[List[Message]]  # sends[r] = messages rank r sends
    recvs: List[List[Message]]  # recvs[t] = messages rank t receives
    col_partition: Optional[RowPartition] = None

    @property
    def col_part(self) -> RowPartition:
        return self.col_partition if self.col_partition is not None \
            else self.partition

    def P(self, r: int) -> List[int]:
        return [m.dst for m in self.sends[r]]

    def D(self, r: int, t: int) -> np.ndarray:
        for m in self.sends[r]:
            if m.dst == t:
                return m.idx
        return np.empty(0, dtype=np.int64)

    def recv_slot_map(self, rank: int, pad: int) -> Tuple[np.ndarray, np.ndarray]:
        """Slot map into rank's flat recv buffer (``[n_procs, pad]`` by src)."""
        msgs = self.recvs[rank]
        return flat_slot_map(msgs, [m.src for m in msgs], pad)


def build_standard_plan(indptr: np.ndarray, indices: np.ndarray,
                        part: RowPartition, topo: Topology,
                        col_part: Optional[RowPartition] = None,
                        pairs: Optional[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]] = None) -> StandardPlan:
    """One message from every owner r to every rank t that needs some of
    r's x entries, carrying exactly those indices (ascending).

    ``pairs`` supplies the deduped off-process triples ``(t, r, j)`` in
    place of extracting them from the structure (the multi-step plan
    splits one extraction between two sub-plans)."""
    cpart = part if col_part is None else col_part
    t, r, j = pairs if pairs is not None else \
        _offproc_pairs(indptr, indices, part, cpart)
    sends: List[List[Message]] = [[] for _ in range(topo.n_procs)]
    recvs: List[List[Message]] = [[] for _ in range(topo.n_procs)]
    for src in np.unique(r):
        mask = r == src
        for dst, idx in sorted(_group_sorted(t[mask], j[mask]).items()):
            msg = Message(src=int(src), dst=int(dst), idx=idx)
            sends[int(src)].append(msg)
            recvs[int(dst)].append(msg)
    return StandardPlan(topology=topo, partition=part, sends=sends,
                        recvs=recvs, col_partition=col_part)


@dataclasses.dataclass
class NAPPlan:
    """Node-aware plan.  ``partition`` is the ROW partition,
    ``col_partition`` the COLUMN/x partition (``None`` = square)."""

    topology: Topology
    partition: RowPartition
    node_dests: List[List[int]]                     # N(n)
    node_idx: Dict[Tuple[int, int], np.ndarray]     # E(n, m)
    T: List[List[int]]                              # T((p, n)) — dest nodes of rank
    U: List[List[int]]                              # U((p, n)) — src nodes of rank
    inter_sends: List[List[Message]]                # G/I — crosses the network
    inter_recvs: List[List[Message]]
    local_init_sends: List[List[Message]]           # on_node -> off_node
    local_init_recvs: List[List[Message]]
    local_final_sends: List[List[Message]]          # off_node -> on_node
    local_final_recvs: List[List[Message]]
    local_full_sends: List[List[Message]]           # on_node -> on_node
    local_full_recvs: List[List[Message]]
    col_partition: Optional[RowPartition] = None

    @property
    def col_part(self) -> RowPartition:
        return self.col_partition if self.col_partition is not None \
            else self.partition

    def recv_slot_map(self, rank: int, phase: str,
                      pad: int) -> Tuple[np.ndarray, np.ndarray]:
        """Slot map into rank's flat padded recv buffer for one phase.

        Received values lie as ``[n_slots, pad]`` per phase: slot = the
        sender's local id for "full", "init" and "final", and the sender's
        node id for "inter".
        """
        topo = self.topology
        msgs = {"full": self.local_full_recvs, "init": self.local_init_recvs,
                "final": self.local_final_recvs, "inter": self.inter_recvs}[phase][rank]
        slot_of = topo.node_of if phase == "inter" else topo.local_of
        return flat_slot_map(msgs, [slot_of(m.src) for m in msgs], pad)


def _distribute_slots(items: Sequence[Tuple[int, int]], ppn: int) -> List[List[Tuple[int, int]]]:
    """Deal (node, weight) items over ppn slots, balancing count and volume.

    Returns per slot a list of (node, chunk_id).  With fewer items than
    slots, heavy items split over several slots so every process sends
    (Sec. 4.1); with more, items go round-robin in descending weight.
    """
    slots: List[List[Tuple[int, int]]] = [[] for _ in range(ppn)]
    if not items:
        return slots
    ordered = sorted(items, key=lambda kv: (-kv[1], kv[0]))
    if len(ordered) >= ppn:
        for i, (node, _w) in enumerate(ordered):
            slots[i % ppn].append((node, 0))
        return slots
    n_items = len(ordered)
    extra = ppn - n_items
    weights = np.array([w for _, w in ordered], dtype=np.float64)
    shares = np.ones(n_items, dtype=np.int64)
    if weights.sum() > 0:
        frac = weights / weights.sum() * extra
        add = np.floor(frac).astype(np.int64)
        rem = extra - add.sum()
        order = np.argsort(-(frac - add), kind="stable")
        add[order[:rem]] += 1
        shares += add
    else:
        shares[:extra] += 1
    slot = 0
    for (node, _w), k in zip(ordered, shares):
        for c in range(int(k)):
            slots[slot].append((node, c))
            slot += 1
    return slots


def _chunk(arr: np.ndarray, k: int, c: int) -> np.ndarray:
    """c-th of k near-equal contiguous chunks of arr."""
    bounds = np.linspace(0, arr.size, k + 1).astype(np.int64)
    return arr[bounds[c] : bounds[c + 1]]


def build_nap_plan(indptr: np.ndarray, indices: np.ndarray, part: RowPartition,
                   topo: Topology, pairing: str = "aligned",
                   col_part: Optional[RowPartition] = None,
                   pairs: Optional[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]] = None) -> NAPPlan:
    """Build the node-aware plan.

    ``part`` is the row partition, ``col_part`` the column/x partition
    (defaults to ``part``: the paper's square case).  ``pairs`` supplies
    the deduped off-process triples ``(t, r, j)`` instead of extracting
    them from the structure (the multi-step plan hands over its
    high-duplication share).

    pairing:
      * ``"aligned"``  — the receiver's local id q equals the sender's
        local id p, so the inter-node phase is one exchange over the node
        axis (what the device programs run);
      * ``"balanced"`` — the paper's rule: send slots in descending-data
        order from p = 0, receive slots in descending-data order from
        p = ppn - 1.
    """
    if pairing not in ("balanced", "aligned"):
        raise ValueError(pairing)
    cpart = part if col_part is None else col_part
    ppn, n_nodes, n_procs = topo.ppn, topo.n_nodes, topo.n_procs
    t, r, j = pairs if pairs is not None else \
        _offproc_pairs(indptr, indices, part, cpart)
    tn = topo.node_of_array(t)  # receiver node m
    rn = topo.node_of_array(r)  # sender node n
    off_node = tn != rn

    # ---- N(n), E(n, m) ----------------------------------------------------
    node_idx: Dict[Tuple[int, int], np.ndarray] = {}
    node_dests: List[List[int]] = [[] for _ in range(n_nodes)]
    on_t, on_j = t[off_node], j[off_node]
    on_tn, on_rn = tn[off_node], rn[off_node]
    for n in np.unique(on_rn):
        mask = on_rn == n
        grouped = _group_sorted(on_tn[mask], on_j[mask])
        node_dests[int(n)] = sorted(grouped)
        for m, idx in grouped.items():
            node_idx[(int(n), int(m))] = idx

    # ---- T/U slot assignment: send slots by weight from p = 0 -------------
    send_eps: Dict[Tuple[int, int], List[int]] = {k: [] for k in node_idx}
    recv_eps: Dict[Tuple[int, int], List[int]] = {k: [] for k in node_idx}
    T: List[List[int]] = [[] for _ in range(n_procs)]
    U: List[List[int]] = [[] for _ in range(n_procs)]
    for n in range(n_nodes):
        items = [(m, int(node_idx[(n, m)].size)) for m in node_dests[n]]
        for p, slot in enumerate(_distribute_slots(items, ppn)):
            for (m, _c) in slot:
                send_eps[(n, m)].append(topo.rank(p, n))
                T[topo.rank(p, n)].append(m)
    if pairing == "aligned":
        for (n, m), senders in send_eps.items():
            for s in senders:
                q = topo.local_of(s)
                recv_eps[(n, m)].append(topo.rank(q, m))
                U[topo.rank(q, m)].append(n)
    else:
        # receive slots by weight too, the largest from p = ppn - 1 down
        node_srcs: List[List[int]] = [[] for _ in range(n_nodes)]
        for (n, m) in node_idx:
            node_srcs[m].append(n)
        for m in range(n_nodes):
            items = [(n, int(node_idx[(n, m)].size)) for n in sorted(node_srcs[m])]
            for q, slot in enumerate(_distribute_slots(items, ppn)[::-1]):
                for (n, _c) in slot:
                    recv_eps[(n, m)].append(topo.rank(q, m))
                    U[topo.rank(q, m)].append(n)

    # ---- realise inter-node messages (G / I) -------------------------------
    inter_sends: List[List[Message]] = [[] for _ in range(n_procs)]
    inter_recvs: List[List[Message]] = [[] for _ in range(n_procs)]
    rh_keys: List[np.ndarray] = []   # (m, j) -> rank holding j after "inter"
    rh_home: List[np.ndarray] = []
    for (n, m), idx in node_idx.items():
        senders = send_eps[(n, m)]
        receivers = recv_eps[(n, m)]
        k = max(len(senders), len(receivers), 1)
        for c in range(k):
            chunk = _chunk(idx, k, c)
            if chunk.size == 0:
                continue
            src = senders[c % len(senders)] if senders else topo.rank(0, n)
            dst = receivers[c % len(receivers)] if receivers else topo.rank(0, m)
            msg = Message(src=src, dst=dst, idx=chunk)
            inter_sends[src].append(msg)
            inter_recvs[dst].append(msg)
            rh_keys.append(m * np.int64(cpart.n_rows) + chunk)
            rh_home.append(np.full(chunk.size, dst, dtype=np.int64))

    def _emit(per_pair: Dict[int, np.ndarray], sends, recvs) -> None:
        for key in sorted(per_pair):
            src, dst = divmod(int(key), n_procs)
            msg = Message(src=src, dst=dst, idx=per_pair[key])
            sends[src].append(msg)
            recvs[dst].append(msg)

    # ---- local init redistribution (on_node -> off_node), Eqs. 19/20 ------
    local_init_sends: List[List[Message]] = [[] for _ in range(n_procs)]
    local_init_recvs: List[List[Message]] = [[] for _ in range(n_procs)]
    init_src, init_dst, init_j = [], [], []
    for rank in range(n_procs):
        for msg in inter_sends[rank]:
            owners = cpart.owner[msg.idx]
            off = owners != rank
            if off.any():
                init_src.append(owners[off])
                init_dst.append(np.full(int(off.sum()), rank, dtype=np.int64))
                init_j.append(msg.idx[off])
    if init_src:
        keys = np.concatenate(init_src) * n_procs + np.concatenate(init_dst)
        _emit(_group_sorted(keys, np.concatenate(init_j)),
              local_init_sends, local_init_recvs)

    # ---- local final redistribution (off_node -> on_node), Eqs. 21/22 -----
    local_final_sends: List[List[Message]] = [[] for _ in range(n_procs)]
    local_final_recvs: List[List[Message]] = [[] for _ in range(n_procs)]
    if rh_keys:
        rhk = np.concatenate(rh_keys)
        rhh = np.concatenate(rh_home)
        order = np.argsort(rhk, kind="stable")
        rhk, rhh = rhk[order], rhh[order]
        pair_keys = on_tn.astype(np.int64) * cpart.n_rows + on_j
        home = rhh[np.searchsorted(rhk, pair_keys)]
        mask = on_t != home
        if mask.any():
            keys = home[mask] * n_procs + on_t[mask]
            _emit(_group_sorted(keys, on_j[mask]),
                  local_final_sends, local_final_recvs)

    # ---- fully local (on_node -> on_node), Eqs. 23/24 ----------------------
    local_full_sends: List[List[Message]] = [[] for _ in range(n_procs)]
    local_full_recvs: List[List[Message]] = [[] for _ in range(n_procs)]
    same_node = ~off_node
    sn_t, sn_r, sn_j = t[same_node], r[same_node], j[same_node]
    if sn_t.size:
        keys = sn_r.astype(np.int64) * n_procs + sn_t
        _emit(_group_sorted(keys, sn_j), local_full_sends, local_full_recvs)

    return NAPPlan(
        topology=topo, partition=part, node_dests=node_dests, node_idx=node_idx,
        T=T, U=U,
        inter_sends=inter_sends, inter_recvs=inter_recvs,
        local_init_sends=local_init_sends, local_init_recvs=local_init_recvs,
        local_final_sends=local_final_sends, local_final_recvs=local_final_recvs,
        local_full_sends=local_full_sends, local_full_recvs=local_full_recvs,
        col_partition=col_part,
    )


@dataclasses.dataclass(frozen=True)
class PhaseStats:
    """max-over-ranks message count / bytes sent by a single process."""

    max_msgs: int
    max_bytes: int
    total_msgs: int
    total_bytes: int

    @staticmethod
    def of(msg_lists: List[List[Message]], bytes_per_val: int = 8) -> "PhaseStats":
        counts = [len(msgs) for msgs in msg_lists]
        sizes = [sum(m.size for m in msgs) * bytes_per_val for msgs in msg_lists]
        return PhaseStats(
            max_msgs=max(counts, default=0), max_bytes=max(sizes, default=0),
            total_msgs=sum(counts), total_bytes=sum(sizes),
        )


def standard_stats(plan: StandardPlan, bytes_per_val: int = 8) -> Dict[str, PhaseStats]:
    topo = plan.topology
    inter = [[m for m in msgs if not topo.same_node(m.src, m.dst)] for msgs in plan.sends]
    intra = [[m for m in msgs if topo.same_node(m.src, m.dst)] for msgs in plan.sends]
    return {
        "inter": PhaseStats.of(inter, bytes_per_val),
        "intra": PhaseStats.of(intra, bytes_per_val),
    }


def nap_stats(plan: NAPPlan, bytes_per_val: int = 8) -> Dict[str, PhaseStats]:
    intra = [a + b + c for a, b, c in zip(
        plan.local_init_sends, plan.local_full_sends, plan.local_final_sends)]
    return {
        "inter": PhaseStats.of(plan.inter_sends, bytes_per_val),
        "intra": PhaseStats.of(intra, bytes_per_val),
        "intra_init": PhaseStats.of(plan.local_init_sends, bytes_per_val),
        "intra_full": PhaseStats.of(plan.local_full_sends, bytes_per_val),
        "intra_final": PhaseStats.of(plan.local_final_sends, bytes_per_val),
    }
