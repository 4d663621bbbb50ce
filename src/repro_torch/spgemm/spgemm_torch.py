"""Node-aware distributed SpGEMM on one device: host compile + the
rank-batched program.

It stands to :mod:`repro_torch.spgemm.plan` as
:mod:`repro_torch.core.spmv_torch` stands to the SpMV plans.

**Host compile.**  :func:`compile_spgemm` turns the :class:`SpGemmPlan`
into static arrays stacked over ranks, equal to the JAX package's: per
phase the value send maps (every message slot carries the concatenated
CSR values of the B rows it names, padded to the phase's value budget),
and the row expansion of the local products: for every product
``a_ik * b_kj`` its position in the packed value domain
``[b_loc | full | inter | final]`` (``[b_loc | pair]`` for the standard
plan), its output slot among the rank's merged C nonzeros, and ``a_ik``.
C's structure is merged on the host, so the device program computes
values only; B's structure never moves at run time.

**Device program.**  :func:`spgemm_program` runs the ranks as the leading
batch axis of one device, as the SpMV programs do: the four node-aware
exchanges are the same axis permutations (``full`` and ``init`` over
``proc``, ONE aggregated ``inter`` over ``node`` from ``[b_loc |
init]``, ``final`` over ``proc``), then every rank's products are one
gather of the domain and one ``index_add_`` into its C slots, batched
over ranks through flat int64 indices.  The standard plan's flat
exchange runs from its live value slots (the literal ``[P, P, vpad]``
table is nearly all padding).  ``dtype`` is
``torch.float32`` (the default) or ``torch.float64``.  ``index_add_`` on
CUDA sums with atomics, so float32 sums may differ in their last bits
from run to run; the float64 simulate backend of
:mod:`repro_torch.spgemm.simulate` is the bit-for-bit oracle.

``integrity=True`` is the instrumented program (the SpMV programs'
:class:`repro_torch.core.spmv_torch._Wire`): every value-block message is
checksummed by its sender before the scripted fault boundary and again
by its receiver, and ``run(b_shards, fault_spec)`` returns ``(c_shards,
chk)`` as :func:`repro_torch.core.integrity.verify_wire` reads it.  It
runs the literal exchanges, whose messages are the reference's (the
standard plan's literal pair table included).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.integrity import (IntegrityError, NAP_MESSAGE_PHASES,
                                        build_fault_spec, message_phases,
                                        verify_wire)
from repro_torch.core.partition import RowPartition
from repro_torch.core.spmv_torch import _exchanged, _gather, _Staged, _Wire
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.mesh.comm import node_all_to_all, proc_all_to_all, rank_all_to_all
from repro_torch.sparse.csr import CSR
from repro_torch.spgemm.plan import (SpGemmPlan, build_spgemm_plan,
                                     expand_positions, local_value_index,
                                     lookup_row_starts, message_value_size)
from repro_torch.spgemm.simulate import simulate_spgemm

# runs of the device SpGEMM program in this process: callers assert that
# products went through it (not the host product or the simulators)
_RUN_COUNTER = {"runs": 0}


def torch_spgemm_runs() -> int:
    """How many times the device SpGEMM program has run in this process."""
    return _RUN_COUNTER["runs"]


#: payload dtypes of the device program and their host twins
_HOST_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _torch_dtype(dtype) -> torch.dtype:
    """None -> float32; else torch.float32 or torch.float64."""
    if dtype is None:
        return torch.float32
    if dtype not in _HOST_DTYPE:
        raise ValueError(f"SpGEMM payloads are torch.float32 or torch.float64, "
                         f"got {dtype!r}")
    return dtype


@dataclasses.dataclass
class CompiledSpGemm(_Staged):
    """Static arrays of the distributed SpGEMM, stacked over ranks.

    ``arrays`` holds the per-phase value send maps and the expansion
    triple (``exp_pos`` into the packed value domain, ``exp_out`` the C
    slot, ``exp_a`` the A value, float64); ``c_rows`` / ``c_cols`` /
    ``c_nnz`` the host C structure the global CSR is assembled from.
    :meth:`tensors` stages the arrays on ``device`` once per name; the
    staged tensors live as long as this object (the compile cache keeps
    :meth:`unstaged` copies, host arrays only).
    """

    topo: Topology
    row_part: RowPartition
    mid_part: RowPartition
    shape: Tuple[int, int]
    method: str
    b_nnz_pad: int
    vpads: Dict[str, int]
    exp_pad: int
    c_nnz_pad: int
    arrays: Dict[str, np.ndarray]
    c_rows: List[np.ndarray]          # per rank: global C row ids (merged)
    c_cols: List[np.ndarray]          # per rank: C col ids (merged, row-major)
    c_nnz: List[int]
    device: torch.device
    plan: Optional[SpGemmPlan] = None
    # the standard plan's live-slot exchange (ensure_live_pair)
    live_pad: int = 0
    _tensors: Dict[object, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def unstaged(self) -> "CompiledSpGemm":
        """A copy that shares the host arrays and has nothing staged on
        the device (arrays added later, as by :meth:`ensure_live_pair`,
        stay with the copy that adds them)."""
        return dataclasses.replace(self, arrays=dict(self.arrays), _tensors={})

    def exp_a(self, dtype: torch.dtype) -> torch.Tensor:
        """``exp_a`` as a flat ``[P * exp_pad]`` tensor of ``dtype``, staged
        once per dtype (cast on the host, as the reference casts it)."""
        key = ("exp_a", dtype)
        if key not in self._tensors:
            host = self.arrays["exp_a"].astype(_HOST_DTYPE[dtype])
            self._tensors[key] = torch.from_numpy(host.reshape(-1)).to(self.device)
        return self._tensors[key]

    def pair_value_counts(self) -> np.ndarray:
        """``[P_src, P_dst]`` live values of each standard message."""
        p = self.topo.n_procs
        k = np.zeros((p, p), dtype=np.int64)
        for s, msgs in enumerate(self.plan.comm.sends):
            for m in msgs:
                k[s, m.dst] = message_value_size(m, self.plan.b_counts)
        return k

    def ensure_live_pair(self) -> None:
        """Emit the live-slot form of the standard exchange (lazily, once).

        Each rank's live values land compacted, sender by sender, in a
        ``[live_pad]`` recv buffer: ``pair_live_src`` is each value's flat
        position in the rank-batched ``b_loc``, ``pair_live_dst`` its flat
        position in the rank-batched recv buffer, and ``exp_pos_live`` is
        ``exp_pos`` with the recv positions moved onto the compact buffer.
        """
        if "exp_pos_live" in self.arrays:
            return
        p, vpad, lb = self.topo.n_procs, self.vpads["pair"], self.b_nnz_pad
        k = self.pair_value_counts().T                     # [r, s]
        start = np.cumsum(k, axis=1) - k                   # sender s within r
        self.live_pad = max(1, int(k.sum(1).max()))
        r, s = np.nonzero(k)
        cnt = k[r, s]
        t = expand_positions(np.zeros(r.size, dtype=np.int64), cnt)
        r, s = np.repeat(r, cnt), np.repeat(s, cnt)
        self.arrays["pair_live_src"] = (
            s * lb + self.arrays["send_v"][s, r, t].astype(np.int64))
        self.arrays["pair_live_dst"] = r * self.live_pad + start[r, s] + t
        pos = self.arrays["exp_pos"].astype(np.int64)
        q = pos - lb
        recv = q >= 0
        rank = np.broadcast_to(np.arange(p)[:, None], pos.shape)
        qs = np.where(recv, q, 0)
        live = lb + start[rank, qs // vpad] + qs % vpad
        self.arrays["exp_pos_live"] = np.where(recv, live, pos).astype(np.int32)


_SPGEMM_CACHE: Dict[tuple, CompiledSpGemm] = {}
_SPGEMM_CACHE_MAX = 8


def clear_spgemm_cache() -> None:
    _SPGEMM_CACHE.clear()


def _spgemm_cache_key(a: CSR, b: CSR, row_part: RowPartition,
                      mid_part: RowPartition, topo: Topology,
                      method: str) -> tuple:
    h = hashlib.sha1()
    # A's values are baked into the expansion arrays; B's values are a
    # runtime input, so only B's STRUCTURE keys the compiled program.
    for arr in (a.indptr, a.indices, a.data, b.indptr, b.indices,
                row_part.owner, mid_part.owner):
        h.update(np.ascontiguousarray(arr).tobytes())
    return (method, h.hexdigest(), a.shape, b.shape, topo.n_nodes, topo.ppn)


def compile_spgemm(a: CSR, b: CSR, row_part: RowPartition,
                   mid_part: RowPartition, topo: Topology,
                   method: str = "nap", plan: Optional[SpGemmPlan] = None,
                   cache: bool = True,
                   device: DeviceLike = None) -> CompiledSpGemm:
    """Compile the SpGEMM plan into static rank-stacked arrays.

    Builds (or accepts) the :class:`SpGemmPlan`, resolves every B row a
    rank consumes to its position in the packed value domain, expands
    the local products and merges C's structure, all bulk numpy; cached
    on the structure of A and B, A's values, the partitions, the
    topology and ``device``.  The arrays are the JAX package's.  The
    cache holds host arrays only: every call returns its own
    :meth:`CompiledSpGemm.unstaged` copy, whose device tensors are freed
    with it.
    """
    device = resolve_device(device)
    key = None
    if plan is None and cache:
        key = _spgemm_cache_key(a, b, row_part, mid_part, topo, method) \
            + (str(device),)
        hit = _SPGEMM_CACHE.pop(key, None)
        if hit is not None:
            _SPGEMM_CACHE[key] = hit
            return hit.unstaged()
    if plan is None:
        plan = build_spgemm_plan(a, b, row_part, mid_part, topo,
                                 method=method)
    assert plan.method == method
    comm = plan.comm
    n_procs, ppn, n_nodes = topo.n_procs, topo.ppn, topo.n_nodes
    b_counts = plan.b_counts
    lvi = local_value_index(mid_part, b_counts)
    owner = mid_part.owner
    b_nnz_pad = max(1, int(mid_part_value_counts(mid_part, b_counts).max()))
    vpads = plan.value_pads()

    # the send maps are written in place into their stacked arrays
    if method == "nap":
        send_shapes = {"full_send_v": (ppn, vpads["full"]),
                       "init_send_v": (ppn, vpads["init"]),
                       "inter_gather_v": (n_nodes, vpads["inter"]),
                       "final_send_v": (ppn, vpads["final"])}
    else:
        send_shapes = {"send_v": (n_procs, vpads["pair"])}
    arrays: Dict[str, np.ndarray] = {
        k: np.zeros((n_procs,) + shape, dtype=np.int32)
        for k, shape in send_shapes.items()}

    def send_map(out: np.ndarray, msgs, slot_of, base_of) -> None:
        for m in msgs:
            pos = expand_positions(base_of(m.idx), b_counts[m.idx])
            out[slot_of(m), : pos.size] = pos

    per_rank: Dict[str, List[np.ndarray]] = {k: [] for k in (
        "exp_pos", "exp_out", "exp_a")}
    c_rows: List[np.ndarray] = []
    c_cols: List[np.ndarray] = []
    c_nnz: List[int] = []

    if method == "nap":
        off_full = b_nnz_pad
        off_inter = off_full + ppn * vpads["full"]
        off_final = off_inter + n_nodes * vpads["inter"]
        domain_len = off_final + ppn * vpads["final"]
    else:
        off_recv = b_nnz_pad
        domain_len = off_recv + n_procs * vpads["pair"]

    def loc_base(idx: np.ndarray) -> np.ndarray:
        return lvi[idx]

    for r in range(n_procs):
        if method == "nap":
            send_map(arrays["full_send_v"][r], comm.local_full_sends[r],
                     lambda m: topo.local_of(m.dst), loc_base)
            send_map(arrays["init_send_v"][r], comm.local_init_sends[r],
                     lambda m: topo.local_of(m.dst), loc_base)

            init_map = plan.recv_value_map(r, "init", vpads["init"])

            def inter_base(idx: np.ndarray) -> np.ndarray:
                own = owner[idx] == r
                base = np.empty(idx.size, dtype=np.int64)
                base[own] = lvi[idx[own]]
                if not own.all():
                    base[~own] = b_nnz_pad + lookup_row_starts(
                        init_map, idx[~own])
                return base

            send_map(arrays["inter_gather_v"][r], comm.inter_sends[r],
                     lambda m: topo.node_of(m.dst), inter_base)

            inter_map = plan.recv_value_map(r, "inter", vpads["inter"])
            send_map(arrays["final_send_v"][r], comm.local_final_sends[r],
                     lambda m: topo.local_of(m.dst),
                     lambda idx: lookup_row_starts(inter_map, idx))

            full_map = plan.recv_value_map(r, "full", vpads["full"])
            final_map = plan.recv_value_map(r, "final", vpads["final"])
            # combined off-node row -> domain start (inter buffer when this
            # rank is the row's home, final buffer otherwise; disjoint)
            comb_rows = np.concatenate([inter_map[0], final_map[0]])
            comb_starts = np.concatenate([off_inter + inter_map[1],
                                          off_final + final_map[1]])
            order = np.argsort(comb_rows, kind="stable")
            comb = (comb_rows[order], comb_starts[order])
            assert comb[0].size < 2 or (np.diff(comb[0]) > 0).all(), \
                "off-node B row delivered through two phases"

            def domain_base(k: np.ndarray) -> np.ndarray:
                own = owner[k] == r
                on_node = (~own) & (topo.node_of_array(owner[k])
                                    == topo.node_of(r))
                off = ~(own | on_node)
                base = np.empty(k.size, dtype=np.int64)
                base[own] = lvi[k[own]]
                if on_node.any():
                    base[on_node] = off_full + lookup_row_starts(
                        full_map, k[on_node])
                if off.any():
                    base[off] = lookup_row_starts(comb, k[off])
                return base
        else:
            send_map(arrays["send_v"][r], comm.sends[r], lambda m: m.dst,
                     loc_base)
            pair_map = plan.recv_value_map(r, "pair", vpads["pair"])

            def domain_base(k: np.ndarray) -> np.ndarray:
                own = owner[k] == r
                base = np.empty(k.size, dtype=np.int64)
                base[own] = lvi[k[own]]
                if not own.all():
                    base[~own] = off_recv + lookup_row_starts(
                        pair_map, k[~own])
                return base

        # -- row expansion + C structure merge (per rank, bulk numpy) --------
        g_rows = row_part.rows_of(r)
        ai, ak, av = a.select_rows(g_rows).to_coo()
        counts = b_counts[ak] if ak.size else np.empty(0, dtype=np.int64)
        pos = expand_positions(domain_base(ak) if ak.size
                               else np.empty(0, dtype=np.int64), counts)
        b_take = expand_positions(plan.b_indptr[ak] if ak.size
                                  else np.empty(0, dtype=np.int64), counts)
        cols_exp = plan.b_indices[b_take]
        rows_exp = np.repeat(ai, counts)
        a_exp = np.repeat(av, counts)
        key_exp = rows_exp * np.int64(plan.shape[1]) + cols_exp
        uniq, exp_out = np.unique(key_exp, return_inverse=True)
        per_rank["exp_pos"].append(pos.astype(np.int32))
        per_rank["exp_out"].append(exp_out.astype(np.int32))
        per_rank["exp_a"].append(a_exp)
        c_rows.append(g_rows[(uniq // plan.shape[1]).astype(np.int64)])
        c_cols.append((uniq % plan.shape[1]).astype(np.int64))
        c_nnz.append(int(uniq.size))

    assert domain_len < np.iinfo(np.int32).max

    exp_pad = max(1, max(p.size for p in per_rank["exp_pos"]))
    c_nnz_pad = max(1, max(c_nnz))

    def stack(name: str, dtype=np.int32) -> None:
        out = np.zeros((n_procs, exp_pad), dtype=dtype)
        for r, arr in enumerate(per_rank.pop(name)):
            out[r, : arr.size] = arr
        arrays[name] = out

    stack("exp_pos")
    stack("exp_out")
    stack("exp_a", dtype=np.float64)

    compiled = CompiledSpGemm(
        topo=topo, row_part=row_part, mid_part=mid_part, shape=plan.shape,
        method=method, b_nnz_pad=b_nnz_pad, vpads=vpads, exp_pad=exp_pad,
        c_nnz_pad=c_nnz_pad, arrays=arrays, c_rows=c_rows, c_cols=c_cols,
        c_nnz=c_nnz, device=device, plan=plan)
    if key is not None:
        while len(_SPGEMM_CACHE) >= _SPGEMM_CACHE_MAX:
            _SPGEMM_CACHE.pop(next(iter(_SPGEMM_CACHE)))
        _SPGEMM_CACHE[key] = compiled.unstaged()
    return compiled


def mid_part_value_counts(mid_part: RowPartition,
                          b_counts: np.ndarray) -> np.ndarray:
    """Total B values owned per rank (the b_loc shard lengths)."""
    out = np.zeros(mid_part.n_procs, dtype=np.int64)
    for r in range(mid_part.n_procs):
        rows = mid_part.rows_of(r)
        out[r] = int(b_counts[rows].sum()) if rows.size else 0
    return out


def pack_b_values(b: CSR, compiled: CompiledSpGemm, dtype) -> np.ndarray:
    """B values -> [n_nodes, ppn, b_nnz_pad] shards (rows concatenated in
    ascending-row order per owner, matching :func:`local_value_index`)."""
    topo, part = compiled.topo, compiled.mid_part
    out = np.zeros((topo.n_procs, compiled.b_nnz_pad), dtype=dtype)
    counts = np.diff(b.indptr)
    for r in range(topo.n_procs):
        rows = part.rows_of(r)
        if rows.size:
            take = expand_positions(b.indptr[rows], counts[rows])
            out[r, : take.size] = b.data[take]
    return out.reshape(topo.n_nodes, topo.ppn, compiled.b_nnz_pad)


def unpack_c_values(c_shards, compiled: CompiledSpGemm) -> CSR:
    """Per-rank C value shards -> the global C CSR (host structure +
    device values).  Per-rank slots beyond ``c_nnz[r]`` are padding."""
    topo = compiled.topo
    if isinstance(c_shards, torch.Tensor):
        c_shards = c_shards.cpu().numpy()
    w = np.asarray(c_shards).reshape(topo.n_procs, -1)
    rows = np.concatenate(compiled.c_rows) if compiled.c_rows else \
        np.empty(0, dtype=np.int64)
    cols = np.concatenate(compiled.c_cols) if compiled.c_cols else \
        np.empty(0, dtype=np.int64)
    vals = np.concatenate([w[r, : compiled.c_nnz[r]].astype(np.float64)
                           for r in range(topo.n_procs)]) if rows.size else \
        np.empty(0, dtype=np.float64)
    # per-rank structure is merged and row-major; the global from_coo is a
    # pure re-sort across ranks (each C row lives on exactly one rank)
    return CSR.from_coo(rows, cols, vals, compiled.shape,
                        sum_duplicates=False)


def _domain(c: CompiledSpGemm, b: torch.Tensor,
            wire: Optional[_Wire]) -> Tuple[torch.Tensor, str]:
    """Every rank's packed value domain ``[P, L, 1]`` after the exchanges
    of ``b [P, b_nnz_pad, 1]``, and the name of the positions into it.
    The standard plan exchanges its live value slots, or with ``wire``
    (the instrumented program) its literal pair table."""
    topo, p = c.topo, c.topo.n_procs
    if c.method == "nap":
        proc = functools.partial(proc_all_to_all, ppn=topo.ppn)
        node = functools.partial(node_all_to_all, topo=topo)
        # Phases A+B: intra-node row-block exchanges over "proc".
        full = _exchanged(wire, "full", _gather(c, b, "full_send_v"), proc)
        init = _exchanged(wire, "init", _gather(c, b, "init_send_v"), proc)
        # Phase C: ONE aggregated inter-node exchange over "node".
        staged = torch.cat([b, init.reshape(p, -1, 1)], dim=1)
        del init
        inter = _exchanged(wire, "inter", _gather(c, staged, "inter_gather_v"),
                           node).reshape(p, -1, 1)
        del staged
        # Phase D: intra-node scatter of the aggregated rows.
        final = _exchanged(wire, "final", _gather(c, inter, "final_send_v"), proc)
        return torch.cat([b, full.reshape(p, -1, 1), inter,
                          final.reshape(p, -1, 1)], dim=1), "exp_pos"
    if wire is None:
        # the flat exchange of the live value slots only: each value from
        # its sender's b_loc straight into the receiver's compact buffer
        c.ensure_live_pair()
        t = c.tensors(["pair_live_src", "pair_live_dst"])
        recv = torch.zeros(p * c.live_pad, dtype=b.dtype, device=b.device)
        recv.index_copy_(0, t["pair_live_dst"],
                         b.reshape(-1).index_select(0, t["pair_live_src"]))
        return torch.cat([b, recv.reshape(p, -1, 1)], dim=1), "exp_pos_live"
    # the literal flat exchange over ("node", "proc") of [P, P, vpad] slots
    recv = _exchanged(wire, "pair", _gather(c, b, "send_v"), rank_all_to_all)
    return torch.cat([b, recv.reshape(p, -1, 1)], dim=1), "exp_pos"


def _merge(c: CompiledSpGemm, domain: torch.Tensor, pos_name: str,
           dtype: torch.dtype) -> torch.Tensor:
    """csr_matmul's row expansion and duplicate merge, every rank at
    once: ``c[exp_out] += exp_a * domain[exp_pos]`` -> ``[nn, ppn, c_nnz_pad]``."""
    topo = c.topo
    vals = domain.reshape(-1).index_select(0, c.flat_index(pos_name, domain.shape[1]))
    vals.mul_(c.exp_a(dtype))
    out = torch.zeros(topo.n_procs * c.c_nnz_pad, dtype=dtype, device=domain.device)
    out.index_add_(0, c.flat_index("exp_out", c.c_nnz_pad), vals)
    return out.reshape(topo.n_nodes, topo.ppn, c.c_nnz_pad)


def spgemm_program(compiled: CompiledSpGemm, dtype=None,
                   integrity: bool = False):
    """The rank-batched SpGEMM: ``run(b_shards) -> c_shards``.

    ``b_shards`` is ``[n_nodes, ppn, b_nnz_pad]`` (:func:`pack_b_values`;
    numpy or a tensor), the result ``[n_nodes, ppn, c_nnz_pad]`` per-rank
    C values in the compiled structure's order, on the plan's device, in
    ``dtype`` (``torch.float32`` by default, or ``torch.float64``).

    ``integrity=True`` builds the instrumented program (module
    docstring): ``run(b_shards, fault_spec)`` with the ``[n_nodes, ppn,
    n_phases, 4]`` spec of :func:`repro_torch.core.integrity.build_fault_spec`
    returns ``(c_shards, chk)``, ``chk`` int64 ``[n_nodes, ppn,
    n_msg_phases, 2, max_slots]`` of uint32 values.
    """
    dt = _torch_dtype(dtype)
    c = compiled
    topo = c.topo
    nap = c.method == "nap"
    max_slots = max(topo.ppn, topo.n_nodes) if nap else topo.n_procs
    phases = NAP_MESSAGE_PHASES if nap else ("pair",)

    def stage(b_shards) -> torch.Tensor:
        b = torch.as_tensor(b_shards).to(device=c.device, dtype=dt)
        return b.reshape(topo.n_procs, c.b_nnz_pad, 1)

    if not integrity:
        def run(b_shards) -> torch.Tensor:
            _RUN_COUNTER["runs"] += 1
            domain, pos = _domain(c, stage(b_shards), None)
            return _merge(c, domain, pos, dt)
    else:
        def run(b_shards, fault_spec):
            _RUN_COUNTER["runs"] += 1
            wire = _Wire(torch.as_tensor(np.asarray(fault_spec)).to(c.device),
                         c.method)
            domain, pos = _domain(c, stage(b_shards), wire)
            return _merge(c, domain, pos, dt), wire.chk(c, phases, max_slots)

    run.method = c.method
    run.integrity = bool(integrity)
    return run


def distributed_spgemm(a: CSR, b: CSR, row_part: RowPartition,
                       mid_part: RowPartition, topo: Topology, *,
                       method: str = "nap", backend: str = "torch",
                       device: DeviceLike = None, dtype=None,
                       cache: bool = True, integrity: str = "off",
                       faults=(), report: Optional[dict] = None) -> CSR:
    """One-call distributed ``C = A @ B``.

    ``backend="simulate"`` runs the exact float64 message-passing oracle
    on the host (bit-for-bit equal to
    :func:`repro_torch.amg.matmul.csr_matmul`); ``"torch"`` compiles and
    runs the device program on ``device`` (CUDA by default; raises
    without it unless ``device="cpu"``), in float32 payloads unless
    ``dtype=torch.float64``.

    ``integrity="detect"`` runs the checksum-instrumented program and
    raises :class:`repro_torch.core.integrity.IntegrityError` with phase
    and message attribution when a value-exchange payload arrives
    different from what its sender packed; ``"recover"`` retries the
    product once with the fault boundary cleared (the scripted
    :class:`repro_torch.core.integrity.MessageFault` s in ``faults``, on
    this method's exchange phases, forward direction, fire on the first
    run only, so a recovered product is bit-identical to the fault-free
    run).  Pass a dict as ``report`` to receive the check counters.
    Integrity runs on the device backend only: the simulate backend is
    the bit-exact oracle the checks are calibrated against.
    """
    if integrity not in ("off", "detect", "recover"):
        raise ValueError(f"integrity must be 'off'|'detect'|'recover', "
                         f"got {integrity!r}")
    if faults and integrity == "off":
        raise ValueError("scripted message faults need "
                         "integrity='detect'|'recover'")
    if integrity != "off" and backend != "torch":
        raise ValueError("integrity-checked SpGEMM runs on the torch backend "
                         "only (the simulate backend is the bit-exact oracle "
                         "the checks are calibrated against)")
    if backend == "simulate":
        plan = build_spgemm_plan(a, b, row_part, mid_part, topo,
                                 method=method)
        return simulate_spgemm(a, b, plan)
    if backend != "torch":
        raise ValueError(f"backend must be 'torch'|'simulate', "
                         f"got {backend!r}")
    for f in faults:
        if f.direction not in ("any", "forward"):
            raise ValueError("SpGEMM message faults are forward-only "
                             "(the product has no transpose exchange)")
        if f.phase == "compute":
            raise ValueError("SpGEMM integrity covers the value exchanges; "
                             "compute-side faults belong to the SpMV "
                             "operators' ABFT check")
    dt = _torch_dtype(dtype)
    compiled = compile_spgemm(a, b, row_part, mid_part, topo, method=method,
                              cache=cache, device=device)
    b_shards = pack_b_values(b, compiled, _HOST_DTYPE[dt])
    if integrity == "off":
        run = spgemm_program(compiled, dtype=dt)
        return unpack_c_values(run(b_shards), compiled)

    run = spgemm_program(compiled, dtype=dt, integrity=True)
    spec = build_fault_spec(topo, faults, method)
    phases = message_phases(method)
    counters = {"wire_checks": topo.n_procs * len(phases),
                "wire_mismatches": 0, "faults_injected": len(list(faults)),
                "retries": 0, "recovered": 0}
    c_shards, chk = run(b_shards, spec)
    mism = verify_wire(chk.cpu().numpy(), phases, topo.ppn, "forward")
    if mism:
        counters["wire_mismatches"] = len(mism)
        if integrity == "detect":
            if report is not None:
                report.update(counters)
            raise IntegrityError(
                f"{len(mism)} integrity mismatch(es) in distributed "
                f"SpGEMM: " + "; ".join(str(m) for m in mism), mism)
        counters["retries"] = 1
        c_shards, chk = run(b_shards, np.zeros_like(spec))
        again = verify_wire(chk.cpu().numpy(), phases, topo.ppn, "forward")
        if again:
            if report is not None:
                report.update(counters)
            raise IntegrityError(
                "integrity mismatch persisted through the clean SpGEMM "
                "retry: " + "; ".join(str(m) for m in again), again)
        counters["recovered"] = 1
    if report is not None:
        report.update(counters)
    return unpack_c_values(c_shards, compiled)
