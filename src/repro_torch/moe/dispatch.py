"""MoE token dispatch: the expert-parallel island and the operator entry.

Two faces, as in ``repro/moe/dispatch.py``:

* :func:`moe_apply_sharded`, the island: a rank-batched program over the
  expert-parallel mesh ``(n_pods, n_inner)``, whose chips are the leading
  axis of every buffer on one device (chip ``c = pod * n_inner +
  inner``).  ``flat`` (Algorithm-1 analogue) ships every (token,
  expert-choice) copy through one capacity-padded all-to-all over all
  chips; ``nap`` (Algorithms 2 + 3) ships a token to each remote pod
  once, carrying only the choices that live there, through ONE
  aggregated pod all-to-all, then fans it out inside the pod, and
  combines back along the reversed route; ``auto`` resolves per
  geometry from the modeled inter-pod bytes of
  :func:`repro_torch.moe.plan.choose_dispatch`.  The exchanges go
  through :mod:`repro_torch.mesh.comm`: the flat all-to-all is
  ``rank_all_to_all``, the pod one ``node_all_to_all``, the fan-out and
  gather-back ``proc_all_to_all``; the reference's closing all-gather
  over the inner axis is a reshape.  Given a
  :class:`~repro_torch.mesh.buffers.ProcessMesh`, a process runs its
  block of whole pods (its batch shard, its experts) and the pod and
  flat exchanges cross processes.
* :func:`dispatch_operator`: a concrete routing compiled into the
  ``backend="moe"`` executors (host float64 simulators): ``op @ x`` the
  weighted dispatch-sum ``R @ X``, ``op.T @ y`` the combine ``R.T @ Y``.

Wire quantization (``cfg.wire_dtype``, :mod:`repro_torch.moe.wire`)
encodes the token payload once at the pack boundary, ships the words
through every hop (the nap relay forwards them without re-rounding)
and decodes on the receive side; the combine re-encodes at each
re-accumulation point (expert outputs, the pod gateway's gather-back),
so nap pays up to 2 combine hops and flat 1.  A payload crosses every
exchange as ``uint8`` words (a bitcast, for every wire dtype): no
collective may widen or refuse it.  ``wire_dtype="f32"`` casts
nothing: the dispatch ships the model dtype and the combine float32.

The island is differentiable on the f32 wire.  Each exchange is an
``autograd.Function`` whose backward is the same exchange applied to the
gradient: every tiled exchange here is a permutation that is its own
inverse (``proc_all_to_all`` swaps axes 1 and 2, ``node_all_to_all`` the
node axes, ``rank_all_to_all`` the two rank axes), so its adjoint is
itself.  Backward messages carry their payload's label with ``:grad``
(``"node:tokens:grad"``), so the forward's counted bytes stay apart.  The
meta exchange ships ids and router weights in one int32 payload and
returns the weights differentiable, their gradient going back through
the same exchange.  Dropped copies get zero gradient.  A narrow wire
raises under grad: the reference pins its narrow words by a bitcast,
through which ``jax.grad`` is zero.

Buffers are capacity-padded; FIFO slots come from cumulative sums and a
copy past its capacity is dropped (standard MoE token dropping).  A
scatter that drops is a gather here: each slot's source row is found by
scattering row indices into a table with one spare "dump" slot, sliced
off, and the rows are then gathered (an empty slot reads a zero row).
Matmuls run one pod at a time, so a pod's arithmetic does not depend on
how many pods a process holds.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.topology import Topology
from repro_torch.mesh.buffers import ProcessMesh
from repro_torch.mesh.comm import (node_all_to_all, proc_all_to_all,
                                   rank_all_to_all)
from repro_torch.moe.plan import (DISPATCH_MODES, choose_dispatch,
                                  dispatch_partitions, representative_routing,
                                  routing_matrix)
from repro_torch.moe.wire import (check_wire_dtype, decode_torch,
                                  encode_torch, torch_wire_dtype)

__all__ = [
    "EPInfo", "moe_apply_sharded", "dispatch_operator",
    "resolve_dispatch_mode", "topology_of_mesh", "island_pods",
    "check_island_batch",
]


# ---------------------------------------------------------------------------
# expert-parallel geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EPInfo:
    """Which axes hold experts, (outer, inner) = (pod, model).  With
    ``pod_axis=None`` the island is one pod and nap degenerates to flat."""

    inner_axis: str = "model"
    pod_axis: Optional[str] = None

    @property
    def manual_axes(self) -> Tuple[str, ...]:
        return ((self.pod_axis,) if self.pod_axis else ()) + (self.inner_axis,)


def topology_of_mesh(mesh, ep: Optional[EPInfo] = None) -> Topology:
    """The plan layer's Topology of an expert-parallel mesh: one node per
    pod, ``ppn`` inner chips.  ``mesh`` is a :class:`Topology` or a
    :class:`ProcessMesh` (its whole topology); without a pod axis the
    island is one pod of ``ppn`` chips."""
    ep = ep or EPInfo(inner_axis="model", pod_axis="pod")
    topo = mesh.topo if isinstance(mesh, ProcessMesh) else mesh
    if not isinstance(topo, Topology):
        raise TypeError(f"mesh must be a Topology or a ProcessMesh, got "
                        f"{type(mesh).__name__}")
    return Topology(n_nodes=topo.n_nodes if ep.pod_axis else 1, ppn=topo.ppn)


# ---------------------------------------------------------------------------
# router, shared experts, slots, expert compute
# ---------------------------------------------------------------------------

def _router(p, cfg, x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights [T, K] float32, expert ids [T, K] int64): the normalized
    top-k of the float32 softmax."""
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids


def _shared_ffn(p, x: torch.Tensor) -> torch.Tensor:
    s = p["shared"]
    return (F.silu(x @ s["w_gate"]) * (x @ s["w_up"])) @ s["w_down"]


def _fifo_slots(need: torch.Tensor, capacity: int, dim: int = 0) -> torch.Tensor:
    """need (bool) -> its FIFO slot along ``dim`` in [0, capacity), or
    ``capacity`` where it is not needed or overflows (dropped)."""
    slots = torch.cumsum(need.to(torch.int64), dim=dim) - 1
    return torch.where(need & (slots < capacity), slots,
                       torch.full_like(slots, capacity))


def _slot_sources(dest: torch.Tensor, size: int) -> torch.Tensor:
    """Invert a slot assignment: ``dest [..., N]`` (positions in
    ``[0, size)``) -> ``src [..., size]``, the row that fills each
    position, ``N`` where none does.  Rows share a dump position only when
    the caller slices it off."""
    n = dest.shape[-1]
    src = torch.full(dest.shape[:-1] + (size,), n, dtype=torch.int64,
                     device=dest.device)
    rows = torch.arange(n, device=dest.device).expand(dest.shape)
    return src.scatter_(-1, dest, rows)


def _gather_rows(rows: torch.Tensor, src: torch.Tensor,
                 fill: float = 0) -> torch.Tensor:
    """``rows [C, N, *f]``, ``src [C, *m]`` in ``[0, N]`` -> ``[C, *m,
    *f]``: row ``src`` of each chip's block, ``fill`` for ``N``."""
    C, N = rows.shape[:2]
    feat = tuple(rows.shape[2:])
    padded = torch.cat([rows, rows.new_full((C, 1) + feat, fill)], dim=1)
    base = torch.arange(C, device=src.device).view((C,) + (1,) * (src.dim() - 1))
    flat = (src + base * (N + 1)).reshape(-1)
    return padded.reshape((C * (N + 1),) + feat).index_select(0, flat) \
        .reshape(tuple(src.shape) + feat)


def _expert_compute(p_loc, tokens: torch.Tensor, meta_e: torch.Tensor,
                    meta_w: torch.Tensor, e_base: torch.Tensor, E_loc: int,
                    capacity: int, n_pods: int,
                    drops: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """Run each chip's experts over the copies that arrived there.

    ``tokens [C, R, d]`` (model dtype); ``meta_e [C, R, K]`` global expert
    ids (-1 pad); ``meta_w [C, R, K]`` router weights; ``e_base [C]`` the
    chip's first expert; ``p_loc`` the chips' experts, ``w_gate`` /
    ``w_up`` ``[C * E_loc, d, ff]``, ``w_down`` ``[C * E_loc, ff, d]``;
    the matmuls run one of the ``n_pods`` pods at a time.
    Returns the per-copy outputs ``[C, R, d]`` float32: the sum over the
    chip's experts the copy hits, each weighted by its router weight."""
    C, R, d = tokens.shape
    gid = e_base[:, None] + torch.arange(E_loc, device=tokens.device)
    hit = meta_e[:, None] == gid[:, :, None, None]          # [C, E_loc, R, K]
    w = (meta_w[:, None] * hit).sum(-1)                      # [C, E_loc, R]
    need = hit.any(-1)
    slot = _fifo_slots(need, capacity, dim=-1)               # [C, E_loc, R]
    if drops is not None:
        drops["expert"] = drops.get("expert", 0) + int(
            (need & (slot == capacity)).sum())
    src = _slot_sources(slot, capacity + 1)[..., :capacity]  # [C, E_loc, cap]
    buf = _gather_rows(tokens, src).reshape(C * E_loc, capacity, d)

    ys = []
    for b, wg, wu, wd in zip(*(t.chunk(n_pods) for t in (
            buf, p_loc["w_gate"], p_loc["w_up"], p_loc["w_down"]))):
        ys.append(torch.bmm(F.silu(torch.bmm(b, wg)) * torch.bmm(b, wu), wd).float())
    y = torch.cat(ys).reshape(C * E_loc * capacity, d)
    del buf, ys
    out = torch.zeros((C, R, d), dtype=torch.float32, device=tokens.device)
    chip = torch.arange(C, device=tokens.device)[:, None]
    for el in range(E_loc):
        s = slot[:, el]                                      # [C, R]
        rows = (chip * E_loc + el) * capacity + s.clamp(max=capacity - 1)
        back = y.index_select(0, rows.reshape(-1)).view(C, R, d)
        back = torch.where((s < capacity)[..., None], back, 0.0)
        out = out + back * w[:, el, :, None]
    return out


# ---------------------------------------------------------------------------
# auto resolution
# ---------------------------------------------------------------------------

def resolve_dispatch_mode(cfg, n_pods: int, n_inner: int,
                          tokens_per_pod: int) -> Tuple[str, Dict]:
    """Resolve ``moe_dispatch="auto"`` from the modeled injected inter-pod
    bytes of a seeded representative routing (uniform expert choice at
    ``cfg.top_k``) over the tokens of all pods; memoized per geometry."""
    return _resolve_cached(cfg.n_experts, cfg.top_k, cfg.d_model,
                           getattr(cfg, "wire_dtype", "f32"),
                           n_pods, n_inner, tokens_per_pod)


@functools.lru_cache(maxsize=64)
def _resolve_cached(n_experts: int, top_k: int, d_model: int, wire_dtype: str,
                    n_pods: int, n_inner: int,
                    tokens_per_pod: int) -> Tuple[str, Dict]:
    topo = Topology(n_nodes=n_pods, ppn=n_inner)
    t_global = tokens_per_pod * n_pods
    ids, w = representative_routing(t_global, n_experts, top_k, seed=0)
    r = routing_matrix(ids, w, n_experts)
    expert_part, token_part = dispatch_partitions(n_experts, t_global, topo)
    v = choose_dispatch(r, expert_part, token_part, topo,
                        wire_dtype=wire_dtype, nv=d_model)
    return v["dispatch"]["chosen"], {"dispatch": v["dispatch"],
                                     "combine": v["combine"]}


# ---------------------------------------------------------------------------
# the island
# ---------------------------------------------------------------------------

def _as_words(t: torch.Tensor) -> torch.Tensor:
    """A payload as the uint8 words it crosses an exchange in."""
    return t.contiguous().view(torch.uint8)


def _pack_meta(meta_e: torch.Tensor, meta_w: torch.Tensor) -> torch.Tensor:
    """ids (int32) and weights (float32 bits) in one int32 payload."""
    return torch.cat([meta_e.to(torch.int32), meta_w.view(torch.int32)], dim=-1)


def _unpack_meta(words: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    m = words.view(torch.int32)
    return m[..., :K].to(torch.int64), m[..., K:].contiguous().view(torch.float32)


def _send_words(exchange, payload: torch.Tensor, label: str) -> torch.Tensor:
    """One exchange of a payload ``[C, slots, rows, *f]`` as uint8 words,
    viewed back as its dtype."""
    dtype = payload.dtype
    words = _as_words(payload)
    shape = words.shape
    out = exchange(words.reshape(shape[:3] + (-1,)), label).reshape(shape)
    return out.view(dtype)


class _Exchange(torch.autograd.Function):
    """A payload through one exchange.  The exchange is a permutation that
    is its own inverse, so the backward sends the gradient through the
    same exchange, labelled ``label:grad``."""

    @staticmethod
    def forward(ctx, payload, exchange, label):
        ctx.exchange, ctx.label = exchange, label
        return _send_words(exchange, payload, label)

    @staticmethod
    def backward(ctx, grad):
        return (_send_words(ctx.exchange, grad.contiguous(), ctx.label + ":grad"),
                None, None)


class _MetaExchange(torch.autograd.Function):
    """Expert ids and router weights through one exchange as one int32
    payload; returns ``(ids, w)`` with ``w`` differentiable, whose
    gradient goes back through the same exchange (``label:grad``)."""

    @staticmethod
    def forward(ctx, meta_e, meta_w, exchange, label):
        ctx.exchange, ctx.label = exchange, label
        words = _send_words(exchange, _pack_meta(meta_e, meta_w), label)
        ids, w = _unpack_meta(words, meta_e.shape[-1])
        ctx.mark_non_differentiable(ids)
        return ids, w

    @staticmethod
    def backward(ctx, _, grad_w):
        return (None, _send_words(ctx.exchange, grad_w.contiguous(),
                                  ctx.label + ":grad"), None, None)


@dataclasses.dataclass
class _Island:
    """Geometry of one island run: ``C`` chips on this device (the
    process's block), the first ``c0``, of ``n_out`` pods of ``n_in``."""

    cfg: object
    topo: Topology
    mesh: Optional[ProcessMesh]
    C: int
    c0: int
    Tc: int
    K: int
    E_loc: int
    wd: str

    @property
    def n_in(self) -> int:
        return self.topo.ppn

    @property
    def n_out(self) -> int:
        return self.topo.n_nodes

    @property
    def n_chips(self) -> int:
        return self.topo.n_procs

    @property
    def n_pods_loc(self) -> int:
        return self.C // self.n_in

    def send(self, exchange, payload: torch.Tensor, label: str) -> torch.Tensor:
        """One exchange of a payload ``[C, slots, rows, *f]`` as uint8
        words, viewed back as its dtype; differentiable."""
        return _Exchange.apply(payload, exchange, label)

    def send_meta(self, exchange, meta_e: torch.Tensor,
                  meta_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ids and weights ``[C, slots, rows, K]`` through one exchange
        (one payload, labelled ``"meta"``): ``(ids, w)``, ``w``
        differentiable."""
        return _MetaExchange.apply(meta_e, meta_w, exchange, "meta")

    def flat(self, words, label):
        return rank_all_to_all(words, self.mesh, topo=self.topo, label=label)

    def pod(self, words, label):
        return node_all_to_all(words, self.topo, self.mesh, label=label)

    def inner(self, words, label):
        return proc_all_to_all(words, self.n_in)


def moe_apply_sharded(p, cfg, x: torch.Tensor, ep: Optional[EPInfo] = None,
                      mesh=None, stats: Optional[Dict] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Distributed MoE on the expert-parallel island.

    ``mesh`` is a :class:`Topology` ``(n_pods, n_inner)``: this process
    runs every chip; ``x [B, S, d]`` is the whole batch, sharded over the
    pods (``B % n_pods == 0``), and the whole result is returned.  Or it
    is a :class:`ProcessMesh`: this process runs its block of whole pods;
    ``x`` is the batch shard of those pods and the result is that shard;
    ``p`` holds every expert and the process runs its own.  Without
    ``ep.pod_axis`` the island is one pod.

    ``stats``, when given, receives the resolved ``mode``, the
    capacities and the copies ``dropped`` per stage (counting them
    synchronizes with the device).  The island sums in float32 and casts
    once, to ``out_dtype`` (the input's dtype by default).

    Gradients flow through the island on the f32 wire (across processes
    too: the backward's exchanges use the same communicator).  On a
    ``bf16`` or ``fp8_e4m3`` wire it raises when grad mode is on and ``x``
    or an island weight requires grad."""
    ep = ep or EPInfo(inner_axis="model", pod_axis="pod")
    if mesh is None:
        raise ValueError("moe_apply_sharded needs mesh= (a Topology or a "
                         "ProcessMesh)")
    topo = topology_of_mesh(mesh, ep)
    pm = mesh if isinstance(mesh, ProcessMesh) and mesh.world > 1 else None
    if pm is not None and not ep.pod_axis:
        raise ValueError("across processes the island needs a pod axis")
    wd = check_wire_dtype(getattr(cfg, "wire_dtype", "f32"))
    if wd != "f32" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, p["router"], p["w_gate"], p["w_up"],
                                      p["w_down"])):
        raise ValueError(
            f"the island has no gradient on the {wd} wire: the reference "
            f"ships narrow wire words through a bitcast, where its gradient "
            f"is zero; differentiate on wire_dtype='f32'")
    B, S, d = x.shape
    in_dtype = x.dtype
    y = _moe_island(cfg, topo, pm, x, p, stats)
    out = y.to(out_dtype or in_dtype)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x.reshape(-1, d)).reshape(B, S, d)
    return out


def island_pods(mesh, ep: Optional[EPInfo] = None) -> int:
    """The pods this process runs on the island over ``mesh`` (a
    ``Topology``: all of them; a ``ProcessMesh``: its block): the batch it
    is given splits over them."""
    topo = topology_of_mesh(mesh, ep)
    pm = mesh if isinstance(mesh, ProcessMesh) and mesh.world > 1 else None
    return (pm.n_local_procs if pm is not None else topo.n_procs) // topo.ppn


def check_island_batch(batch: int, n_pods_loc: int) -> None:
    if batch % n_pods_loc:
        raise ValueError(f"batch {batch} must split over the {n_pods_loc} pods "
                         f"this process runs")


def _local_experts(p, isl: _Island):
    """This process's chips' experts, ``[C * E_loc, ...]`` each."""
    if p["w_gate"].shape[0] != isl.cfg.n_experts:
        raise ValueError(f"p holds {p['w_gate'].shape[0]} experts; the island "
                         f"takes all {isl.cfg.n_experts}")
    e0, e1 = isl.c0 * isl.E_loc, (isl.c0 + isl.C) * isl.E_loc
    return {k: p[k][e0:e1] for k in ("w_gate", "w_up", "w_down")}


def _moe_island(cfg, topo: Topology, mesh: Optional[ProcessMesh],
                x: torch.Tensor, p, stats: Optional[Dict]) -> torch.Tensor:
    """The island over this process's chips; returns ``[B, S, d]`` float32."""
    n_in, n_out, n_chips = topo.ppn, topo.n_nodes, topo.n_procs
    C = mesh.n_local_procs if mesh is not None else n_chips
    c0 = mesh.ranks[0] if mesh is not None else 0
    E, K = cfg.n_experts, cfg.top_k
    if E % n_chips:
        raise ValueError(f"n_experts={E} must divide over {n_chips} chips")
    B, S, d = x.shape
    n_pods_loc = C // n_in
    check_island_batch(B, n_pods_loc)
    T = (B // n_pods_loc) * S                     # tokens of one pod block
    if T % n_in:
        raise ValueError(f"{T} tokens per pod must split over {n_in} gateways")
    isl = _Island(cfg=cfg, topo=topo, mesh=mesh, C=C, c0=c0, Tc=T // n_in, K=K,
                  E_loc=E // n_chips,
                  wd=check_wire_dtype(getattr(cfg, "wire_dtype", "f32")))
    # instance m of a pod is the gateway of chunk m of the pod's tokens
    chunk = x.reshape(C, isl.Tc, d)
    w, ids = _route(p, cfg, chunk, isl)
    mode = cfg.moe_dispatch if n_out > 1 else "flat"
    if mode == "auto":
        mode, _ = resolve_dispatch_mode(cfg, n_out, n_in, T)
    drops: Optional[Dict[str, int]] = {} if stats is not None else None
    experts = _local_experts(p, isl)
    e_base = (c0 + torch.arange(C, device=x.device)) * isl.E_loc
    if mode == "flat":
        out, caps = _flat(isl, chunk, w, ids, experts, e_base, drops)
    else:
        out, caps = _nap(isl, chunk, w, ids, experts, e_base, drops)
    if stats is not None:
        stats.update(mode=mode, capacities=caps, dropped=drops)
    return out.reshape(B, S, d)


def _route(p, cfg, chunk: torch.Tensor, isl: _Island):
    """The router over each pod's tokens: ``(w, ids)`` ``[C, Tc, K]``."""
    ws, idss = [], []
    for c in chunk.chunk(isl.n_pods_loc):
        w, ids = _router(p, cfg, c.reshape(-1, c.shape[-1]))
        ws.append(w.view(isl.n_in, isl.Tc, isl.K))
        idss.append(ids.view(isl.n_in, isl.Tc, isl.K))
    return torch.cat(ws), torch.cat(idss)


def _flat(isl: _Island, chunk, w, ids, experts, e_base, drops):
    """Algorithm-1 analogue: per-(token, k) copies, one flat all-to-all."""
    C, Tc, K, n_chips = isl.C, isl.Tc, isl.K, isl.n_chips
    d, dev = chunk.shape[-1], chunk.device
    cf = isl.cfg.capacity_factor
    capacity = max(1, int(Tc * K * cf / n_chips))
    dst_chip = ids // isl.E_loc                               # [C, Tc, K]
    # sequential-k FIFO: copy (t, k) follows every copy of k' < k
    counts = torch.zeros((C, n_chips), dtype=torch.int64, device=dev)
    slot = torch.empty((C, Tc, K), dtype=torch.int64, device=dev)
    chips = torch.arange(n_chips, device=dev)
    for k in range(K):
        # F.one_hot's values; its operators differ by device (a range check
        # with a host sync on the CPU), this comparison's do not
        onehot = (dst_chip[:, :, k, None] == chips).to(torch.int64)   # [C, Tc, n_chips]
        s = counts[:, None, :] + torch.cumsum(onehot, 1) - onehot
        sk = (s * onehot).sum(-1)
        slot[:, :, k] = torch.where(sk < capacity, sk, capacity)
        counts += onehot.sum(1)
    if drops is not None:
        drops["dispatch"] = int((slot == capacity).sum())
    # each destination's slots, then its dump slot
    pos = (dst_chip * (capacity + 1) + slot).reshape(C, Tc * K)
    src = _slot_sources(pos, n_chips * (capacity + 1)) \
        .view(C, n_chips, capacity + 1)[..., :capacity]      # copy q = t*K + k
    tok = torch.where(src < Tc * K, src // K, Tc)
    toks = _gather_rows(chunk, tok)                           # [C, n, cap, d]
    me0 = _gather_rows(ids.reshape(C, Tc * K, 1), src, fill=-1)[..., 0]
    mw0 = _gather_rows(w.reshape(C, Tc * K, 1), src)[..., 0]
    meta_e = torch.full((C, n_chips, capacity, K), -1, dtype=torch.int64,
                        device=dev)
    meta_w = torch.zeros((C, n_chips, capacity, K), dtype=torch.float32,
                         device=dev)
    meta_e[..., 0], meta_w[..., 0] = me0, mw0
    wd = isl.wd
    r_toks = isl.send(isl.flat, encode_torch(toks, wd), "tokens")
    r_e, r_w = isl.send_meta(isl.flat, meta_e, meta_w)
    del toks, meta_e, meta_w
    cap_e = max(1, int(Tc * K * cf / isl.E_loc))
    y = _expert_compute(experts, decode_torch(r_toks, wd, chunk.dtype)
                        .reshape(C, -1, d), r_e.reshape(C, -1, K),
                        r_w.reshape(C, -1, K), e_base, isl.E_loc, cap_e,
                        isl.n_pods_loc, drops)
    del r_toks
    # the combine: outputs back in the same slots (re-encoded)
    y = decode_torch(isl.send(isl.flat, encode_torch(
        y.view(C, n_chips, capacity, d), wd), "combine"), wd)
    y = y.reshape(-1, d)
    out = torch.zeros((C, Tc, d), dtype=torch.float32, device=dev)
    chip = torch.arange(C, device=dev)[:, None]
    for k in range(K):
        s = slot[:, :, k]
        rows = (chip * n_chips + dst_chip[:, :, k]) * capacity \
            + s.clamp(max=capacity - 1)
        val = y.index_select(0, rows.reshape(-1)).view(C, Tc, d)
        out = out + torch.where((s < capacity)[..., None], val, 0.0)
    return out, {"flat": capacity, "expert": cap_e}


def _nap(isl: _Island, chunk, w, ids, experts, e_base, drops):
    """Node-aware 3-step: pod dedup, one pod all-to-all, local fan-out;
    the combine reverses the route."""
    C, Tc, K, n_in, n_out = isl.C, isl.Tc, isl.K, isl.n_in, isl.n_out
    d, dev = chunk.shape[-1], chunk.device
    cf, wd = isl.cfg.capacity_factor, isl.wd
    # a token crosses to pod o at most once: cap_pod = Tc never drops
    cap_pod = Tc
    dst_pod = ids // isl.E_loc // n_in                        # [C, Tc, K]
    pods = torch.arange(n_out, device=dev)
    on_pod = dst_pod[:, :, None, :] == pods[:, None]          # [C, Tc, n_out, K]
    need_pod = on_pod.any(-1)
    pod_slot = _fifo_slots(need_pod, cap_pod, dim=1)          # [C, Tc, n_out]
    if drops is not None:
        drops["pod"] = int((need_pod & (pod_slot == cap_pod)).sum())
    pos = pods * (cap_pod + 1) + pod_slot                     # per (t, o)
    src = _slot_sources(pos.reshape(C, Tc * n_out), n_out * (cap_pod + 1)) \
        .view(C, n_out, cap_pod + 1)[..., :cap_pod]           # q = t*n_out + o
    toks = _gather_rows(chunk, torch.where(src < Tc * n_out, src // n_out, Tc))
    # only the choices that live on pod o travel there (the E(n, m) dedup)
    me = torch.where(on_pod, ids[:, :, None], -1).reshape(C, Tc * n_out, K)
    mw = torch.where(on_pod, w[:, :, None], 0.0).reshape(C, Tc * n_out, K)
    # one aggregated pod exchange; the gateway encodes once and the wire
    # payload relays through the fan-out below: the float rows on the f32
    # wire (a gather of whole rows moves the bytes of their words, and its
    # adjoint sums a copy's fan-out returns), the words of a narrow one
    enc = encode_torch(toks, wd)
    ft = isl.send(isl.pod, enc if wd == "f32" else _as_words(enc), "tokens")
    fe, fw = isl.send_meta(isl.pod, _gather_rows(me, src, fill=-1),
                           _gather_rows(mw, src))
    del toks, enc, me, mw
    R0 = n_out * cap_pod
    ft = ft.reshape(C, R0, -1)                                # wire payload
    fe, fw = fe.reshape(C, R0, K), fw.reshape(C, R0, K)
    cap_loc = max(1, int(Tc * K * cf / n_in))
    loc_of = torch.where(fe >= 0, (fe // isl.E_loc) % n_in, -1)
    inner = torch.arange(n_in, device=dev)
    on_loc = loc_of[:, :, None, :] == inner[:, None]          # [C, R0, n_in, K]
    need_loc = on_loc.any(-1)
    loc_slot = _fifo_slots(need_loc, cap_loc, dim=1)          # [C, R0, n_in]
    if drops is not None:
        drops["local"] = int((need_loc & (loc_slot == cap_loc)).sum())
    pos = inner * (cap_loc + 1) + loc_slot
    src = _slot_sources(pos.reshape(C, R0 * n_in), n_in * (cap_loc + 1)) \
        .view(C, n_in, cap_loc + 1)[..., :cap_loc]            # q = r*n_in + i
    row = torch.where(src < R0 * n_in, src // n_in, R0)
    lt = _gather_rows(ft, row)                                # wire payload
    le = torch.where(on_loc, fe[:, :, None], -1).reshape(C, R0 * n_in, K)
    lw = torch.where(on_loc, fw[:, :, None], 0.0).reshape(C, R0 * n_in, K)
    lt = isl.send(isl.inner, lt, "tokens")
    r_e, r_w = isl.send_meta(isl.inner, _gather_rows(le, src, fill=-1),
                             _gather_rows(lw, src))
    del ft, le, lw
    tokens = _from_words(lt, wd, chunk.dtype).reshape(C, n_in * cap_loc, d)
    cap_e = max(1, int(Tc * K * cf / isl.E_loc))
    y = _expert_compute(experts, decode_torch(tokens, wd, chunk.dtype),
                        r_e.reshape(C, -1, K), r_w.reshape(C, -1, K), e_base,
                        isl.E_loc, cap_e, isl.n_pods_loc, drops)
    del tokens, lt
    # the combine: expert outputs onto the inner wire, then each pod copy
    # sums its fan-out returns and goes back over the pod wire
    y = decode_torch(isl.send(isl.inner, encode_torch(
        y.view(C, n_in, cap_loc, d), wd), "combine"), wd).reshape(-1, d)
    chip = torch.arange(C, device=dev)[:, None]
    pod_back = torch.zeros((C, R0, d), dtype=torch.float32, device=dev)
    for i in range(n_in):
        s = loc_slot[:, :, i]
        rows = (chip * n_in + i) * cap_loc + s.clamp(max=cap_loc - 1)
        val = y.index_select(0, rows.reshape(-1)).view(C, R0, d)
        pod_back = pod_back + torch.where((s < cap_loc)[..., None], val, 0.0)
    del y
    back = decode_torch(isl.send(isl.pod, encode_torch(
        pod_back.view(C, n_out, cap_pod, d), wd), "combine"), wd).reshape(-1, d)
    out = torch.zeros((C, Tc, d), dtype=torch.float32, device=dev)
    for o in range(n_out):
        s = pod_slot[:, :, o]
        rows = (chip * n_out + o) * cap_pod + s.clamp(max=cap_pod - 1)
        val = back.index_select(0, rows.reshape(-1)).view(C, Tc, d)
        out = out + torch.where((s < cap_pod)[..., None], val, 0.0)
    return out, {"pod": cap_pod, "local": cap_loc, "expert": cap_e}


def _from_words(words: torch.Tensor, wd: str, model_dtype: torch.dtype):
    """The relayed payload in the wire dtype (the model dtype for f32):
    uint8 wire words viewed as it, float rows as they are."""
    if words.dtype != torch.uint8:
        return words
    return words.contiguous().view(torch_wire_dtype(wd) or model_dtype)


# ---------------------------------------------------------------------------
# registered-executor entry: routing -> node-aware plan machinery
# ---------------------------------------------------------------------------

def dispatch_operator(cfg, mesh=None, *, topo: Optional[Topology] = None,
                      n_tokens: Optional[int] = None, routing=None,
                      integrity: str = "off", seed: int = 0):
    """A concrete token -> expert routing as a ``backend="moe"`` operator.

    Builds ``R [E, T]`` from ``routing=(ids [T, K], weights [T, K])`` or a
    seeded representative routing of ``n_tokens``, on the pod-major
    expert and gateway-contiguous token partitions, and binds the
    executor named by ``cfg.moe_dispatch`` through
    :func:`repro_torch.api.operator`: ``op @ x`` is the weighted
    dispatch-sum (payloads quantized to ``cfg.wire_dtype``), ``op.T @ y``
    the weighted combine, ``op.stats()`` the byte accounting at the wire
    width, ``op.autotune_report()`` the per-direction verdict, and
    ``integrity="detect"|"recover"`` checksums the quantized words.  The
    executors run on the host.  ``mesh`` (a Topology or ProcessMesh) or
    ``topo=`` gives the ``(n_pods, chips_per_pod)`` layout."""
    from repro_torch import api
    if cfg.moe_dispatch not in DISPATCH_MODES:
        raise ValueError(f"cfg.moe_dispatch must be one of "
                         f"{'|'.join(DISPATCH_MODES)}, "
                         f"got {cfg.moe_dispatch!r}")
    if topo is None:
        if mesh is None:
            raise ValueError("dispatch_operator needs a mesh or an explicit "
                             "topo=")
        topo = topology_of_mesh(mesh)
    if routing is None:
        if n_tokens is None:
            raise ValueError("pass routing=(ids, weights) or n_tokens= for "
                             "a seeded representative routing")
        routing = representative_routing(n_tokens, cfg.n_experts, cfg.top_k,
                                         seed=seed)
    ids, weights = routing
    r = routing_matrix(np.asarray(ids), np.asarray(weights), cfg.n_experts)
    expert_part, token_part = dispatch_partitions(cfg.n_experts, r.shape[1],
                                                  topo)
    return api.operator(r, topo=topo, row_part=expert_part,
                        col_part=token_part, backend="moe",
                        method=cfg.moe_dispatch,
                        wire_dtype=getattr(cfg, "wire_dtype", "f32"),
                        integrity=integrity)
