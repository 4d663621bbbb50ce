"""Node-aware (hierarchical) collectives: the paper's three steps on a pod mesh.

The NAPSpMV insight (Sec. 4): traffic that must cross the expensive level
of the network is first aggregated on the cheap level, crosses once per
(node, node) pair, deduplicated, and is redistributed cheaply on the
receiving side.  Here a node is a pod: ``outer`` is the pod axis (the
expensive hop), ``inner`` the ranks of one pod (the cheap one).  Each
function has the name and the arithmetic of its counterpart in the JAX
package's ``core/hier_collectives.py``:

====================  =========================================
flat                   node-aware
====================  =========================================
``flat_psum_tree``     ``nap_psum`` : RS(inner) -> psum(pod) -> AG(inner)
(gather over both)     ``nap_all_gather`` : AG(pod) -> AG(inner)
(scatter over both)    ``nap_reduce_scatter`` : RS(inner) -> RS(pod)
``flat_all_to_all``    ``nap_all_to_all`` : gather, one pod exchange, scatter
====================  =========================================

plus ``compressed_psum_outer`` / ``nap_psum_compressed`` (the pod stage in
int8 with error feedback) and ``nap_moe_dispatch`` (tokens cross to a
pod once, then fan out inside it).

**Convention.**  The reference runs each function per device inside
``shard_map``.  The port runs it over a rank-batched tensor: ``x [P_loc,
...]`` holds this process's ranks, node-major (rank ``pod * ppn +
inner``); ``topo`` is a :class:`Topology` with ``n_nodes`` pods of
``ppn`` inner ranks; ``mesh`` is None (one process runs every rank) or a
:class:`~repro_torch.mesh.buffers.ProcessMesh` (this process runs its
block of whole pods).  Every stage is one exchange of
:mod:`repro_torch.mesh.comm`: ``inner`` is ``proc_all_to_all`` (never
leaves a process), ``pod`` is ``node_all_to_all`` (crosses processes,
counts ``"node"`` bytes), the flat ``(pod, inner)`` axis is
``rank_all_to_all`` (counts ``"nodexproc"`` bytes) and the ring over pods
is ``node_permute``.  A reduce-scatter is an all-to-all of chunks and a
sum over the source axis; an all-gather is an all-to-all of copies.  So
every stage counts its inter-pod bytes where the communicator counts
them, and runs across processes with no other collective.  A sum over a
source axis is a left fold in source-rank order (elementwise adds, no
atomics), so a rank's result does not depend on how many ranks its
process holds: two processes give one process's bits.

**Bytes across pods.**  With ``B`` bytes a rank, ``nap_psum`` sends
``2 (n_pods - 1) / n_pods * B / ppn`` a rank across the pod boundary (the
pod reduce-scatter and all-gather of its 1/ppn shard); ``flat_psum_tree``
is a direct reduce-scatter and all-gather over all ranks, one
``rank_all_to_all`` each, and sends ``2 (P - ppn) / P * B``.  The ratio is
exactly ``1 / ppn`` when nothing pads.  It is a statement against this
flat algorithm: a ring all-reduce (NCCL's) crosses the pod boundary on a
few links only.

**Trees** are flattened as ``jax.tree.flatten`` flattens them: dict
leaves in sorted-key order, list and tuple leaves in order; the leaves
(each ``[P_loc, ...]``) are cast to float32 and concatenated, and the
results are restored to each leaf's shape and dtype.

Entry points take ``device=`` (CUDA unless ``"cpu"``; they raise when
CUDA is wanted and absent) and move their operands there.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.mesh.buffers import ProcessMesh
from repro_torch.mesh.comm import (node_all_to_all, node_permute,
                                   proc_all_to_all, rank_all_to_all)
from repro_torch.moe.dispatch import _fifo_slots, _gather_rows, _slot_sources

__all__ = [
    "nap_psum", "nap_psum_tree", "flat_psum_tree", "nap_all_gather",
    "nap_reduce_scatter", "nap_all_to_all", "flat_all_to_all",
    "compressed_psum_outer", "nap_psum_compressed", "residual_shape_for",
    "nap_moe_dispatch",
]

Tree = Any


# ---------------------------------------------------------------------------
# shape plumbing
# ---------------------------------------------------------------------------

def _leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _rebuild(tree: Tree, it) -> Tree:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)([_rebuild(t, it) for t in tree])
    return next(it)


def _flatten_concat(tree: Tree, dev: torch.device
                    ) -> Tuple[torch.Tensor, Tree, list]:
    """All leaves ``[P_loc, ...]`` -> one float32 ``[P_loc, N]``."""
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("the tree has no leaves (the rank count is unknown)")
    p_loc = leaves[0].shape[0]
    if any(leaf.shape[0] != p_loc for leaf in leaves):
        raise ValueError("every leaf must lead with the same rank axis")
    shapes = [(tuple(leaf.shape[1:]), leaf.dtype) for leaf in leaves]
    flat = torch.cat([leaf.to(dev).reshape(p_loc, -1).float() for leaf in leaves],
                     dim=1)
    return flat, tree, shapes


def _split_restore(flat: torch.Tensor, treedef: Tree, shapes: list) -> Tree:
    out, off = [], 0
    for shape, dtype in shapes:
        n = math.prod(shape)
        out.append(flat[:, off:off + n].reshape((flat.shape[0],) + shape).to(dtype))
        off += n
    return _rebuild(treedef, iter(out))


def _pad_to_multiple(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad the last axis of ``x [P_loc, n]`` to a multiple of ``k``."""
    pad = (-x.shape[-1]) % k
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _fold(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` as a left fold in index order: elementwise
    adds, so each element's bits depend on its own addends only."""
    parts = t.unbind(dim)
    if len(parts) == 1:
        return parts[0].contiguous()
    acc = parts[0] + parts[1]
    for p in parts[2:]:
        acc += p
    return acc


def _check_ranks(x: torch.Tensor, topo: Topology,
                 mesh: Optional[ProcessMesh]) -> None:
    want = mesh.n_local_procs if mesh is not None else topo.n_procs
    if x.shape[0] != want:
        raise ValueError(f"the leading axis holds {x.shape[0]} ranks; this "
                         f"process runs {want} of {topo}")


def _mesh(mesh: Optional[ProcessMesh]) -> Optional[ProcessMesh]:
    """A one-process mesh runs like no mesh."""
    return mesh if mesh is not None and mesh.world > 1 else None


def _first_rank(mesh: Optional[ProcessMesh]) -> int:
    return mesh.ranks[0] if mesh is not None else 0


# ---------------------------------------------------------------------------
# stages: reduce-scatter and all-gather over one axis
# ---------------------------------------------------------------------------

def _rs_inner(flat: torch.Tensor, topo: Topology) -> torch.Tensor:
    """``[P_loc, ppn * c, ...]`` -> ``[P_loc, c, ...]``: rank ``(n, i)`` gets
    chunk ``i`` summed over its pod."""
    s = flat.shape
    recv = proc_all_to_all(flat.reshape((s[0], topo.ppn, s[1] // topo.ppn) + s[2:]),
                           topo.ppn)
    return _fold(recv, 1)


def _ag_inner(shard: torch.Tensor, topo: Topology) -> torch.Tensor:
    """``[P_loc, c]`` -> ``[P_loc, ppn * c]`` in inner-rank order."""
    p_loc, c = shard.shape
    copies = shard[:, None].expand(p_loc, topo.ppn, c)
    return proc_all_to_all(copies, topo.ppn).reshape(p_loc, topo.ppn * c)


def _rs_pod(x: torch.Tensor, topo: Topology, mesh, label) -> torch.Tensor:
    """``[P_loc, n_pods * c, ...]`` -> ``[P_loc, c, ...]``: rank ``(o, i)``
    gets chunk ``o`` summed over the pods."""
    s = x.shape
    nn = topo.n_nodes
    recv = node_all_to_all(x.reshape((s[0], nn, s[1] // nn) + s[2:]), topo, mesh,
                           label=label)
    return _fold(recv, 1)


def _ag_pod(part: torch.Tensor, topo: Topology, mesh, label) -> torch.Tensor:
    """``[P_loc, *f]`` -> ``[P_loc, n_pods, *f]`` in pod order."""
    copies = part[:, None].expand((part.shape[0], topo.n_nodes) + part.shape[1:])
    return node_all_to_all(copies, topo, mesh, label=label)


def _psum_pod(shard: torch.Tensor, topo: Topology, mesh, label) -> torch.Tensor:
    """psum over the pod axis of ``[P_loc, c]``: reduce-scatter, then
    all-gather (``c`` padded to a multiple of ``n_pods`` on the way)."""
    if topo.n_nodes == 1:
        return shard
    c = shard.shape[1]
    red = _rs_pod(_pad_to_multiple(shard, topo.n_nodes), topo, mesh, label)
    return _ag_pod(red, topo, mesh, label).reshape(shard.shape[0], -1)[:, :c]


# ---------------------------------------------------------------------------
# hierarchical all-reduce (gradient synchronisation)
# ---------------------------------------------------------------------------

def _nap_psum_flat(flat: torch.Tensor, topo: Topology, mesh) -> torch.Tensor:
    """``flat [P_loc, n]`` -> the sum over every rank, on every rank."""
    n = flat.shape[1]
    shard = _rs_inner(_pad_to_multiple(flat, topo.ppn), topo)
    shard = _psum_pod(shard, topo, mesh, "psum")
    return _ag_inner(shard, topo)[:, :n]


def nap_psum(x: torch.Tensor, topo: Topology, mesh: Optional[ProcessMesh] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """All-reduce over (inner x pod) with 1/ppn of the bytes across pods:
    reduce-scatter over ``inner``, psum over the pods on the scattered
    shard, all-gather over ``inner``.  ``x [P_loc, ...]``; every rank gets
    the sum over all ranks, in ``x``'s dtype."""
    x = x.to(resolve_device(device))
    mesh = _mesh(mesh)
    _check_ranks(x, topo, mesh)
    return _nap_psum_flat(x.reshape(x.shape[0], -1), topo, mesh).reshape(x.shape)


def nap_psum_tree(tree: Tree, topo: Topology, mesh: Optional[ProcessMesh] = None,
                  device: DeviceLike = None) -> Tree:
    """Fused hierarchical all-reduce of a gradient tree: one reduce-scatter
    and all-gather pair for the whole flattened float32 bucket."""
    dev = resolve_device(device)
    mesh = _mesh(mesh)
    flat, treedef, shapes = _flatten_concat(tree, dev)
    _check_ranks(flat, topo, mesh)
    return _split_restore(_nap_psum_flat(flat, topo, mesh), treedef, shapes)


def flat_psum_tree(tree: Tree, topo: Topology, mesh: Optional[ProcessMesh] = None,
                   device: DeviceLike = None) -> Tree:
    """The topology-oblivious all-reduce of a gradient tree: the flattened
    float32 bucket reduce-scattered over all ranks by one
    ``rank_all_to_all`` (each rank sums chunk ``r`` over every source), then
    all-gathered by another."""
    dev = resolve_device(device)
    mesh = _mesh(mesh)
    flat, treedef, shapes = _flatten_concat(tree, dev)
    _check_ranks(flat, topo, mesh)
    p_loc, n = flat.shape
    P = topo.n_procs
    padded = _pad_to_multiple(flat, P)
    c = padded.shape[1] // P
    recv = rank_all_to_all(padded.reshape(p_loc, P, c), mesh, topo=topo,
                           label="psum")
    mine = _fold(recv, 1)
    del recv
    copies = mine[:, None].expand(p_loc, P, c)
    full = rank_all_to_all(copies, mesh, topo=topo, label="psum")
    return _split_restore(full.reshape(p_loc, P * c)[:, :n], treedef, shapes)


def nap_all_gather(x: torch.Tensor, topo: Topology,
                   mesh: Optional[ProcessMesh] = None, axis: int = 0,
                   device: DeviceLike = None) -> torch.Tensor:
    """All-gather over (pod x inner), tiled along ``axis`` of a rank's
    block: across pods first (1/ppn of a flat gather's bytes a hop), then
    over ``inner``.  The pieces come in the reference's order, inner-major:
    piece ``i * n_pods + o`` is rank ``(o, i)``'s block."""
    x = x.to(resolve_device(device))
    mesh = _mesh(mesh)
    _check_ranks(x, topo, mesh)
    p_loc, f = x.shape[0], tuple(x.shape[1:])
    axis = axis % len(f)
    pod = _ag_pod(x, topo, mesh, "gather")                 # [P_loc, nn, *f]
    copies = pod[:, None].expand((p_loc, topo.ppn) + pod.shape[1:])
    full = proc_all_to_all(copies, topo.ppn)               # [P_loc, ppn, nn, *f]
    pieces = full.reshape((p_loc, topo.n_procs) + f).movedim(1, axis + 1)
    return pieces.reshape((p_loc,) + f[:axis] + (topo.n_procs * f[axis],)
                          + f[axis + 1:])


def nap_reduce_scatter(x: torch.Tensor, topo: Topology,
                       mesh: Optional[ProcessMesh] = None,
                       device: DeviceLike = None) -> torch.Tensor:
    """Reduce-scatter over (inner x pod) along axis 0 of a rank's block:
    the inner reduce-scatter shrinks the buffer ppn-fold before the pod
    one touches it.  Rank ``(o, i)`` ends with chunk ``i * n_pods + o`` of
    ``ppn * n_pods``, summed over every rank."""
    x = x.to(resolve_device(device))
    mesh = _mesh(mesh)
    _check_ranks(x, topo, mesh)
    if x.dim() < 2 or x.shape[1] % (topo.ppn * topo.n_nodes):
        raise ValueError(f"axis 0 of a rank's block ({tuple(x.shape[1:])}) must "
                         f"split into {topo.ppn} x {topo.n_nodes} chunks")
    return _rs_pod(_rs_inner(x, topo), topo, mesh, "scatter")


# ---------------------------------------------------------------------------
# hierarchical (3-step) all-to-all: the literal NAPSpMV pattern
# ---------------------------------------------------------------------------

def nap_all_to_all(x: torch.Tensor, topo: Topology,
                   mesh: Optional[ProcessMesh] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """All-to-all over the flat rank grid in the paper's three steps.

    ``x [P_loc, P, ...]``: row ``d`` of a rank's block is its payload for
    rank ``d``.  Step 1 (local gather): an inner all-to-all over the
    destination slot, so inner rank ``p`` of each pod holds everything the
    pod sends to slot ``p`` of every pod (the aligned pairing).  Step 2:
    ONE aggregated pod all-to-all.  Step 3: the data is home; the source
    grid flattens back to rank order.  Bit-equal to :func:`flat_all_to_all`:
    ``out[d][s] = x[s][d]``."""
    x = x.to(resolve_device(device))
    mesh = _mesh(mesh)
    _check_ranks(x, topo, mesh)
    nn, ppn = topo.n_nodes, topo.ppn
    p_loc = x.shape[0]
    y = x.reshape(p_loc, nn, ppn, -1)
    # step 1: [P_loc, ppn(dst slot), nn, R] -> [P_loc, ppn(src slot), nn, R]
    y = proc_all_to_all(y.transpose(1, 2), ppn).transpose(1, 2)
    # step 2: one pod exchange of [nn(dst pod), ppn(src slot), R]
    y = node_all_to_all(y, topo, mesh, label="all_to_all")
    return y.reshape(x.shape)


def flat_all_to_all(x: torch.Tensor, topo: Topology,
                    mesh: Optional[ProcessMesh] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """Topology-oblivious all-to-all over the combined (pod, inner) axis:
    ``x [P_loc, P, ...]``, ``out[d][s] = x[s][d]``."""
    x = x.to(resolve_device(device))
    mesh = _mesh(mesh)
    _check_ranks(x, topo, mesh)
    return rank_all_to_all(x, mesh, topo=topo, label="all_to_all")


# ---------------------------------------------------------------------------
# int8 error-feedback compression of the pod stage
# ---------------------------------------------------------------------------

def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per rank (``x [P_loc, c]``): ``scale = max(max|x|, 1e-30) / 127``
    and ``q = clip(round(x / scale), -127, 127)`` as int8 (round half to
    even; clipped before the cast, whose out-of-range result CUDA leaves
    undefined).  The division by 127 is the product with float32(1/127),
    as XLA compiles the reference's division by that constant."""
    scale = torch.clamp(x.abs().amax(dim=1), min=1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _fma(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
         sign: float = 1.0) -> torch.Tensor:
    """``acc + sign * q * scale`` rounded once to float32: the fused
    multiply-add that XLA emits for the reference's dequantize-and-add
    (``q * scale`` is exact in float64: 7 bits times 24)."""
    prod = q.double() * scale.double()[:, None]
    return (acc.double() + prod if sign > 0 else acc.double() - prod).float()


def _hop(q: torch.Tensor, scale: torch.Tensor, topo: Topology, mesh,
         label: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring hop to the next pod: the int8 words and the f32 scale of
    each rank as one payload of ``c + 4`` bytes."""
    p_loc = q.shape[0]
    words = torch.cat([q.view(torch.uint8),
                       scale.contiguous().view(torch.uint8).reshape(p_loc, 4)], dim=1)
    got = node_permute(words, topo, mesh, shift=1, label=label)
    return got[:, :-4].view(torch.int8), got[:, -4:].contiguous().view(torch.float32)[:, 0]


def compressed_psum_outer(x: torch.Tensor, topo: Topology,
                          mesh: Optional[ProcessMesh] = None,
                          residual: Optional[torch.Tensor] = None,
                          device: DeviceLike = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """psum over the pod axis with int8 on the wire and error feedback.

    A ring reduce-scatter then a ring all-gather over the pods
    (:func:`~repro_torch.mesh.comm.node_permute`), each hop carrying int8
    words and one f32 scale a rank.  ``residual`` (``x``'s shape) adds the
    last step's quantization error before this step's sum.  Every replica
    applies the dequantized value, its own chunk's too, so the result is
    bitwise the same on every rank of a ring.  Returns ``(sum,
    new_residual)``, both ``x``'s shape, float32."""
    dev = resolve_device(device)
    x = x.to(dev)
    mesh = _mesh(mesh)
    _check_ranks(x, topo, mesh)
    n = topo.n_nodes
    xc = x + (torch.zeros_like(x) if residual is None else residual.to(dev))
    if n == 1:
        return xc, torch.zeros_like(x)
    p_loc = x.shape[0]
    size = xc[0].numel()
    chunks = _pad_to_multiple(xc.reshape(p_loc, -1), n).reshape(p_loc, n, -1)
    rows = torch.arange(p_loc, device=dev)
    idx = (_first_rank(mesh) + rows) // topo.ppn          # each rank's pod
    # the error feedback: each chunk's quantization error where this rank
    # sent it (every chunk but its own in the reduce-scatter, its own in
    # the all-gather)
    err = torch.empty_like(chunks)
    acc = chunks.clone()
    # ring reduce-scatter: at step s a rank sends chunk (idx - s - 1) to the
    # next pod and adds the chunk (idx - s - 2) that the previous one sent
    for s in range(n - 1):
        send_c = (idx - s - 1) % n
        payload = acc[rows, send_c]
        q, scale = _quantize_int8(payload)
        # what this rank failed to transmit of the chunk it sends
        err[rows, send_c] = _fma(payload, q, scale, -1.0)
        acc[rows, send_c] = 0.0
        q_in, scale_in = _hop(q, scale, topo, mesh, "int8")
        rc = (idx - s - 2) % n
        acc[rows, rc] = _fma(acc[rows, rc], q_in, scale_in)
    mine = acc[rows, idx]                                  # chunk idx, summed
    # ring all-gather of the reduced chunks, int8 again; every rank applies
    # the dequantized value, the owner too
    q, scale = _quantize_int8(mine)
    out = torch.empty_like(chunks)
    out[rows, idx] = q.float() * scale[:, None]
    err[rows, idx] = _fma(mine, q, scale, -1.0)
    for s in range(n - 1):
        q, scale = _hop(q, scale, topo, mesh, "int8")
        out[rows, (idx - s - 1) % n] = q.float() * scale[:, None]
    total = out.reshape(p_loc, -1)[:, :size].reshape(x.shape)
    new_residual = err.reshape(p_loc, -1)[:, :size].reshape(x.shape)
    return total, new_residual


def nap_psum_compressed(x: torch.Tensor, topo: Topology,
                        mesh: Optional[ProcessMesh] = None,
                        residual: Optional[torch.Tensor] = None,
                        device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical all-reduce with an int8 pod stage: reduce-scatter over
    ``inner`` in float32, :func:`compressed_psum_outer` over the pods on
    the shard, all-gather over ``inner``.  ``residual`` is ``[P_loc,
    *residual_shape_for(x.shape[1:], ppn)]``; returns ``(sum,
    new_residual)``."""
    dev = resolve_device(device)
    x = x.to(dev)
    mesh = _mesh(mesh)
    _check_ranks(x, topo, mesh)
    p_loc, n = x.shape[0], x[0].numel()
    shard = _rs_inner(_pad_to_multiple(x.reshape(p_loc, -1), topo.ppn), topo)
    shard, res_out = compressed_psum_outer(shard, topo, mesh, residual, device=dev)
    full = _ag_inner(shard, topo)[:, :n]
    return full.reshape(x.shape), res_out


def residual_shape_for(x_shape: Sequence[int], inner: int) -> Tuple[int, ...]:
    """Shape of a rank's error-feedback residual for
    :func:`nap_psum_compressed` (``x_shape`` is a rank's block)."""
    n = math.prod(x_shape)
    padded = n + ((-n) % inner)
    return (padded // inner,)


# ---------------------------------------------------------------------------
# NAP MoE dispatch: the paper's technique applied to expert parallelism
# ---------------------------------------------------------------------------

def nap_moe_dispatch(tokens: torch.Tensor, dest_chip: torch.Tensor,
                     topo: Topology, capacity: int,
                     mesh: Optional[ProcessMesh] = None,
                     device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Send each token to the expert-parallel chips in ``dest_chip``.

    A token bound for several chips of one remote pod crosses to that pod
    once (the paper's E(n, m) dedup) and fans out there.  ``tokens [P_loc,
    T, D]`` (each chip's tokens), ``dest_chip [P_loc, T, K]`` global chip
    ids (-1: none); ``capacity`` slots per (source chip, destination pod)
    buffer and per (gateway, destination chip) buffer, filled first come
    first served; a copy past its capacity is dropped.  The pod buffers
    ``[n_pods, capacity, ...]`` (tokens, the chip lists, the source ids)
    cross whole, padding included, counted under the labels ``"tokens"``,
    ``"meta"`` and ``"srcs"``.

    Returns ``(recv [P_loc, ppn * capacity, D], recv_src [P_loc, ppn *
    capacity] int32, recv_valid)``: row ``s * capacity + j`` of a chip's
    buffer came through inner rank ``s`` of its pod, ``recv_src`` is the
    global source id ``chip * T + token`` (-1 for an empty slot)."""
    dev = resolve_device(device)
    tokens, dest_chip = tokens.to(dev), dest_chip.to(dev)
    mesh = _mesh(mesh)
    _check_ranks(tokens, topo, mesh)
    n_in, n_out = topo.ppn, topo.n_nodes
    C, T, D = tokens.shape
    K = dest_chip.shape[2]
    chips = _first_rank(mesh) + torch.arange(C, device=dev)
    dest = dest_chip.to(torch.int64)
    # dedup: does token t need pod o at all?
    dest_pod = torch.where(dest >= 0, dest // n_in, -1)
    pods = torch.arange(n_out, device=dev)
    need_pod = (dest_pod[:, :, None, :] == pods[:, None]).any(-1)   # [C, T, n_out]
    pod_slot = _fifo_slots(need_pod, capacity, dim=1)
    pos = pods * (capacity + 1) + pod_slot
    src = _slot_sources(pos.reshape(C, T * n_out), n_out * (capacity + 1)) \
        .view(C, n_out, capacity + 1)[..., :capacity]               # q = t*n_out + o
    tok = torch.where(src < T * n_out, src // n_out, T)
    buf = _gather_rows(tokens, tok)                                  # [C, n_out, cap, D]
    meta = _gather_rows(dest_chip.to(torch.int32), tok, fill=-1)     # [C, n_out, cap, K]
    srcs = torch.where(tok < T, chips[:, None, None] * T + tok, -1).to(torch.int32)
    # ONE aggregated pod exchange of each buffer
    buf = node_all_to_all(buf, topo, mesh, label="tokens")
    meta = node_all_to_all(meta, topo, mesh, label="meta")
    srcs = node_all_to_all(srcs, topo, mesh, label="srcs")
    # local scatter to the chips of this pod that need each arrival
    R0 = n_out * capacity
    fm = meta.reshape(C, R0, K).to(torch.int64)
    my_pod = (chips // n_in)[:, None, None]
    inner = torch.arange(n_in, device=dev)
    here = (fm >= 0) & (fm // n_in == my_pod)                       # [C, R0, K]
    on_loc = here[:, :, None, :] & ((fm % n_in)[:, :, None, :] == inner[:, None])
    need_loc = on_loc.any(-1)                                        # [C, R0, n_in]
    loc_slot = _fifo_slots(need_loc, capacity, dim=1)
    pos = inner * (capacity + 1) + loc_slot
    src = _slot_sources(pos.reshape(C, R0 * n_in), n_in * (capacity + 1)) \
        .view(C, n_in, capacity + 1)[..., :capacity]                # q = r*n_in + i
    row = torch.where(src < R0 * n_in, src // n_in, R0)
    lbuf = _gather_rows(buf.reshape(C, R0, D), row)                 # [C, n_in, cap, D]
    lsrc = _gather_rows(srcs.reshape(C, R0, 1), row, fill=-1)[..., 0]
    lbuf = proc_all_to_all(lbuf, n_in)
    lsrc = proc_all_to_all(lsrc, n_in)
    recv = lbuf.reshape(C, n_in * capacity, D)
    recv_src = lsrc.reshape(C, n_in * capacity)
    return recv, recv_src, recv_src >= 0
