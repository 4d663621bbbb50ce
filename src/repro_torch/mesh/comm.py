"""The communicator under the exchanges of the rank-batched programs.

The JAX package gets its exchanges from XLA collectives (a tiled
``all_to_all`` over a mesh axis).  The port batches a process's ranks on
its device, so an exchange is an axis permutation inside the process
and, across processes, one ``torch.distributed.all_to_all_single`` over
the process group.  A process owns a contiguous block of whole nodes
(:class:`repro_torch.mesh.buffers.ProcessMesh`), so:

* ``proc`` exchanges (:func:`proc_all_to_all`) never leave the process;
* the ``node`` all-to-all (:func:`node_all_to_all`) and the ``("node",
  "proc")`` all-to-all (:func:`rank_all_to_all`) cross processes, each
  with equal splits by the owned block;
* :func:`live_all_to_all` moves the live slots of a flat exchange with
  the per-process counts of the plan (the multi-step direct phase);
* :func:`node_permute` is the ring ``ppermute`` over ``node`` (the
  compressed pod psum of :mod:`repro_torch.core.hier_collectives`).

With ``mesh=None`` (one process) the first two are exactly the
permutations the programs have always run, and no collective happens.
On gloo, CUDA tensors are staged through pinned host buffers in both
directions (gloo is never handed a CUDA tensor); NCCL takes the device
tensors.  Every cross-process call adds to the mesh's ``stats``: the
bytes sent to OTHER processes per axis, the bytes staged, the calls.

The tiled all-to-alls and the ring also count, in one process too, the
bytes whose source and destination NODE differ (the expensive hop; a
node is a pod for the MoE dispatch), at the width the payload crosses:
:data:`INTER_NODE_BYTES` per axis (``"node"``, ``"nodexproc"``) and, when
the caller names its payload, per ``"axis:label"``; with a mesh also
``stats["inter_node_bytes_<axis>"]``.  The ``node`` all-to-all always
counts; the ``("node", "proc")`` one counts when it knows the topology
(``topo=`` or a mesh).  Each process counts the messages its own ranks
send.  While a counter of :mod:`repro_torch.core.op_analysis` is active,
every exchange also reports its kind, its operand's bytes, its group
and, at the same call as :data:`INTER_NODE_BYTES`, the bytes that cross
a node (:func:`_exchanged`).
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import op_analysis
from repro_torch.core.topology import Topology
from repro_torch.mesh.buffers import ProcessMesh, _dist

__all__ = ["proc_all_to_all", "node_all_to_all", "rank_all_to_all",
           "node_permute", "live_all_to_all", "exchange", "INTER_NODE_BYTES",
           "inter_node_bytes", "reset_inter_node_bytes"]

#: bytes sent between different nodes by this process's ranks, per axis
#: and per "axis:label" (see the module docstring)
INTER_NODE_BYTES: Dict[str, int] = collections.Counter()


def inter_node_bytes() -> Dict[str, int]:
    """A copy of :data:`INTER_NODE_BYTES`."""
    return dict(INTER_NODE_BYTES)


def reset_inter_node_bytes() -> None:
    INTER_NODE_BYTES.clear()


def _count_inter(axis: str, nbytes: int, mesh: Optional[ProcessMesh],
                 label: Optional[str]) -> None:
    INTER_NODE_BYTES[axis] += nbytes
    if label:
        INTER_NODE_BYTES[f"{axis}:{label}"] += nbytes
    if mesh is not None:
        mesh.stats[f"inter_node_bytes_{axis}"] += nbytes


def _exchanged(kind: str, buf: torch.Tensor, group: int, axis: Optional[str] = None,
               crossing: int = 0, mesh: Optional[ProcessMesh] = None,
               label: Optional[str] = None) -> None:
    """One exchange of ``buf``: its node-crossing bytes into
    :data:`INTER_NODE_BYTES` under ``axis`` (when it has one), and the
    exchange into an active op counter."""
    if axis is not None:
        _count_inter(axis, crossing, mesh, label)
    if op_analysis.active():
        op_analysis.note_collective(kind, buf.numel() * buf.element_size(), group,
                                    crossing, axis)


def _nbytes(t: torch.Tensor, dims) -> int:
    n = t.element_size()
    for d in dims:
        n *= d
    return n


def proc_all_to_all(buf: torch.Tensor, ppn: int) -> torch.Tensor:
    """Tiled all-to-all over ``proc``: ``buf [P_loc, ppn, pad, ...]``,
    ``recv[n, j, p] = send[n, p, j]`` (swap axes 1 and 2 of each node's
    ``[ppn, ppn]`` block).  Nodes are whole within a process, so this is
    a permutation in every layout."""
    s = buf.shape
    _exchanged("all-to-all", buf, ppn)
    return buf.reshape((-1, ppn, ppn) + s[2:]).transpose(1, 2).reshape(s)


def node_all_to_all(buf: torch.Tensor, topo: Topology,
                    mesh: Optional[ProcessMesh] = None,
                    label: Optional[str] = None) -> torch.Tensor:
    """Tiled all-to-all over ``node``: ``buf [P_loc, n_nodes, ...]`` (each
    rank's message to every node; ``[P_loc, n_nodes, pad, nv]`` in the
    SpMV programs), ``recv[m, p, n] = send[n, p, m]``.
    Every message but a rank's own node's crosses nodes (``label`` names
    the payload in :data:`INTER_NODE_BYTES`).

    One process: the axis permutation (swap axes 0 and 2 of
    ``[n_nodes, ppn, n_nodes]``).  Across processes each process sends
    the messages to the nodes of process q as one contiguous split
    ``[n_local, ppn, n_local, ...]``, and the received splits (one per
    source process, in node order) are permuted into place."""
    s = buf.shape
    nn, ppn = topo.n_nodes, topo.ppn
    _exchanged("all-to-all", buf, nn, "node",
               _nbytes(buf, (s[0], nn - 1) + tuple(s[2:])), mesh, label)
    if mesh is None:
        tail = tuple(range(3, len(s) + 1))
        return buf.reshape((nn, ppn, nn) + s[2:]).permute((2, 1, 0) + tail).reshape(s)
    nl, rest = mesh.n_local_nodes, tuple(range(4, 4 + len(s) - 2))
    # [n_src, p, q_dst, m_dst] -> [q_dst, n_src, p, m_dst]
    send = buf.reshape((nl, ppn, mesh.world, nl) + s[2:]).permute((2, 0, 1, 3) + rest)
    recv = _all_to_all(send, mesh, "node", label=label)
    # [q_src, n_src, p, m_dst] -> [m_dst, p, q_src, n_src]
    return recv.permute((3, 2, 0, 1) + rest).reshape(s)


def rank_all_to_all(buf: torch.Tensor, mesh: Optional[ProcessMesh] = None,
                    lead: int = 0, topo: Optional[Topology] = None,
                    label: Optional[str] = None) -> torch.Tensor:
    """Tiled all-to-all over ``("node", "proc")``: ``buf`` is ``lead`` dims,
    then ``[P_loc(src), P(dst)]``, then the payload; ``recv[r, s] =
    send[s, r]`` (ranks are node-major).  With a topology (``topo`` or
    the mesh's) the messages between ranks of different nodes count in
    :data:`INTER_NODE_BYTES` (``label`` names the payload).

    One process: swap the two rank axes.  Across processes the
    destination axis is split by owned block and the table reordered so
    that each destination process's slice is contiguous (it is not the
    leading axis, e.g. in the standard exchange's column-major
    ``[nv, P, P, pad]`` table), then one equal-split all-to-all."""
    topo = topo if topo is not None else getattr(mesh, "topo", None)
    if topo is not None:
        s = buf.shape
        _exchanged("all-to-all", buf, s[lead + 1], "nodexproc", _nbytes(
            buf, tuple(s[:lead]) + (s[lead], s[lead + 1] - topo.ppn)
            + tuple(s[lead + 2:])), mesh, label)
    else:
        _exchanged("all-to-all", buf, buf.shape[lead + 1])
    if mesh is None:
        return buf.transpose(lead, lead + 1).contiguous()
    s, w, pl = buf.shape, mesh.world, mesh.n_local_procs
    x = buf.reshape(s[:lead] + (pl, w, pl) + s[lead + 2:])
    tail = tuple(range(lead + 3, x.dim()))
    # lead + [s, q_dst, r] -> [q_dst] + lead + [s, r]
    send = x.permute((lead + 1,) + tuple(range(lead)) + (lead, lead + 2) + tail)
    recv = _all_to_all(send, mesh, "nodexproc", label=label)
    # [q_src] + lead + [s, r] -> lead + [r, q_src, s]
    out = recv.permute(tuple(range(1, lead + 1)) + (lead + 2, 0, lead + 1) + tail)
    return out.reshape(s)


def node_permute(buf: torch.Tensor, topo: Topology,
                 mesh: Optional[ProcessMesh] = None, shift: int = 1,
                 label: Optional[str] = None) -> torch.Tensor:
    """The ring ``ppermute`` over ``node``: ``buf [P_loc, ...]`` (one
    payload a rank), ``recv[(n, p)] = send[((n - shift) mod n_nodes, p)]``
    (every rank hands its payload to the same proc of the node ``shift``
    further on).  Every payload crosses nodes, each hop (``label`` names
    it in :data:`INTER_NODE_BYTES`).

    One process: a roll over the node axis.  Across processes each
    process sends every owned node's payloads to the process that owns
    its destination node, rows grouped by destination process and ordered
    by destination node, with per-process row counts, in one
    ``all_to_all_single`` (counts are non-zero only toward the processes
    that own those nodes: the next one for ``shift=1``)."""
    s = buf.shape
    nn, ppn = topo.n_nodes, topo.ppn
    if nn > 1:
        _exchanged("collective-permute", buf, 0, "node", _nbytes(buf, tuple(s)),
                   mesh, label)
    if mesh is None:
        return buf.reshape((nn, ppn) + s[1:]).roll(shift, dims=0).reshape(s)
    nl, w = mesh.n_local_nodes, mesh.world
    n0 = mesh.nodes[0]
    nodes = buf.reshape((nl, ppn) + s[1:])
    # destination node of each owned node, and the node each one receives
    dst = [(n0 + i + shift) % nn for i in range(nl)]
    src = [(n0 + i - shift) % nn for i in range(nl)]
    order = sorted(range(nl), key=lambda i: (dst[i] // nl, dst[i]))
    send_counts = [0] * w
    for i in order:
        send_counts[dst[i] // nl] += ppn
    recv_from = sorted(range(nl), key=lambda i: (src[i] // nl, src[i]))
    recv_counts = [0] * w
    for i in recv_from:
        recv_counts[src[i] // nl] += ppn
    send = nodes[torch.tensor(order, device=buf.device)].reshape((-1,) + s[1:])
    recv = _all_to_all(send, mesh, "node", send_counts, recv_counts, label=label)
    out = torch.empty_like(nodes)
    out[torch.tensor(recv_from, device=buf.device)] = recv.reshape(nodes.shape)
    return out.reshape(s)


def live_all_to_all(values: torch.Tensor, send_counts: Sequence[int],
                    recv_counts: Sequence[int], mesh: ProcessMesh) -> torch.Tensor:
    """The live slots of a flat exchange: ``values`` (rows grouped by
    destination process, ``send_counts[q]`` rows for process q) ->
    the rows every process sent here, grouped by source process
    (``recv_counts[q]`` from q).  The counts are structure: every process
    derives both from the same plan."""
    _exchanged("all-to-all", values, mesh.world)
    return _all_to_all(values, mesh, "nodexproc", list(send_counts),
                       list(recv_counts))


def exchange(axis: str, buf: torch.Tensor, topo: Topology,
             mesh: Optional[ProcessMesh] = None) -> torch.Tensor:
    """The tiled all-to-all of one mesh axis (``"proc"``, ``"node"`` or
    ``"nodexproc"``) on a ``[P_loc, n_slots, pad(, nv)]`` buffer."""
    if axis == "proc":
        return proc_all_to_all(buf, topo.ppn)
    if axis == "node":
        return node_all_to_all(buf, topo, mesh)
    if axis == "nodexproc":
        return rank_all_to_all(buf, mesh, topo=topo)
    raise ValueError(f"axis must be proc, node or nodexproc, got {axis!r}")


def _all_to_all(send: torch.Tensor, mesh: ProcessMesh, axis: str,
                in_splits: Optional[list] = None,
                out_splits: Optional[list] = None,
                label: Optional[str] = None) -> torch.Tensor:
    """One ``all_to_all_single`` over ``mesh.group`` along ``send``'s
    leading axis: equal splits (one per process) when no splits are
    given, else the given row counts.  Counts the bytes sent to other
    processes under ``sent_bytes_<axis>`` (and ``sent_bytes_<axis>:<label>``
    for a named payload) and what is staged."""
    dist = _dist()
    send = send.contiguous()
    row = send[0].numel() * send.element_size() if send.shape[0] else 0
    if in_splits is None:
        out_shape = send.shape
        own = send.shape[0] // mesh.world
    else:
        out_shape = (int(sum(out_splits)),) + tuple(send.shape[1:])
        own = in_splits[mesh.rank]
    if mesh.backend == "gloo" and send.is_cuda:
        host_in = mesh.pinned("send", send.shape, send.dtype)
        host_in.copy_(send)
        host_out = mesh.pinned("recv", out_shape, send.dtype)
        dist.all_to_all_single(host_out, host_in, out_splits, in_splits,
                               group=mesh.group)
        out = torch.empty(out_shape, dtype=send.dtype, device=send.device)
        out.copy_(host_out)
        mesh.stats["staged_bytes"] += (host_in.numel() + host_out.numel()) \
            * send.element_size()
    else:
        if mesh.backend == "nccl" and not send.is_cuda:
            raise ValueError("the nccl backend exchanges CUDA tensors only; "
                             "run the plan on the process's CUDA device")
        out = torch.empty(out_shape, dtype=send.dtype, device=send.device)
        dist.all_to_all_single(out, send, out_splits, in_splits, group=mesh.group)
    mesh.stats[f"sent_bytes_{axis}"] += (send.shape[0] - own) * row
    if label:
        key = f"sent_bytes_{axis}:{label}"
        mesh.stats[key] = mesh.stats.get(key, 0) + (send.shape[0] - own) * row
    mesh.stats["collectives"] += 1
    return out
