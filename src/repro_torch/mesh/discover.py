"""Topology autodiscovery: derive ``Topology`` from the live job.

The paper's premise is exploiting the actual node-processor layout.
Discovery reads it from the running job instead of a declaration, as
the JAX package's ``mesh.discover`` does:

* ``n_nodes`` = the ``torch.distributed`` process count: one node per
  process (crossing processes is the expensive hop, exactly the paper's
  node boundary);
* ``ppn`` = ``REPRO_MESH_LOCAL_DEVICES``: the ranks a process batches on
  its device (the reference's local device count).

Rules:

* one process, no variable: ``Topology(1, 1)``, the declared default;
* one process: ``Topology(1, REPRO_MESH_LOCAL_DEVICES)``;
* several processes (after :func:`repro_torch.mesh.launcher.attach`):
  ``Topology(process_count, ppn)``.  Every process must batch the same
  ppn, because the SMP rank order assumes it: a ragged job raises
  :class:`DiscoveryError` rather than silently mislaying ranks.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.topology import Topology
from repro_torch.mesh.buffers import _dist, local_ranks, process_count

__all__ = ["DiscoveryError", "discover_topology", "discovery_report"]


class DiscoveryError(RuntimeError):
    """The live layout cannot be expressed as Topology(n_nodes, ppn)."""


def discover_topology(*, strict: bool = True) -> Topology:
    """The ``Topology`` of the running job (see module docstring).

    Across processes ``strict`` gathers every process's ppn (a collective:
    every process of the job calls it) and raises on a ragged layout;
    ``strict=False`` trusts the local count.
    """
    n_proc = process_count()
    ppn = local_ranks()
    if strict and n_proc > 1:
        peers = [None] * n_proc
        _dist().all_gather_object(peers, ppn)
        if len(set(peers)) != 1:
            raise DiscoveryError(
                f"non-uniform layout: the {n_proc} processes batch {peers} "
                f"ranks; Topology(n_nodes, ppn) needs every process to "
                f"batch the same count")
    return Topology(n_nodes=n_proc, ppn=ppn)


def discovery_report() -> Dict[str, object]:
    """Machine-readable view of what discovery saw, with the reference's
    keys (``device_count`` is the job's rank count, ``jax`` is False: the
    port never loads JAX)."""
    topo = discover_topology(strict=False)
    dist = _dist()
    return {
        "source": "torch.distributed",
        "jax": False,
        "n_nodes": topo.n_nodes,
        "ppn": topo.ppn,
        "process_index": 0 if dist is None else int(dist.get_rank()),
        "device_count": topo.n_procs,
        "platform": "cuda" if torch.cuda.is_available() else "cpu",
    }
