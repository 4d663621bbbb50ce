"""Multi-process mesh runtime of the port: launcher, topology discovery,
buffers and placement, the communicator, the scaling harness.

* :mod:`repro_torch.mesh.launcher`: the ``torch.distributed`` launcher
  (subprocess fan-out, ``REPRO_MESH_*`` env attach; gloo on the CPU,
  nccl on CUDA unless gloo is asked for).
* :mod:`repro_torch.mesh.discover`: ``discover_topology()`` derives
  ``Topology(processes, ppn)`` from the live job;
  ``repro_torch.api.operator`` discovers when ``topo`` is omitted.
* :mod:`repro_torch.mesh.buffers`: the device-buffer registry, and the
  one seam that knows about processes: each process owns a block of
  whole nodes (``mesh_for``), stages its rows and all-gathers results.
* :mod:`repro_torch.mesh.comm`: the ``node`` and ``("node", "proc")``
  all-to-alls under the programs' exchanges, permutations in one process
  and ``all_to_all_single`` across processes.
* :mod:`repro_torch.mesh.scaling`: measured per-phase exchange walls
  and the scaling ladder that ``PostalParams.calibrated`` fits.

Importing the package starts no process and touches no device.
"""
from repro_torch.mesh.buffers import (BufferNamespace, BufferRegistry,
                                      ProcessMesh, broadcast_from_first,
                                      default_registry, fetch_mesh_array,
                                      gather_from_all, input_stager,
                                      is_first_process,
                                      is_multiprocess, job_barrier, mesh_for,
                                      process_count, stage_mesh_array)
from repro_torch.mesh.discover import (DiscoveryError, discover_topology,
                                       discovery_report)
from repro_torch.mesh.launcher import (LaunchError, LaunchResult, attach,
                                       detach, launch, mesh_env,
                                       pick_coordinator)

__all__ = [
    "BufferNamespace", "BufferRegistry", "default_registry", "ProcessMesh",
    "broadcast_from_first", "fetch_mesh_array", "gather_from_all", "input_stager",
    "is_first_process", "is_multiprocess", "job_barrier", "mesh_for",
    "process_count", "stage_mesh_array",
    "DiscoveryError", "discover_topology", "discovery_report",
    "LaunchError", "LaunchResult", "attach", "detach", "launch",
    "mesh_env", "pick_coordinator",
]
