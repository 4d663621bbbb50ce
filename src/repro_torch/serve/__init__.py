"""Fault-tolerant persistent solver service over the port's operators.

Public surface::

    from repro_torch.serve import SolverService, FaultPlan, dead_node

    svc = SolverService(topo, checkpoint_dir="/path/to/ckpt",
                        fault_plan=FaultPlan.of(dead_node(3, "node1")))
    svc.register_matrix("poisson", A)
    t = svc.submit("tenant-a", "poisson", b, kind="solve", deadline=50.0)
    svc.run()
    x = t.result()

The device programs run on CUDA unless ``device="cpu"`` is passed;
``backend="simulate"`` runs the float64 host simulators.  See
:mod:`repro_torch.serve.service` for the lifecycle (admit, batch, solve,
recover) and :mod:`repro_torch.serve.faultplan` for the fault script.
"""
from repro_torch.serve.faultplan import (FabricError, FaultEvent, FaultPlan,
                                         ManualClock, corrupt_message,
                                         dead_node, drop_message,
                                         duplicate_message, straggler,
                                         torn_checkpoint)
from repro_torch.serve.plancache import (PlanCache, release_operator_buffers,
                                         structure_key, values_fingerprint)
from repro_torch.serve.service import (REJECT_BAD_OPERAND,
                                       REJECT_DEADLINE_UNMEETABLE,
                                       REJECT_FLEET_DEGRADED, REJECT_QUEUE_FULL,
                                       REJECT_UNKNOWN_MATRIX, Request,
                                       SolverService, Ticket, batched_cg)

__all__ = [
    "SolverService", "Request", "Ticket", "batched_cg",
    "PlanCache", "release_operator_buffers", "structure_key",
    "values_fingerprint",
    "FaultPlan", "FaultEvent", "FabricError", "ManualClock",
    "dead_node", "straggler", "torn_checkpoint", "corrupt_message",
    "drop_message", "duplicate_message",
    "REJECT_QUEUE_FULL", "REJECT_DEADLINE_UNMEETABLE",
    "REJECT_UNKNOWN_MATRIX", "REJECT_BAD_OPERAND", "REJECT_FLEET_DEGRADED",
]
