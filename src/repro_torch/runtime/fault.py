"""Fault tolerance runtime: heartbeats, straggler detection, elastic rescale.

On a real fleet each host runs the HeartbeatMonitor against its peers (or a
coordination service); here the components are clock-injectable so the tests
simulate dead nodes and stragglers deterministically.  The recovery path is:

  detector fires -> ElasticPolicy proposes a surviving mesh ->
  the caller rebuilds on it -> checkpoint/store.py restore (full-leaf
  arrays, moved to the device the caller names) -> work resumes from
  the checkpointed state.  The solver service
  (:mod:`repro_torch.serve.service`) runs this path for the SpMV fleet.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class HeartbeatMonitor:
    """Tracks per-node heartbeats; a node silent for ``timeout`` is dead."""

    def __init__(self, nodes: Sequence[str], timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last: Dict[str, float] = {n: clock() for n in nodes}

    def beat(self, node: str, register: bool = False) -> None:
        """Record a heartbeat.  Beating an UNKNOWN node raises ``KeyError``
        unless ``register=True`` — silently auto-registering meant a typo'd
        node name looked healthy forever while the real node timed out."""
        if node not in self.last and not register:
            raise KeyError(
                f"heartbeat from unregistered node {node!r} (known: "
                f"{sorted(self.last)}); pass register=True to add it")
        self.last[node] = self.clock()

    def dead_nodes(self) -> List[str]:
        now = self.clock()
        return [n for n, t in self.last.items() if now - t > self.timeout]

    def healthy(self) -> bool:
        return not self.dead_nodes()


class StragglerDetector:
    """Per-node step-time z-score detector over a sliding window.

    A node whose step time exceeds mean + z_thresh * std of the fleet (and a
    relative floor) is flagged; the launcher response is to checkpoint and
    rebalance (drop the node via ElasticPolicy) or re-route its shard.
    """

    def __init__(self, window: int = 32, z_thresh: float = 3.0,
                 rel_floor: float = 1.5):
        self.window = window
        self.z = z_thresh
        self.rel_floor = rel_floor
        self.times: Dict[str, deque] = {}

    def record(self, node: str, step_time: float) -> None:
        self.times.setdefault(node, deque(maxlen=self.window)).append(step_time)

    def stragglers(self) -> List[str]:
        means = {n: float(np.mean(t)) for n, t in self.times.items() if t}
        if len(means) < 2:
            return []
        vals = np.array(list(means.values()))
        mu, sd = float(vals.mean()), float(vals.std())
        out = []
        for n, m in means.items():
            if m > mu * self.rel_floor and (sd == 0 or (m - mu) / max(sd, 1e-9)
                                            > self.z):
                out.append(n)
        return out


@dataclasses.dataclass
class ElasticPolicy:
    """Given the production mesh and dead nodes, propose the survivor mesh.

    The data axis absorbs the loss (batch is re-sharded; global batch is
    preserved by increasing per-chip microbatches), the model axis is never
    shrunk (params are sharded over it), and a pod that loses too many nodes
    is dropped whole.  Checkpoint restore handles the re-shard (store.py).
    """
    min_data: int = 1

    def propose(self, mesh_shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                n_dead_nodes: int, chips_per_node: int = 4
                ) -> Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
        shape = dict(zip(axis_names, mesh_shape))
        dead_chips = n_dead_nodes * chips_per_node
        data = shape.get("data", 1)
        model = shape.get("model", 1)
        pods = shape.get("pod", 1)
        chips_per_data_row = model
        rows_lost = -(-dead_chips // chips_per_data_row)
        new_data = data - rows_lost
        if new_data >= self.min_data:
            shape["data"] = new_data
            return tuple(shape[a] for a in axis_names), axis_names
        if pods > 1:  # drop a whole pod, restore data axis
            shape["pod"] = pods - 1
            shape["data"] = data
            return tuple(shape[a] for a in axis_names), axis_names
        return None  # fleet too degraded

    def global_batch_plan(self, global_batch: int, old_data: int,
                          new_data: int) -> Tuple[int, int]:
        """(per_row_batch, grad_accum_multiplier) preserving global batch
        EXACTLY: ``per_row_batch * new_data * accum == global_batch``.

        Contract: ``new_data`` must divide ``global_batch`` (the data axis
        re-shards whole examples; a non-divisible shrink would change the
        effective batch and thus the optimiser trajectory — callers that
        cannot satisfy it must change ``global_batch`` explicitly instead
        of silently training on a different batch).  ``accum`` is the
        smallest multiplier keeping the per-row microbatch at or below the
        pre-shrink ``global_batch // old_data``.
        """
        if global_batch % new_data != 0:
            raise ValueError(
                f"global batch {global_batch} is not divisible by the "
                f"surviving data-axis size {new_data}; pick a new global "
                f"batch explicitly rather than silently changing it")
        per_old = max(1, global_batch // old_data)
        total_per_row = global_batch // new_data  # = per_row_batch * accum
        accum = -(-total_per_row // per_old)      # smallest with per_row <= per_old
        while total_per_row % accum:              # bounded: accum <= total_per_row
            accum += 1
        per_row = total_per_row // accum
        assert per_row * new_data * accum == global_batch
        return per_row, accum

    def survivor_topology(self, topo, dead_nodes: Sequence) -> Optional[object]:
        """Node-drop rule for the SOLVER mesh (:class:`repro_torch.core.
        topology.Topology`): dead nodes leave whole (their ppn ranks go with them),
        survivors keep the per-node process count.  Returns the survivor
        :class:`Topology`, or ``None`` when the fleet is too degraded
        (no node left) — the caller sheds load instead of deadlocking."""
        from repro_torch.core.topology import Topology

        alive = topo.n_nodes - len(set(dead_nodes))
        if alive < 1:
            return None
        return Topology(n_nodes=alive, ppn=topo.ppn)
