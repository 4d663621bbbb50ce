"""Measured scaling harness over the port's operator stack.

The paper's figures model every wall with the Blue Waters constants.
This module measures instead, as the JAX package's ``mesh.scaling`` does:

* :func:`measure_spmv`: end-to-end ``op @ x`` walls through
  ``repro_torch.api.operator`` (pack, device program, fetch, unpack),
  best of ``repeats`` after a warm-up apply.
* :func:`measure_phase_walls`: per-phase EXCHANGE walls.  Each phase of
  the plan's :func:`repro_torch.comm.cost.planned_traffic` runs as a bare
  exchange through :mod:`repro_torch.mesh.comm` over the same mesh axis,
  with the plan's slot count and pad, timed alone.  These are the records
  :meth:`repro_torch.core.cost_model.PostalParams.calibrated` fits: in a
  multi-process job the ``node`` and ``("node", "proc")`` phases cross
  processes and the ``proc`` phases stay inside one.
* :func:`scaling_sweep`: a weak / strong ladder over (n_nodes, ppn)
  shapes x comm methods (standard vs nap vs multistep), emitting walls,
  comm fractions and calibration records.

Every process of a job runs the same calls (the exchanges are
collectives); each wall is the slowest process's.  Run as a module, or
as a script under :func:`repro_torch.mesh.launcher.launch` (it attaches
to the job the ``REPRO_MESH_*`` variables describe)::

    PYTHONPATH=src python -m repro_torch.mesh.scaling config.json [out.json]
    launch("src/repro_torch/mesh/scaling.py", 2,
           args=["config.json", "out.json"])

``config.json`` may override any :data:`DEFAULT_CONFIG` key, including
``"device"`` (``"cpu"`` to run off the card).  Times are host walls
around work that ends in a device synchronise.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["DEFAULT_CONFIG", "measure_phase_walls", "measure_spmv",
           "scaling_sweep", "calibration_records", "main"]

DEFAULT_CONFIG: Dict[str, object] = {
    "mode": "strong",            # "strong" (fixed n) | "weak" (n per rank)
    "n_rows": 1024,              # strong: global rows; weak: rows PER RANK
    "nnz_per_row": 8,
    "seed": 0,
    "matrix": {"kind": "random"},  # or {"kind": "suitesparse_like",
                                   #     "name": ..., "scale": ...}
    "partition": "contiguous",   # contiguous | strided | balanced
    "ladder": [[1, 2], [2, 2], [2, 4]],   # (n_nodes, ppn) shapes
    "methods": ["standard", "nap", "multistep"],
    "repeats": 3,
    "device": None,              # None: CUDA; "cpu" on request
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _slowest(seconds: float) -> float:
    """The largest of every process's ``seconds`` (one process: itself)."""
    from repro_torch.mesh.buffers import _dist, is_multiprocess
    if not is_multiprocess():
        return seconds
    walls = [None] * _dist().get_world_size()
    _dist().all_gather_object(walls, float(seconds))
    return max(walls)


def _best_of(fn, repeats: int, device: torch.device) -> float:
    best = float("inf")
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return _slowest(best)


def _axis_slots(phase: str, topo: Topology):
    """(mesh axis, slot count) the programs use for one exchange phase."""
    if phase == "inter":
        return "node", topo.n_nodes
    if phase in ("direct", "pair"):
        return "nodexproc", topo.n_procs
    return "proc", topo.ppn           # full / init / final: intra-node


def measure_phase_walls(plan, topo: Topology, bytes_per_val: int = 4,
                        repeats: int = 3, device: DeviceLike = None
                        ) -> List[Dict[str, object]]:
    """Measured wall per exchange phase of ``plan`` (standalone timers).

    Each non-empty phase of :func:`repro_torch.comm.cost.planned_traffic`
    runs as a bare exchange through :mod:`repro_torch.mesh.comm` over the
    SAME mesh axis with the plan's slot count and pad: the exchange the
    program issues, minus local compute.  In a multi-process job each
    process exchanges its node block's buffer ``[P_loc, n_slots, pad]``.
    The standard plan's flat pair exchange (accounted as ``pair_inter`` +
    ``pair_intra``) is one collective and is timed once, as ``pair``.

    Records carry the reference's keys: ``n_msgs`` / ``nbytes`` per
    BOTTLENECK RANK (the postal model's charging) and the measured
    ``seconds``, the shape :meth:`PostalParams.calibrated` consumes.  One
    key is the port's own: ``proc_bytes``, the padded buffer one
    process's bare exchange moves (its ranks' ``n_slots x pad`` values),
    which is what ``seconds`` times when a process batches many ranks.
    """
    from repro_torch.comm.cost import planned_traffic
    from repro_torch.mesh.buffers import plan_mesh
    from repro_torch.mesh.comm import exchange

    dev = resolve_device(device)
    traffic = planned_traffic(plan, bytes_per_val=bytes_per_val)
    phases: Dict[str, Dict] = {}
    for name, ph in traffic["phases"].items():
        if ph["n_msgs"] == 0:
            continue
        if name.startswith("pair_"):   # one flat collective, two entries
            merged = phases.setdefault("pair", dict(ph, inter=True))
            merged["max_rank_msgs"] = max(merged["max_rank_msgs"],
                                          ph["max_rank_msgs"])
            continue
        phases[name] = ph

    mesh = plan_mesh(topo)
    n_local = topo.n_procs if mesh is None else mesh.n_local_procs
    walls: List[Dict[str, object]] = []
    for name, ph in phases.items():
        axis, n_slots = _axis_slots(name, topo)
        pad = int(ph["pad"])
        x = torch.randn((n_local, n_slots, pad, 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
        exchange(axis, x, topo, mesh)          # warm-up
        wall = _best_of(lambda: exchange(axis, x, topo, mesh), repeats, dev)
        walls.append({
            "phase": name,
            "inter": bool(ph["inter"]),
            "axis": axis,
            "n_slots": int(n_slots),
            "pad": pad,
            # bottleneck-rank charging, matching postal_phase_time
            "n_msgs": int(ph["max_rank_msgs"]),
            "nbytes": int(ph["max_rank_msgs"]) * pad * bytes_per_val,
            "proc_bytes": n_local * int(n_slots) * pad * bytes_per_val,
            "seconds": float(wall),
        })
        del x
    return walls


def calibration_records(sweep: Dict[str, object]) -> List[Dict[str, object]]:
    """Flatten a :func:`scaling_sweep` payload into the wall records
    :meth:`PostalParams.calibrated` fits (one per measured phase)."""
    recs: List[Dict[str, object]] = []
    for point in sweep["points"]:
        for m in point["methods"].values():
            recs.extend(m["phase_walls"])
    return recs


def _build_matrix(cfg: Dict[str, object], n_rows: int, seed: int):
    mcfg = dict(cfg.get("matrix") or {"kind": "random"})
    if mcfg.get("kind") == "suitesparse_like":
        from repro_torch.sparse import suitesparse_like
        return suitesparse_like.build(mcfg["name"], scale=int(mcfg["scale"]))
    from repro_torch.sparse import random_fixed_nnz
    return random_fixed_nnz(n_rows, int(cfg.get("nnz_per_row", 8)), seed=seed)


def _build_partition(kind: str, a, n_procs: int):
    from repro_torch.core.partition import make_partition
    if kind == "balanced":
        return make_partition("balanced", a.shape[0], n_procs,
                              a.indptr, a.indices)
    return make_partition(kind, a.shape[0], n_procs)


def measure_spmv(a, part, topo: Topology, method: str, repeats: int = 3,
                 device: DeviceLike = None) -> Dict[str, object]:
    """Measured ``op @ x`` wall and per-phase exchange walls for one
    (matrix, partition, topology, method) point on the device programs."""
    import repro_torch.api as nap

    dev = resolve_device(device)
    op = nap.operator(a, topo=topo, part=part, method=method, cache=False,
                      device=dev)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(a.shape[1])
    op @ v                                  # warm-up: compile + stage
    wall = _best_of(lambda: op @ v, repeats, dev)
    compiled = op.executor.compiled
    plan = compiled.ms_plan if method == "multistep" else compiled.plan
    phase_walls = measure_phase_walls(plan, topo, repeats=repeats, device=dev)
    comm_wall = sum(w["seconds"] for w in phase_walls)
    return {
        "wall_s": float(wall),
        "comm_wall_s": float(comm_wall),
        "comm_fraction": float(min(1.0, comm_wall / wall)) if wall else 0.0,
        "phase_walls": phase_walls,
    }


def scaling_sweep(config: Optional[Dict[str, object]] = None
                  ) -> Dict[str, object]:
    """Run the ladder described by ``config`` (see :data:`DEFAULT_CONFIG`).

    A process batches any number of ranks, so every shape runs; in a
    multi-process job a shape whose ``n_nodes`` is not a multiple of the
    process count is skipped (recorded under ``"skipped"``, never
    truncated), as is one with more ranks than rows.
    """
    from repro_torch.mesh.buffers import process_count
    from repro_torch.mesh.discover import discovery_report

    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    world = process_count()
    points: List[Dict[str, object]] = []
    skipped: List[Dict[str, object]] = []
    for nn, ppn in cfg["ladder"]:
        topo = Topology(n_nodes=int(nn), ppn=int(ppn))
        if topo.n_nodes % world:
            skipped.append({"n_nodes": nn, "ppn": ppn,
                            "reason": f"{nn} nodes do not split over "
                                      f"{world} processes"})
            continue
        n_rows = (int(cfg["n_rows"]) * topo.n_procs
                  if cfg["mode"] == "weak" else int(cfg["n_rows"]))
        a = _build_matrix(cfg, n_rows, int(cfg["seed"]))
        if a.shape[0] < topo.n_procs:
            skipped.append({"n_nodes": nn, "ppn": ppn,
                            "reason": f"{a.shape[0]} rows < "
                                      f"{topo.n_procs} ranks"})
            continue
        part = _build_partition(str(cfg["partition"]), a, topo.n_procs)
        methods = {}
        for method in cfg["methods"]:
            methods[str(method)] = measure_spmv(
                a, part, topo, str(method), repeats=int(cfg["repeats"]),
                device=cfg["device"])
        points.append({
            "n_nodes": topo.n_nodes, "ppn": topo.ppn,
            "n_rows": int(a.shape[0]), "nnz": int(a.nnz),
            "mode": cfg["mode"], "methods": methods,
        })
    return {"config": cfg, "discovery": discovery_report(),
            "points": points, "skipped": skipped}


def main(argv: List[str]) -> int:
    """Entry point: read the config, sweep, write JSON (process 0 writes
    ``out.json`` or prints)."""
    if not argv or len(argv) > 2:
        print("usage: python -m repro_torch.mesh.scaling config.json [out.json]",
              file=sys.stderr)
        return 2
    from repro_torch.mesh.buffers import _dist
    with open(argv[0]) as f:
        cfg = json.load(f)
    out = scaling_sweep(cfg)
    if _dist() is not None and _dist().get_rank() != 0:
        return 0
    payload = json.dumps(out, indent=2)
    if len(argv) == 2:
        with open(argv[1], "w") as f:
            f.write(payload)
    else:
        print(payload)
    return 0


if __name__ == "__main__":
    from repro_torch.mesh.launcher import attach, detach
    attach(verbose=True)
    try:
        code = main(sys.argv[1:])
    finally:
        detach()
    raise SystemExit(code)
