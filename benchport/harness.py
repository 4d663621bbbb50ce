"""Find a cell's pieces by name, run it, and make the result line.

``BENCHMARK.json`` names the cell's configuration (its ``file``), its
traffic (``traffic/<name>.json``, whose ``kind`` names the driver in
``kinds/<kind>.py``) and the metrics (``metrics/<name>.py``, one reader
each).  Nothing here knows a cell, a configuration or a metric by name.
"""
from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from benchport import yardstick

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "benchport"
#: top-level module names that no run may load (the JAX package is ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchport/<kind>/<name>.py`` as a module of its own."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"benchport_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def resolve(workload: str, bench: Optional[dict] = None) -> Tuple[dict, dict, dict, dict]:
    """``(bench, cell, config, traffic)`` of one cell, by name."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = _named(bench["workloads"], workload, "workload")
    entry = _named(bench["configs"], cell["config"], "config")
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def metrics_of(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    ``trace`` the per-layer ones, each where its ``workloads`` (if given)
    name the cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell["name"] in m["workloads"]]


def read_metrics(entries: List[dict], record: dict) -> Dict[str, dict]:
    """Each metric's reader over the run's record; a reader that finds
    nothing to read returns None, and the metric is left out."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def loaded_forbidden(modules=None) -> List[str]:
    """Loaded modules of the JAX package, JAX itself or ``benchmarks/``,
    compared by whole top-level name, and any module loaded from a file
    under ``benchmarks/``."""
    modules = sys.modules if modules is None else modules
    bench_dir = str(ROOT / "benchmarks") + "/"
    found = set()
    for name, mod in list(modules.items()):
        if name.split(".", 1)[0] in FORBIDDEN:
            found.add(name)
        elif str(getattr(mod, "__file__", None) or "").startswith(bench_dir):
            found.add(name)
    return sorted(found)


def card_line() -> str:
    """The card's name and power limit from ``nvidia-smi``, beside the
    published peaks that the rooflines use."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi not read ({e})"
    return (f"card: {smi}; published peaks (H100 SXM, 700 W): HBM "
            f"{yardstick.HBM_BYTES_PER_S / 1e12} TB/s, f32 "
            f"{yardstick.F32_FLOPS / 1e12} TFLOP/s, bf16 "
            f"{yardstick.BF16_FLOPS / 1e12} TFLOP/s")


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each compared number beside its limit; correct when every number
    with a limit is finite and at most its limit, and none lacks one."""
    out, ok = {}, True
    for name, value in checks.items():
        if name == "compared":
            continue
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, out


def result_line(record: dict, metrics: Dict[str, dict], device: dict,
                limits: Dict[str, float], trace: bool) -> dict:
    ok, checks = judge(record["checks"], limits)
    ok = ok and record["failed"] == 0 and record["checks"].get("compared", 0) >= 1
    line = {"correct": ok, "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics, "device": device}
    if trace and record.get("trace"):
        line["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                             "idle_gaps": record["trace"]["idle_gaps"]}
    line["checks"] = checks
    return line
