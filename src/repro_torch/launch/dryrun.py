"""The dry run: count every (arch x shape x mesh) cell and its roofline on
the H100.  The port's counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 256- and 512-chip TPU
meshes and reads the HLO.  Here each cell's program runs once on
``meta`` (no memory, no card) under the operator counter
(:func:`repro_torch.launch.steps.count_cell`), and the count is the
GLOBAL program's.  On the 16x16 and 2x16x16 meshes a chip's FLOPs, bytes
and exchanges are the global count divided by the chips: the ideal
sharding (``"per_chip": "global / chips"``; the reference's figures
include GSPMD's redundancy, which the port does not model).  The
one-card mesh (``"1"``, ``--one-card``) is the program exactly as the
port runs it on one card, the figure a card run can check.

Per cell the record (an incremental JSON; finished cells are skipped
unless ``--force``) keeps the reference's keys, with ``ops`` in place of
``hlo``, ``t_count_s`` in place of the lowering and compile times,
``memory.analytic`` (the reference's per-device budgets, exactly) and no
``xla_cost`` or XLA ``memory_analysis``, which have no counterpart.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out out.json]
  python -m repro_torch.launch.dryrun --all --both-meshes --one-card
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Dict, List, Optional

from repro_torch.configs import all_arch_ids
from repro_torch.configs.shapes import SHAPES, cell_runnable
from repro_torch.core.op_analysis import OpCost
from repro_torch.core.roofline import H100_SXM, build_roofline, model_flops_for
from repro_torch.launch.mesh import ProductionMesh, make_production_mesh
from repro_torch.launch.steps import build_cell, count_cell

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch.json"
ONE_CARD = "1"
# the form a cell's program is counted in, where it is not its config's,
# by (arch, kind or None for every kind): rwkv6's stepwise recurrence runs a
# Python step a token (32768 steps x 32 layers at prefill_32k: hours of
# counting on meta), so its cells count the chunked WKV, the same function
# (``models/rwkv.py``; decode is one step either way) whose log decays are
# -exp(w0 + LoRA) themselves, not the log of the decay w (no exp and log
# pass between, and no -inf where w underflows); qwen3-moe's config
# ships a bf16 wire, on which the island has no gradient and raises, so
# its training cells count the f32 wire it trains on (``launch.train``)
COUNT_FORMS = {("rwkv6-3b", None): {"rwkv_chunk": 64},
               ("qwen3-moe-235b-a22b", "train"): {"wire_dtype": "f32"}}


def counted_form(arch: str, shape_name: str) -> Dict:
    kind = SHAPES[shape_name].kind
    return {**COUNT_FORMS.get((arch, None), {}), **COUNT_FORMS.get((arch, kind), {})}
NO_XLA = ("no XLA in the port: no xla_cost and no memory_analysis; "
          "memory.analytic is the reference's per-device budget")


def mesh_for(mesh_name: str) -> ProductionMesh:
    """``"16x16"`` (256 chips), ``"2x16x16"`` (512, two pods) or ``"1"``."""
    if mesh_name == ONE_CARD:
        return ProductionMesh(("data", "model"), (1, 1))
    multi_pod = mesh_name == "2x16x16"
    # the dry run's cells are defined at 256 / 512 chips whatever is present
    return make_production_mesh(multi_pod=multi_pod, n_devices=512 if multi_pod else 256,
                                n_pods=2)


def per_chip(cost: OpCost, chips: int) -> OpCost:
    """The global count over ``chips`` (the ideal sharding)."""
    out = OpCost()
    out.add(cost, 1.0 / chips)
    out.group_sizes = {k: list(v) for k, v in cost.group_sizes.items()}
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str,
             overrides: Optional[Dict] = None, device="meta") -> dict:
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False}
    if overrides:
        rec["overrides"] = overrides
    form = {k: v for k, v in counted_form(arch, shape_name).items()
            if k not in (overrides or {})}
    if form:
        rec["counted_form"] = form
        overrides = {**form, **(overrides or {})}
    runnable, why = cell_runnable(arch, shape_name)
    if not runnable:
        rec.update(skipped=True, reason=why, ok=True)
        return rec
    try:
        mesh = mesh_for(mesh_name)
        chips = mesh.size
        t0 = time.perf_counter()
        cell = build_cell(arch, shape_name, mesh, overrides=overrides, device=device)
        cost = count_cell(cell)
        t_count = time.perf_counter() - t0
        chip_cost = per_chip(cost, chips)
        mf = model_flops_for(cell.kind, cell.n_active_params, cell.tokens)
        roof = build_roofline(arch, shape_name, mesh_name, chips, chip_cost, mf, H100_SXM)
        ops = cost.as_dict()
        ops.update(per_chip="global / chips",
                   dot_flops_per_chip=chip_cost.dot_flops,
                   hbm_bytes_per_chip=chip_cost.hbm_bytes,
                   collective_bytes_per_chip=dict(chip_cost.collective_bytes),
                   dci_bytes_per_chip=chip_cost.dci_bytes,
                   activation_sites=len(cost.activations))
        rec.update(
            ok=True, kind=cell.kind, chips=chips, device=str(device),
            t_count_s=round(t_count, 2), island=cell.island,
            memory={"analytic": cell.analytic_gb, "note": NO_XLA},
            ops=ops,
            roofline={"chip": roof.chip.name, "t_compute": roof.t_compute,
                      "t_memory": roof.t_memory, "t_collective": roof.t_collective,
                      "t_collective_wire": roof.t_collective_wire,
                      "dominant": roof.dominant, "mfu": roof.mfu,
                      "model_flops": mf, "useful_ratio": roof.useful_ratio,
                      "row": roof.row()},
            tokens=cell.tokens, n_active_params=cell.n_active_params,
        )
    except Exception as e:  # noqa: BLE001 - a failed cell is a result
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def load_results(path: pathlib.Path) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {"cells": {}}


def save_results(path: pathlib.Path, results: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))


def cell_key(arch: str, shape: str, mesh_name: str) -> str:
    return f"{arch}|{shape}|{mesh_name}"


def parse_overrides(pairs: List[str]) -> Dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"true": True, "false": False}.get(v.lower(), v)
        overrides[k] = v
    return overrides


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--one-card", action="store_true",
                    help="also count the one-card mesh: the program as the port runs it")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value; results stored under a "
                         "suffixed cell key")
    ap.add_argument("--tag", default="",
                    help="suffix for the cell key of an override run")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    out = pathlib.Path(args.out)
    results = load_results(out)
    if args.all:
        archs, shapes = all_arch_ids(), list(SHAPES)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        archs, shapes = [args.arch], [args.shape]
    meshes = ["16x16", "2x16x16"] if args.both_meshes else \
        ["2x16x16" if args.multi_pod else "16x16"]
    if args.one_card:
        meshes.append(ONE_CARD)

    failures = 0
    t_start = time.perf_counter()
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                key = cell_key(arch, shape, mesh_name)
                if args.tag:
                    key += f"#{args.tag}"
                if not args.force and results["cells"].get(key, {}).get("ok"):
                    print(f"[skip] {key} (cached)")
                    continue
                print(f"[run ] {key} ...", flush=True)
                rec = run_cell(arch, shape, mesh_name, overrides=overrides or None)
                results["cells"][key] = rec
                save_results(out, results)
                if not rec["ok"]:
                    failures += 1
                    print(f"       FAIL: {rec['error']}")
                elif rec.get("skipped"):
                    print(f"       SKIP: {rec['reason']}")
                else:
                    r = rec["roofline"]
                    print(f"       ok count={rec['t_count_s']}s "
                          f"analytic={rec['memory']['analytic']['total']:.2f}GB "
                          f"dom={r['dominant']} mfu={r['mfu']*100:.1f}%")
    print(f"done in {time.perf_counter() - t_start:.1f} s; {failures} failures -> {out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
