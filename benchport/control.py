"""The readings that set the limits of ``correct``: the program's compared
numbers over many seeds, and the control's over a few.

    python3 benchport/control.py --config <name> --traffic <mix> [<mix> ...]
        --seeds <n> ... --control-seeds <n> ... [--out <file.jsonl>]

For each seed the configuration is built (once for all seeds when its
matrix does not depend on the seed), and each traffic mix runs its
chain until it has passed ``sample_within`` requests, so that as many
requests are compared as in a run, then the run's check.  The control
puts the reference computed in bfloat16 (the precision below the
float32 that the configurations state) in the program's place and is
checked the same way; it has to fail a limit.  ``--fault <name>`` reads
a fault of ``faults.py`` the same way (``--control-seeds`` then name
its seeds).  Each reading is the cell's own run with no measured
window, judged by the harness.  The benchmark's own runs never run the
control or a fault.  Prints one JSON line a reading (with the harness's
``correct``), then each number's lowest and highest program reading,
the lowest control reading, and how many runs of each came out correct.
"""
import argparse
import collections
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(config: dict, traffics: dict, seeds, control_seeds, device, emit,
             fault=None) -> list:
    """``fault`` (a name of ``faults.py``) puts that fault in the
    control's place.  Each reading is a run of the cell's own driver
    (``kinds/spmv_chain.py::run``) with no measured window, judged by the
    harness's own comparison (``harness.result_line``)."""
    import contextlib
    from benchport import faults, harness, reference
    from benchport.kinds import spmv_chain as kind
    other = "control" if fault is None else fault
    out, problem, ref = [], None, None
    gen = harness.load_module("problems", config["generator"])
    for who, seed_list in (("program", seeds), (other, control_seeds)):
        for seed in seed_list:
            if problem is None or gen.SEEDED:
                if problem is not None:
                    problem.release()
                problem = ref = None
                problem = kind.Problem(config, seed, device)
                ref = reference.Reference(*problem.csr, device=problem.device)
            for name, traffic in traffics.items():
                programs, broken = None, contextlib.nullcontext()
                if who == "control":
                    programs = kind.control_programs
                elif who == "exchange_left_out":
                    broken = faults.exchange_left_out()
                elif who != "program":
                    programs = faults.FAULTS[who]
                with broken:
                    record = kind.run(config, traffic, seed, 0.0, False, device,
                                      programs,
                                      min_requests=int(traffic["sample_within"]),
                                      problem=problem, ref=ref)
                line = harness.result_line(record, {}, {}, config["limits"], False)
                row = {"who": who, "config": config["name"], "traffic": name,
                       "seed": seed, "requests": record["attempted"],
                       "correct": line["correct"], "checks": record["checks"]}
                emit(row)
                out.append(row)
    return out


def summary(rows: list) -> dict:
    """Per traffic and number: the program's lowest and highest reading
    and each other reader's lowest; per traffic and reader, how many of
    its runs the harness judged correct."""
    acc = collections.defaultdict(lambda: collections.defaultdict(list))
    judged = collections.defaultdict(lambda: [0, 0])
    for r in rows:
        judged[f"{r['traffic']}.{r['who']}"][0] += int(r["correct"])
        judged[f"{r['traffic']}.{r['who']}"][1] += 1
        for k, v in r["checks"].items():
            if k != "compared":
                acc[(r["traffic"], k)][r["who"]].append(v)
    out = {}
    for (t, k), v in sorted(acc.items()):
        progs = v.pop("program", [])
        out[f"{t}.{k}"] = {"program_min": min(progs, default=None),
                           "program_max": max(progs, default=None)}
        out[f"{t}.{k}"].update({f"{who}_min": min(vals) for who, vals in v.items()})
    out["correct"] = {k: f"{c} of {n}" for k, (c, n) in sorted(judged.items())}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", help="a fault of faults.py in the control's place")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        q for q in sys.path if pathlib.Path(q or ".").resolve() != ROOT / "benchport"]
    from benchport import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    config = harness.load_json(ROOT / entry["file"])
    traffics = {t: harness.load_json(harness.HERE / "traffic" / f"{t}.json")
                for t in args.traffic}
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        rows = readings(config, traffics, args.seeds, args.control_seeds,
                        args.device, emit, args.fault)
    finally:
        if sink:
            sink.close()
    print(json.dumps({"summary": summary(rows), "limits": config["limits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
