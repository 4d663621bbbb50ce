"""Run one cell of the port's benchmark and print its result line.

    python3 benchport/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  It needs a
CUDA card (as many as the cell asks for) and exits non-zero, printing
no result, without one, when the program cannot be imported, or when a
module of JAX, of the JAX package (``repro``) or of ``benchmarks/`` is
loaded in this process.  Set-up time counts from the start of this
file; the kernels that the program builds go to ``build/`` in the
checkout, and the caches below are fixed there too.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "benchport" / sub)
    # the program and this package, not this file's folder by bare names
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        q for q in sys.path if pathlib.Path(q or ".").resolve() != ROOT / "benchport"]

    import torch
    from benchport import harness

    bench, cell, config, traffic = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(harness.card_line(), file=sys.stderr)
    kind = harness.load_module("kinds", traffic["kind"])
    setup = {}

    def setup_done():
        setup["s"] = time.perf_counter() - T0
        setup["loaded"] = harness.loaded_forbidden()

    record = kind.run(config, traffic, args.seed, args.seconds, bool(args.trace),
                      "cuda", mark_setup_done=setup_done)
    record["setup_s"] = setup["s"]
    bad = sorted(set(setup["loaded"]) | set(harness.loaded_forbidden()))
    if bad:
        print(f"error: modules of JAX, the JAX package or benchmarks/ were "
              f"loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"set-up {record['setup_s']:.3f} s (generate {record['generate_s']:.3f} s, "
          f"plan {record['plan_build_s']:.3f} s, local compute "
          f"{record['local_compute']}); window {record['window']['seconds']:.3f} s, "
          f"{record['attempted']} requests; check {record['check_s']:.3f} s", file=sys.stderr)
    metrics = harness.read_metrics(harness.metrics_of(bench, cell, bool(args.trace)),
                                   record)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(record["peak_bytes"])}
    if args.trace:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
    line = harness.result_line(record, metrics, device, config["limits"],
                                  bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
