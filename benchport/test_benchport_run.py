"""CPU rehearsals of whole runs at a tiny size: the harness's look for a
card skipped, everything else as on the card.  A sound run is correct;
the control (the reference in bf16 in the program's place) and each
fault planted under the timed path come out not correct."""
import copy
import os
import subprocess
import sys
import time

import pytest

from benchport import faults, harness
from benchport.kinds import spmv_chain

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]


def tiny(workload):
    """The cell at a tiny size: 16 ranks on 4 nodes, a 24 x 24 grid or
    1,600 random rows, a sample drawn from the first 8 requests."""
    _, cell, config, traffic = harness.resolve(workload, BENCH)
    config = copy.deepcopy(config)
    if config["generator"] == "rotated_anisotropic_2d":
        config["params"]["n"] = 24
    else:
        config["params"]["n_rows"] = 1600
    config["topology"] = {"n_nodes": 4, "ppn": 4}
    config.pop("rows", None)
    config.pop("nnz", None)
    return cell, config, dict(traffic, sample_within=8, trace_requests=3)


def run(workload, seed=2 ** 31 + 11, trace=False, programs=None, operator=None):
    cell, config, traffic = tiny(workload)
    config["operator"].update(operator or {})
    t0, setup = time.perf_counter(), {}
    record = spmv_chain.run(config, traffic, seed, 0.25, trace, "cpu", programs,
                            lambda: setup.setdefault("s", time.perf_counter() - t0),
                            min_requests=traffic["sample_within"])
    record["setup_s"] = setup["s"]
    metrics = harness.read_metrics(harness.metrics_of(BENCH, cell, trace), record)
    line = harness.result_line(record, metrics, {"platform": "cpu"},
                                   config["limits"], trace)
    return record, line


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    record, line = run(workload)
    assert line["correct"], line["checks"]
    assert line["attempted"] == record["window"]["requests"] >= 8
    assert record["checks"]["compared"] >= 2
    assert list(line)[-1] == "checks"
    assert {"setup_s", "spmv_gflop_s", "request_p95_ms"} <= set(line["metrics"])


def test_traced_run_reads_host_metrics():
    """On the CPU the trace holds no device operation: the host-clock
    reader reads, the device-trace readers read nothing and are left
    out of the line."""
    record, line = run(next(c for c in CELLS if "block8" in c), trace=True)
    assert line["correct"]
    assert "plan_build_s" in line["metrics"]
    assert not {"apply_roofline", "ell_spmm_roofline"} & set(line["metrics"])
    assert record["trace"]["requests"] == 3
    assert "breakdown" in line


@pytest.mark.parametrize("operator", [{"method": "nap"}, {"method": "standard"},
                                      {"method": "multistep"}, {"comm": "auto"}],
                         ids=lambda o: "-".join(o.values()))
def test_config_operator_builds_its_method(operator):
    """The configuration's ``operator`` block is what the run builds: a
    configuration that says ``method: standard`` runs the standard
    method's programs, and they come out correct."""
    workload = next(c for c in CELLS if "block8" in c)
    record, line = run(workload, operator=operator)
    if "method" in operator:
        assert record["method"] == operator["method"]
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("change, match", [
    ({"precision": "float64"}, "precision"),
    ({"operator": {"method": "nap", "local_compute": "auto",
                   "integrity": "recover"}}, "integrity"),
    ({"batching": 2}, "batching"),
    ({"rows": 7}, "rows"),
])
def test_config_the_kind_would_not_run_raises(change, match):
    _, config, _ = tiny(CELLS[0])
    config.update(change)
    with pytest.raises(ValueError, match=match):
        spmv_chain.Problem(config, 5, "cpu")


def test_same_seed_same_inputs():
    a = spmv_chain.rng(2 ** 31 + 3, 1).standard_normal(5)
    b = spmv_chain.rng(2 ** 31 + 3, 1).standard_normal(5)
    assert (a == b).all()
    assert not (a == spmv_chain.rng(2 ** 31 + 4, 1).standard_normal(5)).all()


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    record, line = run(workload, programs=spmv_chain.control_programs)
    assert not line["correct"]
    assert record["checks"]["forward_err"] > line["checks"]["forward_err"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(workload, fault):
    _, line = run(workload, programs=faults.FAULTS[fault])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_exchange_left_out_is_not_correct(workload):
    with faults.exchange_left_out():
        _, line = run(workload)
    assert not line["correct"], line["checks"]
    _, line = run(workload)
    assert line["correct"], line["checks"]


def test_loaded_forbidden_compares_whole_names():
    fake = {name: object() for name in (
        "repro_torch", "repro_torch.api", "repro", "repro.core", "jaxlib",
        "jax_extra", "numpy", "benchmarks.common")}
    assert harness.loaded_forbidden(fake) == [
        "benchmarks.common", "jaxlib", "repro", "repro.core"]


def test_setup_loads_no_jax_nor_reference_package():
    """A run's set-up, window and check in a fresh process load no module
    of JAX, of the JAX package or of benchmarks/."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1] + '/src', sys.argv[1]]\n"
        "from benchport import test_benchport_run as t, harness\n"
        "record, line = t.run(t.CELLS[1])\n"
        "assert line['correct'], line\n"
        "print(harness.loaded_forbidden())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
