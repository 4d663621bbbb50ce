"""The traced stretch's reduction on a trace written by hand."""
import pytest

from benchport import trace


def X(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# two requests of 100 us; the program launches two kernels a request, the
# normalisation one; the device idles between them
EVENTS = [
    X("user_annotation", "benchport.request", 0, 100),
    X("user_annotation", "benchport.program", 1, 60),
    X("cpu_op", "aten::index_select", 2, 10),
    X("cuda_runtime", "cudaLaunchKernel", 5, 2, corr=1),
    X("cpu_op", "aten::cat", 32, 12),
    X("cuda_runtime", "cudaLaunchKernel", 40, 2, corr=2),
    X("user_annotation", "benchport.normalize", 70, 10),
    X("cuda_runtime", "cudaLaunchKernel", 72, 2, corr=3),
    X("kernel", "gather_kernel", 10, 20, tid=7, corr=1),
    X("kernel", "ell_spmm_kernel<1>", 45, 15, tid=7, corr=2),
    X("kernel", "norm_kernel", 75, 5, tid=7, corr=3),
    X("user_annotation", "benchport.request", 100, 100),
    X("user_annotation", "benchport.program", 101, 60),
    X("cuda_runtime", "cudaLaunchKernel", 105, 2, corr=4),
    X("kernel", "gather_kernel", 110, 20, tid=7, corr=4),
    X("kernel", "outside_kernel", 500, 5, tid=7, corr=99),
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 5, "id": 1},
]


def test_busy_idle_and_owners():
    r = trace.reduce(EVENTS)
    assert r["requests"] == 2
    assert r["window_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(60e-6)
    owners = {(o["name"], o["owner"]) for o in r["ops"]}
    assert ("ell_spmm_kernel<1>", "benchport.program") in owners
    assert ("norm_kernel", "benchport.normalize") in owners
    assert all(o["name"] != "outside_kernel" for o in r["ops"])
    assert dict(r["device_ops"])["gather_kernel"] == pytest.approx(40e-6)
    gaps = dict(r["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(140e-6)
    # 30-45 us: the host inside the program, in aten::cat at its midpoint
    assert gaps["benchport.program > aten::cat"] == pytest.approx(15e-6)


def test_metric_readers_on_the_trace():
    from benchport import harness
    rec = {"trace": trace.reduce(EVENTS), "applies_per_request": 1, "n": 10,
           "nnz": 30, "nv": 1}
    ex = harness.load_module("metrics", "exchange_ms").read(rec)
    assert ex == pytest.approx((20 + 20) / 1e3 / 2)
    idle = harness.load_module("metrics", "device_idle_pct").read(rec)
    assert idle == pytest.approx(70.0)
    ell = harness.load_module("metrics", "ell_spmm_roofline").read(rec)
    floor = (30 * 8 + 11 * 4 + 20 * 4) / 3.35e12
    # one of the two program calls launched the ELL kernel
    assert ell == pytest.approx(100 * floor / 15e-6)
    # the program's operations: 20 + 15 us in the first request, 20 in the second
    apply = harness.load_module("metrics", "apply_roofline").read(rec)
    assert apply == pytest.approx(100 * floor / (55e-6 / 2))


def test_apply_roofline_counts_overlaps_once():
    from benchport import harness
    ops = [{"name": "a", "start": 0.0, "dur": 10.0, "owner": "benchport.program"},
           {"name": "b", "start": 5.0, "dur": 10.0, "owner": "benchport.program"},
           {"name": "c", "start": 6.0, "dur": 2.0, "owner": "benchport.program"},
           {"name": "d", "start": 20.0, "dur": 5.0, "owner": "benchport.program"},
           {"name": "e", "start": 30.0, "dur": 50.0, "owner": "benchport.normalize"}]
    rec = {"trace": {"ops": ops, "requests": 1}, "applies_per_request": 2,
           "n": 10, "nnz": 30, "nv": 1}
    floor = (30 * 8 + 11 * 4 + 20 * 4) / 3.35e12
    got = harness.load_module("metrics", "apply_roofline").read(rec)
    assert got == pytest.approx(100 * 2 * floor / 20e-6)


def test_no_request_raises():
    with pytest.raises(ValueError):
        trace.reduce([X("kernel", "k", 0, 1)])


def test_readers_without_a_trace_read_nothing():
    from benchport import harness
    for name in ("exchange_ms", "ell_spmm_roofline", "device_idle_pct",
                 "apply_roofline"):
        assert harness.load_module("metrics", name).read({"trace": None}) is None


def test_device_span():
    span = trace.device_span([X("kernel", "a", 10, 20), X("gpu_memcpy", "m", 25, 10),
                              X("kernel", "b", 50, 10), X("cpu_op", "x", 0, 100)])
    assert span["window_s"] == pytest.approx(50e-6)
    assert span["busy_s"] == pytest.approx(35e-6)
    assert trace.device_span([]) == {"busy_s": 0.0, "window_s": 0.0}
