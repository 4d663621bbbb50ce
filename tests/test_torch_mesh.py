"""The port's multi-process mesh on the CPU, against its one-process
program and the JAX package.

Two gloo processes, started once by the port's own
:func:`repro_torch.mesh.launcher.launch` (this file re-entered as a
script in ``child`` mode), run every case and write their results; the
tests hold each result bit for bit against the port's one-process
program on the same layout and within the reference's f32 bar (rtol
1e-4 / atol 1e-5) of the JAX package's float64 simulators.  Layouts: one
node per process (declared and discovered), two nodes per process with a
strided partition, empty ranks on both sides of the process boundary,
and a rectangular operator; methods nap, standard and multistep, nv 1
and 3, forward and transpose, local compute ell, coo and bsr (plain
versions).  One case is also held against the reference's own 4-device
shard_map program, run in a subprocess.  The rest are the single-process
counterparts of ``tests/test_mesh.py``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
N_PROC = 2

# name -> (matrix, topology (n_nodes, ppn), row partition, column partition)
LAYOUTS = {
    "one_node_2x2": (("rotated_anisotropic_2d", 10), (2, 2), "contiguous", None),
    "two_nodes_4x2_strided": (("random_fixed_nnz", 60), (4, 2), "strided", None),
    "empty_boundary_4x2": (("random_fixed_nnz", 48), (4, 2), "empty_boundary", None),
    "rect_4x2": (("rect", (40, 26)), (4, 2), "contiguous", "strided"),
}
METHODS = ("nap", "standard", "multistep")
FORMATS = ("ell", "coo", "bsr")
NVS = (1, 3)
CASES = [(lay, m, f) for lay in LAYOUTS for m in METHODS for f in FORMATS]


def _owner(kind, n, n_procs):
    """Row owners: contiguous, strided, or contiguous over every rank but
    the last of process 0 and the first of process 1 (empty ranks on both
    sides of the boundary)."""
    if kind == "strided":
        return np.arange(n) % n_procs
    ranks = np.arange(n_procs)
    if kind == "empty_boundary":
        half = n_procs // N_PROC
        ranks = ranks[(ranks != half - 1) & (ranks != half)]
    counts = np.full(ranks.size, n // ranks.size)
    counts[: n % ranks.size] += 1
    return np.repeat(ranks, counts)


def _dense_rect(m, n, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((m, n)) < 0.2, rng.uniform(-1, 1, (m, n)), 0.0)


def layout(name, pkg="port"):
    """(a, row owners, col owners, (n_nodes, ppn)) for the port or the
    reference (``pkg="ref"``), from the same seeds."""
    if pkg == "port":
        import repro_torch.sparse as sparse
    else:
        import repro.sparse as sparse
    (gen, size), topo, rk, ck = LAYOUTS[name]
    if gen == "rect":
        a = sparse.CSR.from_dense(_dense_rect(*size, seed=3))
    elif gen == "random_fixed_nnz":
        a = sparse.random_fixed_nnz(size, 5, seed=size)
    else:
        a = sparse.rotated_anisotropic_2d(size)
    p = topo[0] * topo[1]
    rows = _owner(rk, a.shape[0], p)
    cols = rows if ck is None else _owner(ck, a.shape[1], p)
    return a, rows, cols, topo


def operands(name, nv):
    a, _, _, _ = layout(name)
    rng = np.random.default_rng(100 + nv)
    return rng.standard_normal((a.shape[1], nv)), rng.standard_normal((a.shape[0], nv))


def port_operator(name, method, fmt, discovered=False):
    import repro_torch.api as api
    from repro_torch.core.partition import partition_from_owner
    from repro_torch.core.topology import Topology
    a, rows, cols, topo = layout(name)
    p = topo[0] * topo[1]
    return api.operator(a, None if discovered else Topology(*topo),
                        row_part=partition_from_owner(rows, p),
                        col_part=partition_from_owner(cols, p),
                        method=method, local_compute=fmt, device="cpu")


def apply_all(op, name):
    """Every result of one operator: forward and transpose at each nv (the
    multi-step plan also through its literal padded direct exchange)."""
    out = {}
    for nv in NVS:
        v, u = operands(name, nv)
        out[f"{nv}/forward"] = op @ v
        out[f"{nv}/transpose"] = op.T @ u
        if op.method == "multistep":
            ex = op.executor
            out[f"{nv}/forward/literal"] = ex._apply("forward", v, live_direct=False)
            out[f"{nv}/transpose/literal"] = ex.transpose(u, live_direct=False)
    return out


# ---------------------------------------------------------------------------
# child mode: one process of the 2-process job
# ---------------------------------------------------------------------------

def _comm_checks(mesh):
    """The two cross-process all-to-alls against the one-process
    permutation on a job-wide buffer, and the bytes they count."""
    from repro_torch.mesh.comm import node_all_to_all, rank_all_to_all
    topo, (r0, r1) = mesh.topo, mesh.ranks
    p, nn, pl = topo.n_procs, topo.n_nodes, mesh.n_local_procs
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.standard_normal((p, nn, 3, 2)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((2, p, p, 3)).astype(np.float32))
    before = dict(mesh.stats)
    node = torch.equal(node_all_to_all(g[r0:r1].clone(), topo, mesh),
                       node_all_to_all(g, topo)[r0:r1])
    ranks = torch.equal(rank_all_to_all(t[:, r0:r1].contiguous(), mesh, lead=1),
                        rank_all_to_all(t, lead=1)[:, r0:r1])
    sent = {k: mesh.stats[k] - before[k] for k in mesh.stats}
    return {"node": node, "ranks": ranks, "sent": sent,
            "want_node": pl * nn * 6 * 4 // N_PROC,
            "want_ranks": 2 * pl * p * 3 * 4 // N_PROC}


def child(out_dir):
    from repro_torch.core.topology import Topology
    from repro_torch.mesh import (DiscoveryError, attach, detach,
                                  discover_topology, mesh_for)
    from repro_torch.mesh.scaling import measure_phase_walls
    # a plan compiled before the job attaches holds the whole layout
    pre = port_operator("two_nodes_4x2_strided", "nap", "ell")
    v, u = operands("two_nodes_4x2_strided", 1)
    pre @ v
    info = attach(verbose=True)
    pid = info["process_id"]
    results, meta = {}, {"info": info}
    results["pre_attach/forward"], results["pre_attach/transpose"] = pre @ v, pre.T @ u
    meta["pre_attach_whole"] = pre.executor.compiled.mesh is None
    for name, method, fmt in CASES:
        for k, w in apply_all(port_operator(name, method, fmt), name).items():
            results[f"{name}/{method}/{fmt}/{k}"] = w
    meta["stats"] = {str(t): dict(mesh_for(Topology(*t)).stats)
                     for t in ((2, 2), (4, 2))}
    # discovery: one node per process, ppn from REPRO_MESH_LOCAL_DEVICES
    topo = discover_topology()
    meta["discovered"] = [topo.n_nodes, topo.ppn]
    for method in METHODS:
        op = port_operator("one_node_2x2", method, "ell", discovered=True)
        for k, w in apply_all(op, "one_node_2x2").items():
            results[f"discovered/{method}/{k}"] = w
        meta[f"direct/{method}"] = int(op.stats().get("direct_effective", 0))
    meta["comm"] = _comm_checks(mesh_for(Topology(4, 2)))
    # what must fail across processes
    try:
        mesh_for(Topology(3, 2))
        meta["ragged"] = "no error"
    except DiscoveryError as e:
        meta["ragged"] = str(e)
    # the per-phase walls of every method's plan, on the cross-process mesh
    walls = {}
    for method in METHODS:
        c = port_operator("two_nodes_4x2_strided", method, "ell").executor.compiled
        plan = c.ms_plan if method == "multistep" else c.plan
        walls[method] = measure_phase_walls(plan, Topology(4, 2), repeats=1,
                                            device="cpu")
    meta["walls"] = walls
    np.savez(Path(out_dir) / f"results_{pid}.npz", **results)
    with open(Path(out_dir) / f"meta_{pid}.json", "w") as f:
        json.dump(meta, f)
    detach()
    print(f"CHILD {pid} OK", flush=True)


# ---------------------------------------------------------------------------
# the 2-process run and the reference's shard_map program, once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    from repro_torch.mesh import launch
    out = tmp_path_factory.mktemp("mesh")
    env = {"JAX_PLATFORMS": "cpu", "REPRO_MESH_BACKEND": "gloo"}
    res = launch(__file__, N_PROC, args=["child", str(out)], local_devices=2,
                 env=env, timeout_s=600)
    runs = []
    for pid in range(N_PROC):
        assert f"CHILD {pid} OK" in res.output(pid), res.output(pid)
        with np.load(out / f"results_{pid}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        runs.append((arrays, json.loads((out / f"meta_{pid}.json").read_text())))
    return runs


_REFERENCE_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    sys.path.insert(0, sys.argv[3])
    import test_torch_mesh as t
    import repro.api as nap
    from repro.core.partition import _from_owner
    from repro.core.topology import Topology
    from repro.mesh.scaling import measure_phase_walls
    a, rows, cols, topo = t.layout("one_node_2x2", "ref")
    part = _from_owner(rows, 4, "owner")
    op = nap.operator(a, topo=Topology(*topo), part=part, backend="shardmap",
                      local_compute="ell")
    out = {}
    for nv in t.NVS:
        v, u = t.operands("one_node_2x2", nv)
        out[f"{nv}/forward"] = op @ v
        out[f"{nv}/transpose"] = op.T @ u
    np.savez(sys.argv[1], **out)
    a, rows, cols, topo = t.layout("two_nodes_4x2_strided", "ref")
    walls = {}
    for method in t.METHODS:
        op = nap.operator(a, topo=Topology(*topo), part=_from_owner(
            rows, 8, "owner"), method=method, backend="shardmap")
        c = op.executor.compiled
        plan = c.ms_plan if method == "multistep" else c.plan
        walls[method] = measure_phase_walls(plan, Topology(*topo), repeats=1)
    json.dump(walls, open(sys.argv[2], "w"))
""")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_PROG, str(out / "w.npz"),
         str(out / "walls.json"), str(ROOT / "tests")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "w.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads((out / "walls.json").read_text())


def _simulated(name, method, nv, direction):
    """The reference's float64 simulator of the layout, column by column."""
    from repro.comm import build_multistep_plan
    from repro.comm.simulate import (simulate_multistep_spmv,
                                     simulate_multistep_spmv_transpose)
    from repro.core.comm_graph import build_nap_plan, build_standard_plan
    from repro.core.partition import _from_owner
    from repro.core.spmv import (simulate_nap_spmv, simulate_nap_spmv_transpose,
                                 simulate_standard_spmv,
                                 simulate_standard_spmv_transpose)
    from repro.core.topology import Topology as RefTopology
    a, rows, cols, topo = layout(name, "ref")
    p = topo[0] * topo[1]
    rp, cp = _from_owner(rows, p, "owner"), _from_owner(cols, p, "owner")
    build, fwd, tr = {
        "nap": (build_nap_plan, simulate_nap_spmv, simulate_nap_spmv_transpose),
        "standard": (build_standard_plan, simulate_standard_spmv,
                     simulate_standard_spmv_transpose),
        "multistep": (build_multistep_plan, simulate_multistep_spmv,
                      simulate_multistep_spmv_transpose)}[method]
    plan = build(a.indptr, a.indices, rp, RefTopology(*topo), col_part=cp)
    v, u = operands(name, nv)
    fn, x = (fwd, v) if direction == "forward" else (tr, u)
    return np.stack([fn(a, x[:, i], plan) for i in range(nv)], axis=1)


# ---------------------------------------------------------------------------
# the 2-process results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,method,fmt", CASES,
                         ids=["-".join(c) for c in CASES])
def test_two_processes_bit_equal_to_one_process(mesh_run, name, method, fmt):
    """Every result of the 2-process job equals the port's one-process
    program bit for bit, on both processes, and the reference's float64
    simulator within the f32 bar."""
    single = apply_all(port_operator(name, method, fmt), name)
    for key, want in single.items():
        for arrays, _ in mesh_run:
            got = arrays[f"{name}/{method}/{fmt}/{key}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), key
    for nv in NVS:
        for direction in ("forward", "transpose"):
            np.testing.assert_allclose(single[f"{nv}/{direction}"],
                                       _simulated(name, method, nv, direction),
                                       **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_discovered_topology_runs_one_node_per_process(mesh_run, method):
    """``operator(a)`` with no topology in the job discovers Topology(2, 2)
    (2 processes x REPRO_MESH_LOCAL_DEVICES=2) and runs bit-equal to the
    declared layout in one process."""
    single = apply_all(port_operator("one_node_2x2", method, "ell"), "one_node_2x2")
    for arrays, meta in mesh_run:
        assert meta["discovered"] == [2, 2]
        for key, want in single.items():
            assert np.array_equal(arrays[f"discovered/{method}/{key}"], want), key


def test_programs_exchanged_across_processes(mesh_run):
    """The cases' programs sent bytes to the other process over both axes
    (the layouts' node and direct / pair exchanges), and the multi-step
    layout has a live direct share."""
    for _, meta in mesh_run:
        assert meta["direct/multistep"] > 0
        for stats in meta["stats"].values():
            assert stats["sent_bytes_node"] > 0
            assert stats["sent_bytes_nodexproc"] > 0
            assert stats["collectives"] > 0


def test_cross_process_all_to_alls_match_permutations(mesh_run):
    """``node`` and ``("node", "proc")`` all-to-alls over gloo equal the
    one-process permutations on the owned block, and count the bytes sent
    to the other process (half of each equal-split buffer)."""
    for _, meta in mesh_run:
        comm = meta["comm"]
        assert comm["node"] and comm["ranks"]
        assert comm["sent"]["sent_bytes_node"] == comm["want_node"]
        assert comm["sent"]["sent_bytes_nodexproc"] == comm["want_ranks"]
        assert comm["sent"]["collectives"] == 2
        assert comm["sent"]["staged_bytes"] == 0        # CPU tensors


def test_ragged_layouts_raise_across_processes(mesh_run):
    for _, meta in mesh_run:
        assert "multiple of the process count" in meta["ragged"]


def test_plan_compiled_before_attach_stays_whole(mesh_run):
    """An operator compiled before the job attached keeps its whole-layout
    plan: applied after, it stages and fetches the whole layout and gives
    the one-process result bit for bit."""
    op = port_operator("two_nodes_4x2_strided", "nap", "ell")
    v, u = operands("two_nodes_4x2_strided", 1)
    want = {"forward": op @ v, "transpose": op.T @ u}
    for arrays, meta in mesh_run:
        assert meta["pre_attach_whole"]
        for key, w in want.items():
            assert np.array_equal(arrays[f"pre_attach/{key}"], w), key


def test_two_processes_match_reference_shardmap(mesh_run, reference_run):
    """The 2-process nap/ell result against the reference's own
    declared-topology shard_map program on the same layout (4 devices of
    a forced 8-device host platform)."""
    ref, _ = reference_run
    for arrays, _ in mesh_run:
        for key, want in ref.items():
            np.testing.assert_allclose(arrays[f"one_node_2x2/nap/ell/{key}"],
                                       want, **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_phase_wall_records_match_reference(mesh_run, reference_run, method):
    """``measure_phase_walls`` across the 2 processes gives the reference's
    records (phase, level, axis, slots, pad, n_msgs, nbytes) for the same
    plan, with a measured wall, and the bytes each process's exchange
    moves (its 4 ranks' padded slots)."""
    _, ref_walls = reference_run
    for _, meta in mesh_run:
        got = meta["walls"][method]
        want = ref_walls[method]
        assert [set(w) - {"proc_bytes"} for w in got] == [set(w) for w in want]
        strip = [{k: v for k, v in w.items() if k not in ("seconds", "proc_bytes")}
                 for w in got]
        assert strip == [{k: v for k, v in w.items() if k != "seconds"}
                         for w in want]
        assert all(w["seconds"] > 0 for w in got)
        assert [w["proc_bytes"] for w in got] == [4 * w["n_slots"] * w["pad"] * 4
                                                  for w in got]


# ---------------------------------------------------------------------------
# single-process counterparts of tests/test_mesh.py
# ---------------------------------------------------------------------------

def test_discovery_matches_reference_single_process(monkeypatch):
    from repro.mesh.discover import discover_topology as ref_discover
    from repro.mesh.discover import discovery_report as ref_report
    from repro_torch.mesh import discover_topology, discovery_report
    from repro_torch.mesh.launcher import ENV_LOCAL_DEVICES
    monkeypatch.delenv(ENV_LOCAL_DEVICES, raising=False)
    ref, got_topo = ref_discover(), discover_topology()
    assert (got_topo.n_nodes, got_topo.ppn) == (ref.n_nodes, ref.ppn)
    got, want = discovery_report(), ref_report()
    assert set(got) == set(want)
    for k in ("n_nodes", "ppn", "process_index", "device_count"):
        assert got[k] == want[k], k
    monkeypatch.setenv(ENV_LOCAL_DEVICES, "3")
    assert (discover_topology().n_nodes, discover_topology().ppn) == (1, 3)


def test_operator_autodiscovers_topology_bit_identical(monkeypatch):
    import repro_torch.api as api
    from repro_torch.core.topology import Topology
    from repro_torch.mesh import discover_topology
    from repro_torch.mesh.launcher import ENV_LOCAL_DEVICES
    from repro_torch.sparse import random_fixed_nnz
    monkeypatch.delenv(ENV_LOCAL_DEVICES, raising=False)
    a = random_fixed_nnz(48, 5, seed=3)
    v = np.random.default_rng(3).standard_normal(48)
    auto = api.operator(a, device="cpu")
    assert auto.topo == discover_topology() == Topology(1, 1)
    declared = api.operator(a, Topology(1, 1), device="cpu")
    assert np.array_equal(auto @ v, declared @ v)
    assert np.array_equal(auto.T @ v, declared.T @ v)


def test_mesh_env_and_pick_coordinator_match_reference():
    from repro.mesh.launcher import mesh_env as ref_mesh_env
    from repro_torch.mesh import mesh_env, pick_coordinator
    coord = pick_coordinator()
    host, port = coord.rsplit(":", 1)
    assert host == "127.0.0.1" and 0 < int(port) < 65536
    for local in (3, None):
        assert mesh_env(coord, 4, 2, local) == ref_mesh_env(coord, 4, 2, local)


def test_attach_is_noop_without_env(monkeypatch):
    from repro_torch.mesh import attach, is_multiprocess, process_count
    from repro_torch.mesh.launcher import ENV_COORDINATOR
    monkeypatch.delenv(ENV_COORDINATOR, raising=False)
    assert attach() == {"attached": False, "process_id": 0, "num_processes": 1}
    assert process_count() == 1 and not is_multiprocess()


def test_launch_fans_out_env(tmp_path):
    from repro_torch.mesh import launch
    script = tmp_path / "child.py"
    script.write_text(
        "import os, repro_torch\n"
        "print('pid', os.environ['REPRO_MESH_PROCESS_ID'],\n"
        "      'of', os.environ['REPRO_MESH_NUM_PROCESSES'],\n"
        "      'local', os.environ['REPRO_MESH_LOCAL_DEVICES'])\n")
    res = launch(str(script), 2, local_devices=3, timeout_s=120)
    assert res.returncodes == [0, 0]
    for pid in (0, 1):
        assert f"pid {pid} of 2 local 3" in res.output(pid)


def test_launch_surfaces_child_failure_and_stops_its_peers(tmp_path):
    """A failing child fails the launch at once (its peer, which would wait
    on it, is killed) with the children's last lines; so does a timeout."""
    import time
    from repro_torch.mesh import LaunchError, launch
    script = tmp_path / "boom.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['REPRO_MESH_PROCESS_ID'] == '1':\n"
        "    print('going down'); sys.exit(3)\n"
        "time.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(LaunchError, match="going down") as ei:
        launch(str(script), 2, timeout_s=100)
    assert time.monotonic() - t0 < 60
    assert "failed" in str(ei.value)
    slow = tmp_path / "slow.py"
    slow.write_text("import time; print('waiting'); time.sleep(120)\n")
    with pytest.raises(LaunchError, match="timed out"):
        launch(str(slow), 2, timeout_s=2)


def test_launch_module_target_attaches_gloo(tmp_path):
    """A ``pkg.mod:fn`` target runs under ``python -m
    repro_torch.mesh.launcher``: attached over gloo, with a working group."""
    from repro_torch.mesh import launch
    res = launch("repro_torch.mesh.discover:discovery_report", 2,
                 local_devices=2, timeout_s=120)
    for pid in (0, 1):
        assert f"[mesh.attach] p{pid}/2" in res.output(pid)
        assert "(gloo, cpu, 2 local ranks)" in res.output(pid)


def test_nccl_refuses_two_processes_on_one_device(monkeypatch):
    """Two processes of one host on one card: ``attach`` raises before NCCL
    would, naming gloo; on the CPU nccl is refused outright."""
    from repro_torch.mesh import launcher

    class Store(dict):
        def set(self, k, v):
            self[k] = v.encode()

        def get(self, k):
            return self[k]

    store = Store()
    store.set("repro_mesh/device/1", f"{__import__('socket').gethostname()}:cuda:0")
    with pytest.raises(RuntimeError, match="gloo"):
        launcher._check_devices(store, 0, 2, "cuda:0")
    launcher._check_devices(Store(), 0, 1, "cuda:0")    # one process: fine
    monkeypatch.setenv(launcher.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.setenv(launcher.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(launcher.ENV_PROCESS_ID, "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        launcher.attach(backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        launcher.attach(backend="mpi")


def test_stage_and_fetch_single_process_bit_identical():
    """A whole-layout plan (mesh None) stages and fetches the array as is;
    in one process ``mesh_for`` owns every node."""
    from repro_torch.core.topology import Topology
    from repro_torch.mesh import (fetch_mesh_array, input_stager,
                                  is_multiprocess, mesh_for, stage_mesh_array)
    topo = Topology(2, 3)
    g = np.random.default_rng(0).standard_normal((2, 3, 6)).astype(np.float32)
    w = stage_mesh_array(g, None, device="cpu")
    assert np.array_equal(fetch_mesh_array(w, None), g)
    assert np.array_equal(fetch_mesh_array(w), g)
    assert input_stager(None, "cpu") is None and not is_multiprocess()
    mesh = mesh_for(topo)
    assert mesh is mesh_for(topo)
    assert (mesh.world, mesh.rank, mesh.nodes, mesh.ranks) == (1, 0, (0, 2), (0, 6))


def test_postal_calibrated_recovers_planted_constants_as_reference():
    from repro.core.cost_model import PostalParams as RefPostal
    from repro_torch.core.cost_model import PostalParams
    alpha_i, beta_i = 2.0e-4, 1.0e8
    alpha_l, beta_l = 3.0e-6, 4.0e9
    rng = np.random.default_rng(0)
    walls = []
    for _ in range(12):
        n, b = int(rng.integers(1, 9)), int(rng.integers(1, 64)) * 4096
        walls.append({"inter": True, "n_msgs": n, "nbytes": b,
                      "seconds": n * alpha_i + b / beta_i})
        walls.append({"inter": False, "n_msgs": n, "nbytes": b,
                      "seconds": n * alpha_l + b / beta_l})
    p, r = PostalParams.calibrated(walls), RefPostal.calibrated(walls)
    assert p.alpha_inter == pytest.approx(alpha_i, rel=1e-6)
    assert p.beta_inter == pytest.approx(beta_i, rel=1e-6)
    assert p.alpha_intra == pytest.approx(alpha_l, rel=1e-6)
    assert p.beta_intra == pytest.approx(beta_l, rel=1e-6)
    assert (p.name, p.alpha_inter, p.beta_inter, p.alpha_intra, p.beta_intra) == \
        (r.name, r.alpha_inter, r.beta_inter, r.alpha_intra, r.beta_intra)


def test_postal_calibrated_degrades_to_defaults_as_reference():
    """A level with fewer than two usable records keeps its defaults: the
    port's ``PostalParams()`` (the Blue Waters rendezvous rows), the
    reference's its own; a level that fits gives both the same constants."""
    import dataclasses
    from repro.core.cost_model import PostalParams as RefPostal
    from repro_torch.core.cost_model import BLUE_WATERS_POSTAL, PostalParams
    walls = [{"inter": True, "n_msgs": 1, "nbytes": 4096, "seconds": 1e-4},
             {"inter": False, "n_msgs": 2, "nbytes": 64, "seconds": -1.0}]
    assert PostalParams() == BLUE_WATERS_POSTAL
    for got, default in ((PostalParams.calibrated(walls), PostalParams()),
                         (RefPostal.calibrated(walls), RefPostal())):
        assert dataclasses.replace(got, name=default.name) == default
    alpha, beta = 3.0e-6, 4.0e9
    walls += [{"inter": False, "n_msgs": n, "nbytes": b,
               "seconds": n * alpha + b / beta}
              for n, b in ((1, 4096), (3, 65536), (5, 8192))]
    p, r = PostalParams.calibrated(walls), RefPostal.calibrated(walls)
    assert (p.alpha_intra, p.beta_intra) == (r.alpha_intra, r.beta_intra)
    assert p.alpha_intra == pytest.approx(alpha, rel=1e-6)
    assert p.beta_intra == pytest.approx(beta, rel=1e-6)
    assert (p.alpha_inter, p.beta_inter) == (BLUE_WATERS_POSTAL.alpha_inter,
                                             BLUE_WATERS_POSTAL.beta_inter)
    assert (r.alpha_inter, r.beta_inter) == (RefPostal().alpha_inter,
                                             RefPostal().beta_inter)


def test_scaling_sweep_feeds_calibration(tmp_path):
    """The ladder on the CPU in one process: every point, method and phase
    record present, flattened into a fit; ``main`` writes the JSON."""
    from repro_torch.core.cost_model import PostalParams
    from repro_torch.mesh.scaling import calibration_records, main, scaling_sweep
    cfg = {"ladder": [[1, 2], [2, 2]], "n_rows": 64, "repeats": 1,
           "device": "cpu"}
    sweep = scaling_sweep(cfg)
    assert [(p["n_nodes"], p["ppn"]) for p in sweep["points"]] == [(1, 2), (2, 2)]
    assert sweep["discovery"]["n_nodes"] == 1 and not sweep["skipped"]
    recs = calibration_records(sweep)
    assert recs and all(r["seconds"] > 0 for r in recs)
    assert {r["phase"] for r in recs} >= {"pair", "full", "inter", "direct"}
    assert PostalParams.calibrated(recs).name == "calibrated"
    (tmp_path / "cfg.json").write_text(json.dumps(dict(cfg, ladder=[[1, 2]])))
    assert main([str(tmp_path / "cfg.json"), str(tmp_path / "out.json")]) == 0
    assert json.loads((tmp_path / "out.json").read_text())["points"]


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "child":
        child(sys.argv[2])
    else:
        sys.exit("usage: test_torch_mesh.py child OUT_DIR (under launch())")
