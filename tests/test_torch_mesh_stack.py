"""The node-aware stack across processes on the CPU: wire integrity, the
AMG level operators and the solver service in a job of two gloo
processes, against the port's one-process run and the JAX package.

Two processes, started once by the port's own
:func:`repro_torch.mesh.launcher.launch` (this file re-entered as a
script in ``child`` mode), each own two nodes of Topology(4, 2) and run
every case; the tests hold what they return against the same cases run
here in one process, and against the reference:

- integrity: nap, standard and multistep, forward and transpose, under
  ``"detect"`` and ``"recover"``: clean applies at nv = 1 and 3, then
  every fault kind on a live edge of every message phase, the senders in
  both processes' blocks, an ``inter`` bitflip from a rank of process 0
  to a node of process 1, and an ABFT compute fault.  The mismatch lists
  of both processes equal the one-process port's and the reference's
  instrumented shard_map program's (8 forced host devices, in a
  subprocess); recovered results equal the clean apply bit for bit.
- AMG: ``level_operators`` (lazy and ``materialize=True``, coarse levels
  with empty ranks) on ``poisson_2d``, then a V-cycle and 10 PCG
  iterations: bit-equal to one process, and within the reference's f32
  bar of its float64 host hierarchy.
- the solver service: a hot swap, then ``node1`` and ``node3`` (one in
  each block) lost around a CG iteration 8: results, logs, tickets and
  checkpoint digests equal one process's run of the same plan, the
  checkpoints written by process 0 alone; a one-node loss leaves a
  ragged layout and raises ``DiscoveryError`` in both processes.

The CPU's plain ELL is not columnwise-stable, so nv = 3 results are held
against the one-process nv = 3 apply, never column against a solo apply.
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
TOPO = (4, 2)                    # two nodes a process: ranks 0-3 and 4-7
METHODS = ("nap", "standard", "multistep")
DIRECTIONS = ("forward", "transpose")
CASES = [(m, d) for m in METHODS for d in DIRECTIONS]
PHASE_NAMES = ("full", "init", "inter", "final", "pair", "direct", "compute")
NV = (1, 3)


def _ids(cases):
    return ["-".join(c) for c in cases]


# ---------------------------------------------------------------------------
# shared by the test process and the children
# ---------------------------------------------------------------------------

def dense_matrix():
    """64 x 64, every exchange phase of Topology(4, 2) live both ways
    (threshold 2 leaves the multi-step plan a direct share)."""
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((64, 64)) * (rng.random((64, 64)) < 0.15)
    np.fill_diagonal(dense, 4.0)
    return dense


def operands(nv):
    rng = np.random.default_rng(40 + nv)
    v = rng.standard_normal((64, nv))
    return v[:, 0] if nv == 1 else v


def port_op(method, integrity="detect"):
    import repro_torch.api as api
    from repro_torch.core.partition import contiguous_partition
    from repro_torch.core.topology import Topology
    from repro_torch.sparse.csr import CSR
    return api.operator(CSR.from_dense(dense_matrix()), Topology(*TOPO),
                        contiguous_partition(64, TOPO[0] * TOPO[1]), method=method,
                        local_compute="ell", threshold=2, integrity=integrity,
                        device="cpu")


def view_of(op, direction):
    return op.T if direction == "transpose" else op


def inject(view, row):
    from repro_torch.core.integrity import FAULT_KINDS
    kind = "bitflip" if row[3] == 0 else FAULT_KINDS[row[3] - 1]
    view.inject_fault(PHASE_NAMES[row[2]], kind, node=int(row[4]), proc=int(row[5]),
                      slot=int(row[6]), element=int(row[7]), bit=int(row[8]))


def mismatches(view, v):
    """The attributed mismatches of one apply ([] when it passes)."""
    from repro_torch.core.integrity import IntegrityError
    try:
        view @ v
    except IntegrityError as e:
        return [[m.check, m.phase, m.scope, m.node, m.proc, m.slot, m.direction]
                for m in e.mismatches]
    return []


def integrity_run(faults):
    """Every integrity case of one process (or of one process of the
    job): clean detect applies, each fault row under detect, then under
    recover one fault per method and direction.  Returns (arrays,
    mismatch lists, reports)."""
    arrays, lists, reports = {}, {}, {}
    for method in METHODS:
        det = port_op(method)
        for direction in DIRECTIONS:
            for nv in NV:
                arrays[f"{method}/{direction}/{nv}/clean"] = \
                    view_of(det, direction) @ operands(nv)
        reports[f"{method}/clean"] = det.integrity_report()
        mi = METHODS.index(method)
        for i, row in enumerate(faults):
            if row[0] != mi:
                continue
            view = view_of(det, DIRECTIONS[row[1]])
            inject(view, row)
            lists[str(i)] = mismatches(view, operands(1))
        reports[f"{method}/detect"] = det.integrity_report()
        rec = port_op(method, "recover")
        for di, direction in enumerate(DIRECTIONS):
            row = recover_fault(faults, mi, di)
            inject(view_of(rec, direction), row)
            arrays[f"{method}/{direction}/recovered"] = \
                view_of(rec, direction) @ operands(1)
        reports[f"{method}/recover"] = rec.integrity_report()
    return arrays, lists, reports


#: each method's exchange that crosses processes
CROSSING = {"nap": "inter", "standard": "pair", "multistep": "direct"}


def recover_fault(faults, mi, di):
    """The fault the recover run takes: the bitflip on the method's
    exchange that crosses processes, from process 0 to process 1."""
    phase = PHASE_NAMES.index(CROSSING[METHODS[mi]])
    return next(r for r in faults if (r[0], r[1], r[2], r[3]) == (mi, di, phase, 1))


AMG_GRID, AMG_MIN_ROWS = 16, 1       # min_rows 1: a coarse level with empty ranks


def amg_levels(pkg="port"):
    if pkg == "port":
        from repro_torch.amg import smoothed_aggregation_hierarchy
        from repro_torch.sparse import poisson_2d
    else:
        from repro.amg import smoothed_aggregation_hierarchy
        from repro.sparse import poisson_2d
    return smoothed_aggregation_hierarchy(poisson_2d(AMG_GRID), coarse_size=8)


def amg_run(materialize):
    """A V-cycle and 10 PCG iterations over ``level_operators``: the
    V-cycle's output, the PCG iterate and its residual history."""
    from repro_torch.amg import amg_vcycle, cg_solve, level_operators
    from repro_torch.core.topology import Topology
    levels = amg_levels()
    ops = level_operators(levels, Topology(*TOPO), materialize=materialize,
                          min_rows=AMG_MIN_ROWS, device="cpu")
    b = np.random.default_rng(12).standard_normal(levels[0].a.shape[0])
    hist = []
    x, _, _ = cg_solve(levels[0].a, b, tol=0.0, maxiter=10, spmv=ops[0].a,
                       precond=lambda r: amg_vcycle(levels, r, operators=ops),
                       callback=lambda it, x: hist.append(
                           np.linalg.norm(b - levels[0].a.matvec(x)) / np.linalg.norm(b)))
    coarse = [e.a.a.data for e in ops[1:] if e.a is not None]
    return {"vcycle": amg_vcycle(levels, b, operators=ops), "x": x,
            "hist": np.array(hist), "coarse": np.concatenate(coarse)}, \
        [int(e.a is not None) for e in ops]


def service_run(ckpt_dir):
    """The service scenario: 8 spmv requests in one batch, a hot value
    swap and 8 more, then two solves during which node1 dies at CG
    iteration 8 and node3 at the next step (one node of each process's
    block, both silent from the same step: one recovery onto
    Topology(2, 2)), and a spmv that waits through it."""
    from repro_torch.core.topology import Topology
    from repro_torch.serve import FaultPlan, SolverService, dead_node
    from repro_torch.sparse import poisson_2d
    a = poisson_2d(12)
    n = a.shape[0]
    rng = np.random.default_rng(21)
    svc = SolverService(Topology(*TOPO), device="cpu", checkpoint_dir=ckpt_dir,
                        checkpoint_every=4, max_attempts=6,
                        fault_plan=FaultPlan.of(dead_node(1, "node1", at_iteration=8),
                                                dead_node(4, "node3")))
    svc.register_matrix("m", a)
    V = rng.standard_normal((n, 16))
    tickets = [svc.submit(f"t{i % 3}", "m", V[:, i]) for i in range(8)]
    svc.step()
    svc.update_values("m", type(a)(indptr=a.indptr, indices=a.indices,
                                   data=a.data * 1.5, shape=a.shape))
    tickets += [svc.submit(f"t{i % 3}", "m", V[:, 8 + i]) for i in range(8)]
    svc.step()
    B = rng.standard_normal((n, 2))
    tickets += [svc.submit(f"t{1 + i}", "m", B[:, i], kind="solve", tol=1e-10,
                           maxiter=60, deadline=1e6) for i in range(2)]
    tickets.append(svc.submit("t0", "m", V[:, 0]))
    svc.run(max_steps=60)
    stats = dict(svc.report()["stats"])
    stats.pop("last_recover_rebuild_s")
    cache = {k: v for k, v in svc.plans.stats.items() if k != "buffer_bytes_released"}
    out = {"log": svc.log, "stats": stats, "plan_cache": cache,
           "tickets": [[t.status, t.reason, t.request.iters] for t in tickets],
           "topo": [svc.topo.n_nodes, svc.topo.ppn], "nodes": svc.nodes}
    results = {f"ticket{i}": t.result() for i, t in enumerate(tickets)
               if t.status == "done"}
    return out, results


def checkpoint_digests(ckpt_dir):
    """Every committed step's manifest: shard digests and extra."""
    out = {}
    for step in sorted(Path(ckpt_dir).glob("step_*")):
        if (step / "_COMMITTED").exists():
            man = json.loads((step / "manifest.json").read_text())
            out[step.name] = [man["shard_digests"], man["extra"]]
    return out


# ---------------------------------------------------------------------------
# child mode: one process of the 2-process job
# ---------------------------------------------------------------------------

def child(out_dir, faults_file, ckpt_dir):
    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.core.topology import Topology
    from repro_torch.mesh import DiscoveryError, attach, detach, mesh_for
    from repro_torch.serve import FaultPlan, PlanCache, SolverService, dead_node
    info = attach()
    pid = info["process_id"]
    faults = np.load(faults_file)
    mesh = mesh_for(Topology(*TOPO))
    meta = {"nodes": list(mesh.nodes)}
    # integrity
    arrays, meta["lists"], meta["reports"] = integrity_run(faults)
    sent = {}
    for method in METHODS:
        for integrity in ("off", "detect"):
            ex = port_op(method, integrity).executor
            # the multi-step bare program beside the instrumented one: its
            # literal padded direct exchange
            literal = {"live_direct": False} if method == "multistep" else {}
            for direction in DIRECTIONS:
                before = dict(mesh.stats)
                ex._apply(direction, operands(1), **literal)
                sent[f"{method}/{direction}/{integrity}"] = {
                    k: mesh.stats[k] - before[k] for k in mesh.stats}
    meta["sent"] = sent
    # AMG
    for materialize in (False, True):
        out, meta[f"amg/{materialize}/distributed"] = amg_run(materialize)
        arrays.update({f"amg/{materialize}/{k}": w for k, w in out.items()})
    # the solver service: process 0 writes the checkpoints
    saves = []
    orig_save = CheckpointManager.save
    CheckpointManager.save = lambda self, *a, **k: saves.append(1) or orig_save(self, *a, **k)
    try:
        meta["service"], results = service_run(ckpt_dir)
    finally:
        CheckpointManager.save = orig_save
    arrays.update({f"service/{k}": w for k, w in results.items()})
    meta["saves"] = len(saves)
    meta["digests"] = checkpoint_digests(ckpt_dir)
    svc = SolverService(Topology(*TOPO), device="cpu",
                        fault_plan=FaultPlan.of(dead_node(1, "node1")))
    try:
        for _ in range(8):       # silent past the heartbeat timeout: evicted
            svc.step()
        meta["ragged"] = "no error"
    except DiscoveryError as e:
        meta["ragged"] = str(e)
    cache = PlanCache(Topology(*TOPO), device="cpu")
    meta["cache_mesh"] = [list(cache.mesh.nodes)]
    cache.rebuild(Topology(2, 2))
    meta["cache_mesh"].append(list(cache.mesh.nodes) + [cache.mesh.topo.n_nodes])
    try:
        cache.rebuild(Topology(3, 2))
    except DiscoveryError:
        meta["cache_mesh"].append([cache.topo.n_nodes, cache.stats["rebuilds"]])
    np.savez(Path(out_dir) / f"results_{pid}.npz", **arrays)
    (Path(out_dir) / f"meta_{pid}.json").write_text(json.dumps(meta))
    detach()
    print(f"CHILD {pid} OK", flush=True)


# ---------------------------------------------------------------------------
# the fault rows, the 2-process run and the reference, once per module
# ---------------------------------------------------------------------------

def _recorded(ex, direction, v):
    """One clean instrumented one-process run with every message buffer
    recorded before its fault boundary: {phase: int32 [P, slots, words]},
    "compute" the local result (or packed contributions) the compute
    fault would hit."""
    import repro_torch.core.spmv_torch as spmv
    from repro_torch.core.integrity import message_phases
    rec = {}
    orig_fault, orig_pair = spmv._Wire.fault, spmv._fault_pair

    def fault(self, phase, buf):
        rec[phase] = buf.reshape(buf.shape[0], buf.shape[1], -1).clone()
        return orig_fault(self, phase, buf)

    def fault_pair(send, spec):
        nv, p, n_r, pad = send.shape
        rec["pair"] = send.permute(1, 2, 3, 0).reshape(p, n_r, pad * nv).clone()
        return orig_pair(send, spec)

    spmv._Wire.fault, spmv._fault_pair = fault, fault_pair
    try:
        n = len(message_phases(ex.method)) + 1
        spec = torch.zeros((TOPO[0], TOPO[1], n, 4), dtype=torch.int32)
        ex.program(direction, fault_spec=spec)(ex.packed(direction, v))
    finally:
        spmv._Wire.fault, spmv._fault_pair = orig_fault, orig_pair
    return {k: t.numpy() for k, t in rec.items()}


def _changes(kind, payload, nxt):
    """Whether the fault changes the payload's bits (what a checksum
    sees): zero / drop need a nonzero payload, stale a non-constant one,
    duplicate a different next slot."""
    w, n = payload.view(np.uint32), nxt.view(np.uint32)
    if kind in ("zero", "drop"):
        return bool(w.any())
    if kind == "stale":
        return not np.array_equal(np.roll(w, 1), w)
    if kind == "duplicate":
        return not np.array_equal(w, n)
    return True


def pick_faults():
    """Per method, direction, message phase and kind, one live edge whose
    payload the fault changes, its sender in process (kind index mod 2)'s
    block where that block has one; every bitflip on an exchange that
    crosses processes (``inter``, ``pair``, ``direct``) from a rank of
    process 0 to a node or rank of process 1; per method and direction an ABFT
    compute fault (bit 30 of a value in [0.1, 1)), forward on a rank of
    process 1, transpose of process 0.  Rows: (method, direction, phase,
    kind code, node, proc, slot, element, bit)."""
    from repro_torch.core.integrity import FAULT_KINDS, message_phases
    ppn, per = TOPO[1], TOPO[0] * TOPO[1] // N_PROC
    rows = []
    for mi, method in enumerate(METHODS):
        ex = port_op(method).executor
        for di, direction in enumerate(DIRECTIONS):
            rec = _recorded(ex, direction, operands(1))
            for phase in message_phases(method):
                buf = rec[phase].view(np.int32)
                n_slots = buf.shape[1]
                for ki, kind in enumerate(FAULT_KINDS):
                    cross = kind == "bitflip" and phase in CROSSING.values()
                    order = [0] if cross else [ki % 2, 1 - ki % 2]
                    far = n_slots // N_PROC if cross else 0    # slots of process 1
                    hit = next(((s, k) for b in order for s in range(b * per, (b + 1) * per)
                                for k in range(far, n_slots)
                                if buf[s, k].any()
                                and _changes(kind, buf[s, k], buf[s, (k + 1) % n_slots])),
                               None)
                    if hit is None:
                        continue
                    s, k = hit
                    rows.append((mi, di, PHASE_NAMES.index(phase), ki + 1, s // ppn,
                                 s % ppn, k, int(np.flatnonzero(buf[s, k])[0]), 20))
            r = 6 if direction == "forward" else 1
            vals = rec["compute"][r, 0]
            idx = np.flatnonzero((np.abs(vals) >= 0.1) & (np.abs(vals) < 1.0))
            rows.append((mi, di, PHASE_NAMES.index("compute"), 0, r // ppn, r % ppn, 0,
                         int(idx[idx.size // 2]), 30))
    return np.array(rows, dtype=np.int64)


@pytest.fixture(scope="module")
def faults():
    return pick_faults()


@pytest.fixture(scope="module")
def stack_run(tmp_path_factory, faults):
    from repro_torch.mesh import launch
    out = tmp_path_factory.mktemp("stack")
    np.save(out / "faults.npy", faults)
    ckpt = out / "ckpt"
    env = {"JAX_PLATFORMS": "cpu", "REPRO_MESH_BACKEND": "gloo"}
    res = launch(__file__, N_PROC, args=["child", str(out), str(out / "faults.npy"),
                                         str(ckpt)],
                 local_devices=TOPO[1], env=env, timeout_s=600)
    runs = []
    for pid in range(N_PROC):
        assert f"CHILD {pid} OK" in res.output(pid), res.output(pid)
        with np.load(out / f"results_{pid}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        runs.append((arrays, json.loads((out / f"meta_{pid}.json").read_text())))
    return runs


@pytest.fixture(scope="module")
def one_process(faults):
    """The same integrity cases in this process, one process owning every
    node."""
    return integrity_run(faults)


_REF_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    sys.path.insert(0, sys.argv[3])
    import test_torch_mesh_stack as t
    import repro.api as nap
    from repro.core.integrity import IntegrityError, FAULT_KINDS
    from repro.core.partition import contiguous_partition
    from repro.core.topology import Topology
    from repro.sparse import CSR
    faults = np.load(sys.argv[1])
    ops = {m: nap.operator(CSR.from_dense(t.dense_matrix()), topo=Topology(*t.TOPO),
                           part=contiguous_partition(64, 8), method=m,
                           backend="shardmap", local_compute="ell",
                           integrity="detect", threshold=2) for m in t.METHODS}
    lists = {}
    for i, row in enumerate(faults):
        op = ops[t.METHODS[row[0]]]
        view = op.T if row[1] == 1 else op
        kind = "bitflip" if row[3] == 0 else FAULT_KINDS[row[3] - 1]
        view.inject_fault(t.PHASE_NAMES[row[2]], kind, node=int(row[4]),
                          proc=int(row[5]), slot=int(row[6]), element=int(row[7]),
                          bit=int(row[8]))
        try:
            view @ t.operands(1)
            lists[str(i)] = []
        except IntegrityError as e:
            lists[str(i)] = [[m.check, m.phase, m.scope, m.node, m.proc, m.slot,
                              m.direction] for m in e.mismatches]
    json.dump(lists, open(sys.argv[2], "w"))
""")


@pytest.fixture(scope="module")
def reference_lists(tmp_path_factory, faults):
    """The reference's instrumented shard_map programs on 8 forced host
    devices, Topology(4, 2), under the same fault rows (one subprocess)."""
    tmp = tmp_path_factory.mktemp("ref_stack")
    np.save(tmp / "faults.npy", faults)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REF_PROG, str(tmp / "faults.npy"),
         str(tmp / "lists.json"), str(ROOT / "tests")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((tmp / "lists.json").read_text())


def _rows(faults, method, direction):
    mi, di = METHODS.index(method), DIRECTIONS.index(direction)
    return [(str(i), r) for i, r in enumerate(faults) if (r[0], r[1]) == (mi, di)]


# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------

def test_fault_rows_cover_every_phase_kind_and_both_blocks(faults):
    """The picked faults: every message phase of every method and
    direction takes its bitflip, the senders of each phase sit in both
    blocks, and every bitflip on an exchange that crosses processes goes
    from process 0 to process 1."""
    from repro_torch.core.integrity import message_phases
    per_node = TOPO[0] // N_PROC
    for mi, method in enumerate(METHODS):
        for di in range(2):
            mine = faults[(faults[:, 0] == mi) & (faults[:, 1] == di)]
            for phase in message_phases(method):
                rows = mine[mine[:, 2] == PHASE_NAMES.index(phase)]
                assert 1 in rows[:, 3], (method, di, phase)
                assert {int(n) // per_node for n in rows[:, 4]} == {0, 1}, (method, phase)
                if phase in CROSSING.values():
                    flip = rows[rows[:, 3] == 1][0]
                    far = TOPO[0] * (TOPO[1] if phase != "inter" else 1) // N_PROC
                    assert flip[4] < per_node and flip[6] >= far
            assert (mine[:, 2] == PHASE_NAMES.index("compute")).sum() == 1


@pytest.mark.parametrize("method,direction", CASES, ids=_ids(CASES))
def test_detect_across_processes_equals_one_process(stack_run, one_process, faults,
                                                    method, direction):
    """Clean detect applies at nv = 1 and 3 are bit-equal to one process's
    in both processes, with no mismatch; every scripted fault raises in
    both processes with one process's attributed mismatch list."""
    arrays1, lists1, reports1 = one_process
    for arrays, meta in stack_run:
        for nv in NV:
            key = f"{method}/{direction}/{nv}/clean"
            assert np.array_equal(arrays[key], arrays1[key]), key
        rep = meta["reports"][f"{method}/clean"]
        assert rep["wire_mismatches"] == rep["abft_mismatches"] == 0 < rep["wire_checks"]
        assert rep == reports1[f"{method}/clean"]
        for i, _ in _rows(faults, method, direction):
            assert meta["lists"][i] and meta["lists"][i] == lists1[i], i
        assert meta["reports"][f"{method}/detect"] == reports1[f"{method}/detect"]


@pytest.mark.parametrize("method,direction", CASES, ids=_ids(CASES))
def test_detect_across_processes_matches_reference(stack_run, reference_lists, faults,
                                                   method, direction):
    """Each fault's mismatch list in both processes equals the reference's
    instrumented shard_map program's on the same layout."""
    rows = _rows(faults, method, direction)
    assert rows
    for _, meta in stack_run:
        for i, _ in rows:
            assert meta["lists"][i] == reference_lists[i], i


@pytest.mark.parametrize("method,direction", CASES, ids=_ids(CASES))
def test_recover_across_processes_bit_equal_to_clean(stack_run, one_process, faults,
                                                     method, direction):
    """Under recover a cross-process fault is retried once and both
    processes return the clean apply bit for bit, with one process's
    counters."""
    arrays1, _, reports1 = one_process
    want = arrays1[f"{method}/{direction}/1/clean"]
    for arrays, meta in stack_run:
        assert np.array_equal(arrays[f"{method}/{direction}/recovered"], want)
        rep = meta["reports"][f"{method}/recover"]
        assert rep == reports1[f"{method}/recover"]
        assert rep["retries"] == rep["recovered"] == 2 and rep["pending_faults"] == 0


def test_cross_process_inter_fault_is_seen_by_its_receiver(stack_run, faults):
    """The inter bitflip from a rank of process 0 reaches a node of
    process 1, which reports it, and both processes raise with it."""
    mi = METHODS.index("nap")
    i, row = next((str(i), r) for i, r in enumerate(faults)
                  if (r[0], r[1], r[2], r[3]) == (mi, 0, PHASE_NAMES.index("inter"), 1))
    lists = [meta["lists"][i] for _, meta in stack_run]
    assert lists[0] == lists[1]
    check, phase, scope, node, proc, slot, direction = lists[0][0]
    assert (check, phase, scope, direction) == ("wire", "inter", "off_node", "forward")
    assert (node, proc, slot) == (row[6], row[5], row[4])
    assert node >= TOPO[0] // N_PROC > slot


@pytest.mark.parametrize("method", METHODS)
def test_checksum_words_cross_processes(stack_run, method):
    """The instrumented program sends, beside the bare program's payloads,
    each sender's int64 checksum words through the same exchange: one
    word a message to the other process's nodes (node axis) or ranks
    (node x proc axis)."""
    p_loc, n_nodes, n_procs = TOPO[0] * TOPO[1] // N_PROC, TOPO[0], TOPO[0] * TOPO[1]
    for _, meta in stack_run:
        for direction in DIRECTIONS:
            bare = meta["sent"][f"{method}/{direction}/off"]
            inst = meta["sent"][f"{method}/{direction}/detect"]
            node = inst["sent_bytes_node"] - bare["sent_bytes_node"]
            ranks = inst["sent_bytes_nodexproc"] - bare["sent_bytes_nodexproc"]
            assert node == (0 if method == "standard" else p_loc * n_nodes // N_PROC * 8)
            assert ranks == (0 if method == "nap" else p_loc * n_procs // N_PROC * 8)


# ---------------------------------------------------------------------------
# AMG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("materialize", [False, True])
def test_amg_across_processes_bit_equal_to_one_process(stack_run, materialize):
    """``level_operators`` over rank blocks, a V-cycle and 10 PCG
    iterations: the coarse matrices, the V-cycle's output, the iterate and
    every residual equal one process's bit for bit, in both processes."""
    want, distributed = amg_run(materialize)
    for arrays, meta in stack_run:
        assert meta[f"amg/{materialize}/distributed"] == distributed
        for k, w in want.items():
            got = arrays[f"amg/{materialize}/{k}"]
            assert got.dtype == w.dtype and np.array_equal(got, w), k


def test_amg_coarse_levels_with_empty_ranks(stack_run):
    """Every level is distributed (min_rows 1), the coarsest with fewer
    rows than ranks: its P's column partition leaves ranks empty in both
    blocks."""
    from repro_torch.core.partition import contiguous_partition
    levels = amg_levels()
    n_procs = TOPO[0] * TOPO[1]
    assert levels[-1].a.shape[0] < n_procs
    owners = contiguous_partition(levels[-1].a.shape[0], n_procs).owner
    assert len(set(owners.tolist())) < n_procs
    for _, meta in stack_run:
        assert meta["amg/True/distributed"] == [1] * len(levels)


@pytest.mark.parametrize("materialize", [False, True])
def test_amg_across_processes_matches_reference(stack_run, materialize):
    """Within the reference's f32 bar of its float64 host hierarchy: the
    V-cycle and the iterate at rtol 1e-4 / atol 1e-5, the PCG residuals at
    rtol 1e-3 while the reference's stay above float32's reach (1e-5; the
    float32 operators' residuals level off below it)."""
    from repro.amg import amg_vcycle, cg_solve, level_operators
    from repro.core.topology import Topology as RefTopology
    levels = amg_levels("ref")
    ops = level_operators(levels, RefTopology(*TOPO), min_rows=AMG_MIN_ROWS,
                          backend="simulate", pairing="aligned")
    b = np.random.default_rng(12).standard_normal(levels[0].a.shape[0])
    hist = []
    x, _, _ = cg_solve(levels[0].a, b, tol=0.0, maxiter=10, spmv=ops[0].a,
                       precond=lambda r: amg_vcycle(levels, r, operators=ops),
                       callback=lambda it, x: hist.append(
                           np.linalg.norm(b - levels[0].a.matvec(x)) / np.linalg.norm(b)))
    for arrays, _ in stack_run:
        np.testing.assert_allclose(arrays[f"amg/{materialize}/vcycle"],
                                   amg_vcycle(levels, b, operators=ops), **TOL)
        got, hist = arrays[f"amg/{materialize}/hist"], np.array(hist)
        above = hist > 1e-5
        assert above.sum() >= 4 and got.size == hist.size == 10
        np.testing.assert_allclose(got[above], hist[above], rtol=1e-3)
        assert np.all(got[~above] <= 1e-5)
        np.testing.assert_allclose(arrays[f"amg/{materialize}/x"], x, **TOL)


# ---------------------------------------------------------------------------
# the solver service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def service_one_process(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt1")
    out, results = service_run(str(ckpt))
    return out, results, checkpoint_digests(ckpt)


def test_service_node_loss_across_processes(stack_run, service_one_process):
    """The hot swap, the two lost nodes (one of each block) and the resume
    on Topology(2, 2): logs, stats, plan-cache counters, ticket states and
    every result equal one process's run, in both processes."""
    want, results, _ = service_one_process
    assert want["topo"] == [2, 2] and want["nodes"] == ["node0", "node2"]
    assert want["stats"]["recoveries"] == 1 and want["plan_cache"]["hot_swaps"] == 1
    assert any("restored checkpointed iterates (iteration 8)" in line
               for line in want["log"])
    assert all(t[0] == "done" for t in want["tickets"])
    for arrays, meta in stack_run:
        assert meta["service"] == want
        assert set(k[len("service/"):] for k in arrays if k.startswith("service/")) \
            == set(results)
        for k, w in results.items():
            assert np.array_equal(arrays[f"service/{k}"], w), k


def test_service_checkpoints_written_by_process_zero(stack_run, service_one_process):
    """Process 0 alone saves; both read the same committed steps, whose
    shard digests and extras equal one process's."""
    _, _, digests = service_one_process
    saves = [meta["saves"] for _, meta in stack_run]
    assert saves[0] > 0 and saves[1] == 0
    for _, meta in stack_run:
        assert meta["digests"] == digests and len(digests) == 3


def test_service_ragged_survivors_raise_in_every_process(stack_run):
    """One node lost leaves Topology(3, 2): no block of whole nodes per
    process, so the recovery raises DiscoveryError in both."""
    for _, meta in stack_run:
        assert "multiple of the process count" in meta["ragged"], meta["ragged"]


def test_plan_cache_takes_the_survivors_mesh(stack_run):
    """The plan cache compiles for its topology's blocks; a rebuild forgets
    the old mesh for the survivors', and a ragged one raises with the cache
    untouched."""
    for (_, meta), pid in zip(stack_run, range(N_PROC)):
        before, after, ragged = meta["cache_mesh"]
        assert before == [2 * pid, 2 * pid + 2] == meta["nodes"]
        assert after == [pid, pid + 1, 2]
        assert ragged == [2, 1]


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "child":
        child(*sys.argv[2:])
    else:
        sys.exit("usage: test_torch_mesh_stack.py child OUT_DIR FAULTS CKPT_DIR "
                 "(under launch())")
