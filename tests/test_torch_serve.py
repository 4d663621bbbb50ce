"""The port's solver service against the JAX package's service tests.

Every scenario of ``tests/test_serve.py`` (admission, batching, hot swap,
crash consistency, fault plans, the elastic-recovery path and the
runtime satellites) runs on the port: the service scenarios on the
float64 simulate backend and on the device program with
``device="cpu"`` (float32, where the integer-valued Laplacian and
integer right-hand sides keep every SpMV exact).  Solves on the device
program use a tolerance float32 reaches (``SOLVE_TOL``) and check the
true residual at 10x it.  A cross-package test then runs one fault plan
through both packages' services on simulate: logs, stats, reports and
results identical.
"""
import dataclasses

import numpy as np
import pytest

import repro.serve as ref_serve
from repro.core.topology import Topology as RefTopology
from repro.sparse.csr import CSR as RefCSR

import repro_torch.api as nap
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core.partition import contiguous_partition, survivor_partition
from repro_torch.core.spmv_torch import clear_compile_cache
from repro_torch.core.topology import Topology
from repro_torch.runtime import ElasticPolicy, HeartbeatMonitor
from repro_torch.serve import (REJECT_BAD_OPERAND, REJECT_DEADLINE_UNMEETABLE,
                               REJECT_FLEET_DEGRADED, REJECT_QUEUE_FULL,
                               REJECT_UNKNOWN_MATRIX, FaultEvent, FaultPlan,
                               ManualClock, PlanCache, SolverService,
                               batched_cg, dead_node, straggler,
                               structure_key, torn_checkpoint,
                               values_fingerprint)
from repro_torch.sparse.csr import CSR

BACKENDS = {"simulate": dict(backend="simulate"),
            "torch-cpu": dict(backend="torch", device="cpu")}
# (requested tol, bound on the true relative residual) per backend
SOLVE_TOL = {"simulate": (1e-11, 1e-10), "torch-cpu": (1e-5, 1e-4)}


def int_laplacian(m, diag=8.0, csr=CSR):
    """Integer-valued SPD 5-point Laplacian (+diag*I): with integer
    right-hand sides every SpMV is exact in float32 and float64, hence
    the same on every topology."""
    n = m * m
    rows, cols, vals = [], [], []
    for i in range(m):
        for j in range(m):
            k = i * m + j
            rows.append(k); cols.append(k); vals.append(diag)
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < m and 0 <= jj < m:
                    rows.append(k); cols.append(ii * m + jj); vals.append(-1.0)
    return csr.from_coo(np.array(rows), np.array(cols), np.array(vals), (n, n))


def scaled(a, factor):
    return type(a)(indptr=a.indptr.copy(), indices=a.indices.copy(),
                   data=a.data * factor, shape=a.shape)


def make_service(backend, topo=None, **kw):
    return SolverService(topo or Topology(2, 2), **BACKENDS[backend], **kw)


def relres(dense, x, b):
    return np.linalg.norm(dense @ x - b) / np.linalg.norm(b)


backends = pytest.mark.parametrize("backend", list(BACKENDS))


# ------------------------- admission / batching ----------------------------

@backends
def test_submit_solve_roundtrip(backend):
    a = int_laplacian(8)
    dense = a.to_dense()
    tol, bound = SOLVE_TOL[backend]
    svc = make_service(backend)
    svc.register_matrix("lap", a)
    rng = np.random.default_rng(0)
    b = rng.integers(-8, 9, a.shape[0]).astype(np.float64)
    t1 = svc.submit("acme", "lap", b, kind="spmv")
    t2 = svc.submit("acme", "lap", b, kind="solve", tol=tol)
    assert t1.status == "queued" and t2.status == "queued"
    svc.run()
    np.testing.assert_array_equal(t1.result(), dense @ b)
    assert relres(dense, t2.result(), b) < bound
    rep = svc.report()
    assert rep["stats"]["completed"] == 2
    acct = rep["tenants"]["acme"]
    assert acct["completed"] == 2 and acct["cg_iters"] == t2.request.iters
    assert acct["plan"], "op.stats() rollup should be non-empty"


@backends
def test_admission_reject_reasons(backend):
    a = int_laplacian(4)
    svc = make_service(backend, queue_limit=2)
    svc.register_matrix("lap", a)
    b = np.ones(a.shape[0])
    assert svc.submit("t", "nope", b).reason == REJECT_UNKNOWN_MATRIX
    assert svc.submit("t", "lap", np.ones(7)).reason == REJECT_BAD_OPERAND
    assert svc.submit("t", "lap", b,
                      deadline=-1.0).reason == REJECT_DEADLINE_UNMEETABLE
    assert svc.submit("t", "lap", b).status == "queued"
    assert svc.submit("t", "lap", b).status == "queued"
    full = svc.submit("t", "lap", b)
    assert full.status == "rejected" and full.reason == REJECT_QUEUE_FULL
    with pytest.raises(ValueError):
        svc.submit("t", "lap", b, kind="invert")
    with pytest.raises(ValueError):
        full.result()
    assert svc.report()["stats"]["rejected"] == 4


@backends
def test_batching_aggregates_concurrent_rhs(backend):
    """Concurrent same-matrix requests execute as ONE multi-RHS batch."""
    a = int_laplacian(6)
    dense = a.to_dense()
    svc = make_service(backend, batch_limit=8)
    svc.register_matrix("lap", a)
    rng = np.random.default_rng(1)
    B = rng.integers(-5, 6, size=(a.shape[0], 5)).astype(float)
    tickets = [svc.submit("t", "lap", B[:, i], kind="spmv") for i in range(5)]
    rep = svc.step()
    assert rep["executed"] == 5
    for i, t in enumerate(tickets):
        np.testing.assert_array_equal(t.result(), dense @ B[:, i])
    if backend == "torch-cpu":    # one nv = 5 program build, no other
        op = svc.plans.operator_for(a, svc.matrices["lap"]["row_part"])
        assert op.trace_counts() == {"forward": 1}


@backends
def test_deadline_expires_in_queue(backend):
    a = int_laplacian(4)
    svc = make_service(backend, batch_limit=1, dt=10.0)
    svc.register_matrix("lap", a)
    b = np.ones(a.shape[0])
    early = svc.submit("t", "lap", b, deadline=5.0)
    late = svc.submit("t", "lap", b, deadline=100.0)
    svc.step()
    assert early.status == "expired"
    assert late.status == "done"
    assert svc.report()["stats"]["expired"] == 1


@backends
def test_run_is_bounded_never_deadlocks(backend):
    a = int_laplacian(4)
    plan = FaultPlan.of(FaultEvent(step=1, kind="dead_node", node="node0"),
                        FaultEvent(step=1, kind="dead_node", node="node1"))
    svc = make_service(backend, fault_plan=plan, max_attempts=2, backoff=0.1)
    svc.register_matrix("lap", a)
    t = svc.submit("t", "lap", np.ones(a.shape[0]))
    steps = svc.run(max_steps=30)
    assert steps <= 30
    assert t.status == "failed"
    for _ in range(4):
        svc.step()
    assert svc.degraded
    assert svc.submit("t", "lap",
                      np.ones(a.shape[0])).reason == REJECT_FLEET_DEGRADED


# ------------------------- batched CG --------------------------------------

def test_batched_cg_matches_solo_columns():
    """Frozen-column batching: each column of a multi-RHS CG equals its
    own 1-RHS solve bit for bit under a columnwise ``mv``."""
    a = int_laplacian(7)
    dense = a.to_dense()

    def mv(V):
        return np.stack([dense @ V[:, i] for i in range(V.shape[1])], axis=1)

    rng = np.random.default_rng(3)
    B = rng.standard_normal((a.shape[0], 4))
    B[:, 1] *= 100.0
    X, iters, rel = batched_cg(mv, B, tol=1e-11, maxiter=200)
    assert (rel < 1e-11).all()
    assert len(set(iters.tolist())) > 1, "columns should converge at different its"
    for i in range(B.shape[1]):
        xi, _, _ = batched_cg(mv, B[:, i:i + 1], tol=1e-11, maxiter=200)
        np.testing.assert_array_equal(X[:, i], xi[:, 0])


def test_batched_cg_warm_start_and_matches_reference():
    a = int_laplacian(6)
    dense = a.to_dense()
    b = np.random.default_rng(4).standard_normal((a.shape[0], 1))
    x_cold, it_cold, _ = batched_cg(lambda V: dense @ V, b, tol=1e-11)
    X0 = 0.9 * x_cold
    x_warm, it_warm, _ = batched_cg(lambda V: dense @ V, b, tol=1e-11, X0=X0)
    assert it_warm[0] < it_cold[0]
    np.testing.assert_allclose(dense @ x_warm[:, 0], b[:, 0], atol=1e-8)
    for got, want in zip(batched_cg(lambda V: dense @ V, b, tol=1e-11, X0=X0),
                         ref_serve.batched_cg(lambda V: dense @ V, b,
                                              tol=1e-11, X0=X0)):
        np.testing.assert_array_equal(got, want)


# ------------------------- plan cache / hot swap ---------------------------

@backends
def test_plan_cache_hit_swap_miss_evict(backend):
    topo = Topology(2, 2)
    a = int_laplacian(6)
    part = contiguous_partition(a.shape[0], topo.n_procs)
    cache = PlanCache(topo, max_entries=2, **BACKENDS[backend])
    op1 = cache.operator_for(a, part)
    assert cache.stats["misses"] == 1
    assert cache.operator_for(a, part) is op1
    assert cache.stats["hits"] == 1
    a2 = scaled(a, 3.0)
    assert cache.operator_for(a2, part) is op1
    assert cache.stats["hot_swaps"] == 1
    v = np.arange(a.shape[0], dtype=float)
    np.testing.assert_array_equal(op1 @ v, 3.0 * (a.to_dense() @ v))
    cache.operator_for(int_laplacian(5), contiguous_partition(25, 4))
    cache.operator_for(int_laplacian(4), contiguous_partition(16, 4))
    assert len(cache) == 2 and cache.stats["evictions"] == 1
    p2 = contiguous_partition(a.shape[0], topo.n_procs)
    k1 = structure_key(a, part, part, topo, "nap", backend)
    k2 = structure_key(a2, p2, p2, topo, "nap", backend)
    assert k1 == k2
    assert values_fingerprint(a) != values_fingerprint(a2)
    dropped = cache.rebuild(Topology(1, 2))
    assert dropped == 2 and len(cache) == 0
    assert cache.topo.n_nodes == 1 and cache.stats["rebuilds"] == 1


@backends
def test_service_hot_swap_zero_recompile(backend):
    a = int_laplacian(6)
    svc = make_service(backend)
    svc.register_matrix("lap", a)
    b = np.ones(a.shape[0])
    t1 = svc.submit("t", "lap", b, kind="spmv")
    svc.run()
    svc.update_values("lap", scaled(a, 2.0))
    t2 = svc.submit("t", "lap", b, kind="spmv")
    svc.run()
    np.testing.assert_array_equal(t2.result(), 2.0 * t1.result())
    assert svc.plans.stats == {"hits": 0, "misses": 1, "hot_swaps": 1,
                               "evictions": 0, "rebuilds": 0}
    with pytest.raises(ValueError):
        svc.update_values("lap", int_laplacian(5))


def test_device_hot_swap_zero_builds():
    """The compiled program is REUSED across a value swap: build counts
    stay flat and the results track the new values (the reference's
    ``test_shardmap_hot_swap_zero_retrace`` on the port's program)."""
    a = int_laplacian(5)
    dense = a.to_dense()
    op = nap.operator(a, topo=Topology(1, 1), device="cpu", cache=False)
    v = np.random.default_rng(5).integers(-4, 5, a.shape[0]).astype(float)
    np.testing.assert_array_equal(op @ v, dense @ v)
    assert op.trace_counts() == {"forward": 1}
    op.swap_values(scaled(a, 2.0))
    np.testing.assert_array_equal(op @ v, 2.0 * (dense @ v))
    assert op.trace_counts() == {"forward": 1}, "hot swap must not rebuild"
    np.testing.assert_array_equal(op.T @ v, 2.0 * (dense.T @ v))
    assert op.trace_counts() == {"forward": 1, "transpose": 1}
    with pytest.raises(ValueError):
        op.swap_values(int_laplacian(4))


# ------------------------- crash consistency -------------------------------

def test_torn_save_restores_previous_step(tmp_path):
    tree = {"x": np.arange(6.0)}
    save_checkpoint(str(tmp_path), 1, tree, extra={"it": 1})
    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 2, {"x": np.arange(6.0) * 2},
                        extra={"it": 2},
                        on_before_commit=lambda: (_ for _ in ()).throw(
                            OSError("torn")))
    out, extra = load_checkpoint(str(tmp_path))
    assert extra["it"] == 1
    np.testing.assert_array_equal(out["x"], np.arange(6.0))


def test_manager_reraises_background_failure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": np.ones(3)}, block=True)

    def boom():
        raise OSError("disk full")
    mgr.save(2, {"x": np.ones(3)}, on_before_commit=boom)
    with pytest.raises(RuntimeError, match="last committed step is 1") as ei:
        mgr.wait()
    assert isinstance(ei.value.__cause__, OSError)
    mgr.save(3, {"x": np.ones(3)}, block=True)
    assert mgr.last_saved == 3


def test_missing_shard_is_descriptive(tmp_path):
    save_checkpoint(str(tmp_path), 5, {"a": np.ones(4), "b": np.zeros(2)})
    shard = next((tmp_path / "step_00000005").glob("shard_*.npz"))
    shard.unlink()
    with pytest.raises(FileNotFoundError, match="it held 2 leaves"):
        load_checkpoint(str(tmp_path))


@backends
def test_service_survives_torn_checkpoint(backend, tmp_path):
    a = int_laplacian(8)
    tol, bound = SOLVE_TOL[backend]
    plan = FaultPlan.of(torn_checkpoint(1))
    svc = make_service(backend, Topology(2, 2), fault_plan=plan,
                       checkpoint_dir=str(tmp_path), checkpoint_every=3)
    svc.register_matrix("lap", a)
    b = np.random.default_rng(6).standard_normal(a.shape[0])
    t = svc.submit("t", "lap", b, kind="solve", tol=tol)
    svc.run()
    assert t.status == "done"
    assert relres(a.to_dense(), t.result(), b) < bound
    assert svc.stats["torn_saves"] == 1
    tree, extra = svc.ckpt.restore()
    assert extra["iteration"] > 3


# ------------------------- fault plans -------------------------------------

def test_fault_plan_validation_and_clock():
    with pytest.raises(ValueError):
        FaultEvent(step=1, kind="meteor")
    with pytest.raises(ValueError):
        FaultEvent(step=1, kind="dead_node")
    clk = ManualClock()
    with pytest.raises(ValueError):
        clk.advance(-1.0)
    clk.advance(2.5)
    assert clk() == 2.5
    plan = FaultPlan.of(straggler(5, "n1"), dead_node(2, "n0"))
    assert [e.step for e in plan.events] == [2, 5]
    assert len(plan.at(2)) == 1 and plan.at(3) == []


@pytest.mark.parametrize("ppn", [None, 2])
def test_fault_plan_random_is_deterministic_and_matches_reference(ppn):
    nodes = ["node0", "node1", "node2"]
    p1 = FaultPlan.random(seed=42, nodes=nodes, n_steps=10, n_events=3, ppn=ppn)
    p2 = FaultPlan.random(seed=42, nodes=nodes, n_steps=10, n_events=3, ppn=ppn)
    assert p1 == p2
    assert FaultPlan.random(seed=43, nodes=nodes, n_steps=10, n_events=3,
                            ppn=ppn) != p1
    for seed in range(12):
        mine = FaultPlan.random(seed=seed, nodes=nodes, n_steps=10,
                                n_events=4, ppn=ppn)
        ref = ref_serve.FaultPlan.random(seed=seed, nodes=nodes, n_steps=10,
                                         n_events=4, ppn=ppn)
        assert _events(mine) == _events(ref)


def _events(plan):
    return [(e.step, e.kind, e.node, e.slowdown, e.at_iteration,
             None if e.fault is None else dataclasses.asdict(e.fault))
            for e in plan.events]


@backends
def test_same_seed_same_eviction_step(backend):
    a = int_laplacian(6)

    def run_once():
        plan = FaultPlan.random(seed=9, nodes=["node0", "node1", "node2"],
                                n_steps=3, n_events=1)
        svc = make_service(backend, Topology(3, 2), fault_plan=plan,
                           heartbeat_timeout=2.5, max_attempts=6)
        svc.register_matrix("lap", a)
        tickets = [svc.submit("t", "lap", np.ones(a.shape[0]))
                   for _ in range(3)]
        svc.run(max_steps=40)
        evict_logs = [line for line in svc.log if "evicted" in line]
        return tuple(evict_logs), tuple(t.status for t in tickets)

    assert run_once() == run_once()


# ------------------------- elastic recovery (E2E) --------------------------

@backends
def test_e2e_midsolve_node_loss_bit_identical(backend, tmp_path):
    """A node dies at CG iteration 4 mid-solve; the service evicts it,
    repartitions onto the survivors, rebuilds, restores the checkpointed
    iterate and re-executes; the SpMV answer is bit-identical to the
    uninterrupted run (integer data: exact arithmetic)."""
    a = int_laplacian(8)
    dense = a.to_dense()
    tol, bound = SOLVE_TOL[backend]
    rng = np.random.default_rng(7)
    b_int = rng.integers(-8, 9, size=a.shape[0]).astype(np.float64)
    b_f = rng.standard_normal(a.shape[0])
    topo = Topology(3, 2)

    def build(**kw):
        svc = make_service(backend, topo, queue_limit=16, heartbeat_timeout=2.5,
                           checkpoint_every=3, max_attempts=5, backoff=0.5,
                           **kw)
        svc.register_matrix("lap", a)
        return svc

    ref = build()
    r1 = ref.submit("t", "lap", b_int, kind="spmv")
    r2 = ref.submit("t", "lap", b_f, kind="solve", tol=tol, maxiter=300)
    ref.run()

    plan = FaultPlan.of(dead_node(1, "node1", at_iteration=4))
    svc = build(fault_plan=plan, checkpoint_dir=str(tmp_path))
    f1 = svc.submit("t", "lap", b_int, kind="spmv")
    f2 = svc.submit("t", "lap", b_f, kind="solve", tol=tol, maxiter=300)
    svc.run(max_steps=60)

    assert f1.status == "done" and f2.status == "done"
    assert svc.stats["recoveries"] == 1
    assert svc.topo == Topology(2, 2) and svc.nodes == ["node0", "node2"]
    assert svc.stats["last_recover_rebuild_s"] > 0
    assert any("died mid-solve at CG iteration 4" in line for line in svc.log)
    assert np.array_equal(f1.result(), r1.result())
    np.testing.assert_array_equal(f1.result(), dense @ b_int)
    assert relres(dense, f2.result(), b_f) < bound
    np.testing.assert_allclose(f2.result(), r2.result(), atol=10 * bound)
    assert any("restored checkpointed iterates" in line for line in svc.log)
    assert f2.request.iters < r2.request.iters
    part = svc.matrices["lap"]["row_part"]
    assert part.n_procs == 4 and part.kind == "elastic"


@backends
def test_e2e_recovery_matches_survivor_oracle(backend, tmp_path):
    """The recovered solve equals an oracle run natively on the survivor
    layout from the same warm start, compiled on its own."""
    a = int_laplacian(8)
    tol, _ = SOLVE_TOL[backend]
    b = np.random.default_rng(8).standard_normal(a.shape[0])
    plan = FaultPlan.of(dead_node(1, "node2", at_iteration=4))
    svc = make_service(backend, Topology(3, 2), fault_plan=plan,
                       checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       heartbeat_timeout=2.5, max_attempts=5, backoff=0.5)
    svc.register_matrix("lap", a)
    t = svc.submit("t", "lap", b, kind="solve", tol=tol, maxiter=300)
    svc.run(max_steps=60)
    assert t.status == "done" and svc.stats["recoveries"] == 1

    # the warm start is the iterate the recovery restored (iteration 4);
    # the latest checkpoint may come from the retried solve itself
    assert any("restored checkpointed iterates (iteration 4)" in line
               for line in svc.log)
    part = svc.matrices["lap"]["row_part"]
    clear_compile_cache()
    op = nap.operator(a, topo=svc.topo, row_part=part, **BACKENDS[backend])
    X, _, _ = batched_cg(op, b[:, None], tol=tol, maxiter=300,
                         X0=t.request.x0[:, None])
    np.testing.assert_array_equal(t.result(), X[:, 0])


@backends
def test_straggler_evicts_through_recovery(backend):
    a = int_laplacian(6)
    plan = FaultPlan.of(straggler(2, "node2", slowdown=8.0))
    svc = make_service(backend, Topology(3, 2), fault_plan=plan,
                       heartbeat_timeout=50.0)
    svc.register_matrix("lap", a)
    t = svc.submit("t", "lap", np.ones(a.shape[0]))
    for _ in range(12):
        svc.step()
    assert t.status == "done"
    assert svc.stats["recoveries"] == 1
    assert "node2" not in svc.nodes and svc.topo.n_nodes == 2


# ------------------------- runtime satellites ------------------------------

def test_heartbeat_unknown_node_raises():
    t = [0.0]
    mon = HeartbeatMonitor(["n0"], timeout=5.0, clock=lambda: t[0])
    with pytest.raises(KeyError, match="unregistered"):
        mon.beat("n0-typo")
    mon.beat("n1", register=True)
    assert "n1" in mon.last


def test_global_batch_plan_exact():
    pol = ElasticPolicy()
    per_row, accum = pol.global_batch_plan(96, old_data=8, new_data=6)
    assert per_row * 6 * accum == 96
    assert per_row <= 96 // 8
    with pytest.raises(ValueError, match="not divisible"):
        pol.global_batch_plan(96, old_data=8, new_data=7)


def test_survivor_topology_rules():
    pol = ElasticPolicy()
    t = pol.survivor_topology(Topology(4, 2), [1, 3])
    assert t == Topology(2, 2)
    assert pol.survivor_topology(Topology(2, 2), [0, 1]) is None


def test_survivor_partition_properties():
    part = contiguous_partition(40, 4)
    new = survivor_partition(part, [1])
    assert new.n_procs == 3 and new.kind == "elastic"
    for old_r, new_r in [(0, 0), (2, 1), (3, 2)]:
        assert np.all(np.isin(part.rows_of(old_r), new.rows_of(new_r)))
    np.testing.assert_array_equal(np.sort(np.concatenate(
        [new.rows_of(r) for r in range(3)])), np.arange(40))
    counts = new.counts()
    assert counts.max() - counts.min() <= 1
    again = survivor_partition(part, (1, 1))
    np.testing.assert_array_equal(new.owner, again.owner)
    with pytest.raises(ValueError):
        survivor_partition(part, [0, 1, 2, 3])
    with pytest.raises(ValueError):
        survivor_partition(part, [9])


# ------------------------- the same scenario in both packages --------------

def _scenario(serve, topo, csr, fault_plan, tmp):
    a = int_laplacian(8, csr=csr)
    rng = np.random.default_rng(11)
    b_int = rng.integers(-8, 9, size=a.shape[0]).astype(np.float64)
    b_f = rng.standard_normal((a.shape[0], 2))
    svc = serve.SolverService(topo, backend="simulate", fault_plan=fault_plan,
                              checkpoint_dir=str(tmp), checkpoint_every=3,
                              heartbeat_timeout=2.5, max_attempts=5,
                              backoff=0.5, queue_limit=16)
    svc.register_matrix("lap", a)
    tickets = [svc.submit("t0", "lap", b_int, kind="spmv"),
               svc.submit("t1", "lap", b_f[:, 0], kind="solve", tol=1e-11),
               svc.submit("t1", "lap", b_f[:, 1], kind="solve", tol=1e-11,
                          deadline=40.0)]
    svc.run(max_steps=60)
    svc.update_values("lap", scaled(a, 2.0))
    tickets.append(svc.submit("t0", "lap", b_int, kind="spmv"))
    svc.run(max_steps=20)
    rep = svc.report()
    rep["stats"].pop("last_recover_rebuild_s")
    results = [t.result() if t.status == "done" else None for t in tickets]
    return (svc.log, rep, [(t.status, t.reason, t.request.iters)
                           for t in tickets], results)


@pytest.mark.parametrize("make_plan", [
    lambda s: s.FaultPlan.of(s.dead_node(1, "node1", at_iteration=4)),
    lambda s: s.FaultPlan.of(s.straggler(2, "node2", slowdown=8.0),
                             s.torn_checkpoint(1)),
    lambda s: s.FaultPlan.random(seed=5, nodes=["node0", "node1", "node2"],
                                 n_steps=6, n_events=3),
], ids=["midsolve-death", "straggler-torn", "random"])
def test_service_matches_reference_on_simulate(make_plan, tmp_path):
    """One fault plan through both packages' services on the simulate
    backend: logs, stats, report (bar the rebuild's wall seconds),
    ticket states and results identical."""
    import repro_torch.serve as port_serve
    mine = _scenario(port_serve, Topology(3, 2), CSR, make_plan(port_serve),
                     tmp_path / "port")
    ref = _scenario(ref_serve, RefTopology(3, 2), RefCSR, make_plan(ref_serve),
                    tmp_path / "ref")
    assert mine[0] == ref[0]
    assert mine[1] == ref[1]
    assert mine[2] == ref[2]
    for got, want in zip(mine[3], ref[3]):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
