"""The port's distributed SpGEMM against the JAX package, on the CPU.

Exact wherever the reference is exact: the plans (value pads, recv value
maps, value-weighted stats), every compiled array and the C structure,
packing, the float64 simulators (bit for bit the reference's and both
packages' ``csr_matmul``), integer-valued products of the device program,
the forward checksums of the instrumented program and the attributed
mismatches of every scripted fault (against the reference's instrumented
shard_map program on a forced 4-device host platform).  Float products of
the device program meet the reference's own bars: rtol 1e-4 / atol 1e-4
in float32 (``tests/multidev/spgemm_prog.py``), rtol 1e-12 / atol 1e-13
in float64.  The reference's API tests of RAP and ``materialize`` run
here on the port.
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

import repro.core.partition as ref_part
import repro.spgemm as ref_sg
from repro.amg.matmul import csr_matmul as ref_csr_matmul
from repro.core.topology import Topology as RefTopology
from repro.sparse import CSR as RefCSR

import repro_torch.api as port_api
import repro_torch.core.partition as port_part
import repro_torch.spgemm as sg
import repro_torch.spgemm.plan as sg_plan
import repro_torch.spgemm.spgemm_torch as sg_torch
from repro_torch.amg import (amg_vcycle, level_operators,
                             smoothed_aggregation_hierarchy)
from repro_torch.amg.matmul import csr_matmul
from repro_torch.core.integrity import (FAULT_KINDS, IntegrityError, MessageFault,
                                        build_fault_spec)
from repro_torch.core.topology import Topology
from repro_torch.sparse import CSR, rotated_anisotropic_2d

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-4, atol=1e-4)
F64 = dict(rtol=1e-12, atol=1e-13)

# (m, k, n): square / tall / wide / empty-rank (mid dim below the machine)
SHAPES = [(48, 48, 48), (72, 40, 56), (40, 72, 64), (48, 5, 40)]
PARTS = ("contiguous", "strided", "empty")


def _dense(rng, m, n, density=0.25, integer=False):
    vals = rng.integers(-3, 4, (m, n)).astype(float) if integer \
        else rng.standard_normal((m, n))
    return (rng.random((m, n)) < density) * vals


def _partitions(kind, n, n_procs):
    """The same partition in both packages; ``"empty"`` puts every row on
    the first half of the ranks (the rest own nothing)."""
    if kind == "empty":
        half = max(1, n_procs // 2)
        owner = np.arange(n) * half // max(n, 1)
        return (ref_part._from_owner(owner, n_procs, "empty"),
                port_part.partition_from_owner(owner, n_procs, "empty"))
    mk = f"{kind}_partition"
    return getattr(ref_part, mk)(n, n_procs), getattr(port_part, mk)(n, n_procs)


def _case(shape, kind, seed, nn=2, ppn=3, integer=False):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    am, bm = _dense(rng, m, k, integer=integer), _dense(rng, k, n, integer=integer)
    rp = _partitions(kind, m, nn * ppn)
    mp = _partitions(kind, k, nn * ppn)
    return dict(am=am, bm=bm, ref=(RefCSR.from_dense(am), RefCSR.from_dense(bm),
                                   rp[0], mp[0], RefTopology(nn, ppn)),
                port=(CSR.from_dense(am), CSR.from_dense(bm), rp[1], mp[1],
                      Topology(nn, ppn)))


def _same_csr(x, y):
    assert x.shape == y.shape
    assert np.array_equal(x.indptr, y.indptr)
    assert np.array_equal(x.indices, y.indices)
    assert np.array_equal(x.data, y.data)


# ----------------------------- plans and compile -----------------------------

@pytest.mark.parametrize("method", ["nap", "standard"])
@pytest.mark.parametrize("kind", PARTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_matches_reference(method, kind, shape):
    c = _case(shape, kind, seed=sum(shape) + len(kind))
    ref = ref_sg.build_spgemm_plan(*c["ref"], method=method)
    got = sg.build_spgemm_plan(*c["port"], method=method)
    assert got.shape == ref.shape and got.method == ref.method
    assert np.array_equal(got.b_counts, ref.b_counts)
    assert got.value_pads() == ref.value_pads()
    phases = ("pair",) if method == "standard" else ("full", "init", "inter", "final")
    for r in range(got.topo.n_procs):
        for ph in phases:
            vpad = got.value_pads()[ph]
            for x, y in zip(got.recv_value_map(r, ph, vpad),
                            ref.recv_value_map(r, ph, vpad)):
                assert np.array_equal(x, y)
    for bpv in (4, 8):
        assert {k: v.__dict__ for k, v in got.stats(bpv).items()} == \
            {k: v.__dict__ for k, v in ref.stats(bpv).items()}
    assert np.array_equal(
        sg_plan.local_value_index(c["port"][3], got.b_counts),
        ref_sg.plan.local_value_index(c["ref"][3], ref.b_counts))


@pytest.mark.parametrize("method", ["nap", "standard"])
@pytest.mark.parametrize("kind", PARTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_compile_matches_reference(method, kind, shape):
    c = _case(shape, kind, seed=3 * sum(shape) + len(kind))
    ref = ref_sg.compile_spgemm(*c["ref"], method=method, cache=False)
    got = sg.compile_spgemm(*c["port"], method=method, cache=False, device="cpu")
    assert (got.b_nnz_pad, got.vpads, got.exp_pad, got.c_nnz_pad, got.c_nnz) == \
        (ref.b_nnz_pad, ref.vpads, ref.exp_pad, ref.c_nnz_pad, ref.c_nnz)
    assert got.shape == ref.shape and sorted(got.arrays) == sorted(ref.arrays)
    for k, v in ref.arrays.items():
        assert got.arrays[k].dtype == v.dtype, k
        assert np.array_equal(got.arrays[k], v), k
    for x, y in zip(got.c_rows + got.c_cols, ref.c_rows + ref.c_cols):
        assert np.array_equal(x, y)
    assert np.array_equal(sg_torch.mid_part_value_counts(c["port"][3], got.plan.b_counts),
                          ref_sg.shardmap.mid_part_value_counts(c["ref"][3],
                                                                ref.plan.b_counts))
    for dt in (np.float32, np.float64):
        packed = sg.pack_b_values(c["port"][1], got, dt)
        assert np.array_equal(packed, ref_sg.pack_b_values(c["ref"][1], ref, dt))
    rng = np.random.default_rng(0)
    shards = rng.standard_normal((got.topo.n_procs, got.c_nnz_pad))
    _same_csr(sg.unpack_c_values(shards, got), ref_sg.unpack_c_values(shards, ref))
    _same_csr(sg.unpack_c_values(torch.from_numpy(shards), got),
              ref_sg.unpack_c_values(shards, ref))


def test_compile_cache_keys_on_structure_and_a_values():
    c = _case((40, 36, 30), "contiguous", seed=5)
    a, b, rp, mp, topo = c["port"]
    sg.clear_spgemm_cache()
    first = sg.compile_spgemm(a, b, rp, mp, topo, device="cpu")
    first.tensors(["exp_pos"])

    def hit(c):
        # a cache hit shares the host arrays, never the staged tensors
        return c.arrays["exp_pos"] is first.arrays["exp_pos"] and c is not first \
            and not c._tensors
    assert hit(sg.compile_spgemm(a, b, rp, mp, topo, device="cpu"))
    b2 = CSR(b.indptr, b.indices, b.data * 2.0, b.shape)   # B values: same program
    assert hit(sg.compile_spgemm(a, b2, rp, mp, topo, device="cpu"))
    a2 = CSR(a.indptr, a.indices, a.data * 2.0, a.shape)   # A values: baked in
    assert not hit(sg.compile_spgemm(a2, b, rp, mp, topo, device="cpu"))
    assert not hit(sg.compile_spgemm(a, b, rp, mp, topo, method="standard",
                                     device="cpu"))
    assert not hit(sg.compile_spgemm(a, b, rp, mp, topo, device="cpu", cache=False))
    assert not any(e._tensors for e in sg_torch._SPGEMM_CACHE.values())
    sg.clear_spgemm_cache()
    assert not hit(sg.compile_spgemm(a, b, rp, mp, topo, device="cpu"))
    assert (sg_torch._spgemm_cache_key(a, b, rp, mp, topo, "nap")
            == ref_sg.shardmap._spgemm_cache_key(*c["ref"][:5], "nap"))
    sg.clear_spgemm_cache()


# ----------------------------- simulators ------------------------------------

@pytest.mark.parametrize("method", ["nap", "standard"])
@pytest.mark.parametrize("kind", PARTS)
def test_simulators_bit_equal_reference_and_csr_matmul(method, kind):
    for i, shape in enumerate(SHAPES):
        c = _case(shape, kind, seed=7 * i + len(kind))
        ref_plan = ref_sg.build_spgemm_plan(*c["ref"], method=method)
        plan = sg.build_spgemm_plan(*c["port"], method=method)
        got = sg.simulate_spgemm(c["port"][0], c["port"][1], plan)
        _same_csr(got, ref_sg.simulate_spgemm(c["ref"][0], c["ref"][1], ref_plan))
        _same_csr(got, csr_matmul(c["port"][0], c["port"][1]))
        _same_csr(got, ref_csr_matmul(c["ref"][0], c["ref"][1]))
        np.testing.assert_allclose(got.to_dense(), c["am"] @ c["bm"], atol=1e-12)
        _same_csr(sg.distributed_spgemm(*c["port"], method=method,
                                        backend="simulate"), got)


def test_named_simulators_dispatch():
    c = _case((32, 24, 16), "contiguous", seed=0, nn=2, ppn=2)
    a, b = c["port"][:2]
    pn = sg.build_spgemm_plan(*c["port"], method="nap")
    ps = sg.build_spgemm_plan(*c["port"], method="standard")
    host = csr_matmul(a, b)
    for got in (sg.simulate_nap_spgemm(a, b, pn), sg.simulate_standard_spgemm(a, b, ps)):
        _same_csr(got, host)
    with pytest.raises(AssertionError):
        sg.simulate_nap_spgemm(a, b, ps)


# ----------------------------- device program on the CPU ---------------------

@pytest.mark.parametrize("method", ["nap", "standard"])
@pytest.mark.parametrize("kind", PARTS)
def test_device_program_matches_simulators(method, kind):
    for i, shape in enumerate(SHAPES):
        c = _case(shape, kind, seed=11 * i + len(kind))
        sim = sg.distributed_spgemm(*c["port"], method=method, backend="simulate")
        for dtype, tol in ((None, F32), (torch.float32, F32), (torch.float64, F64)):
            got = sg.distributed_spgemm(*c["port"], method=method, device="cpu",
                                        dtype=dtype)
            assert np.array_equal(got.indptr, sim.indptr)
            assert np.array_equal(got.indices, sim.indices)
            np.testing.assert_allclose(got.data, sim.data, **tol)


@pytest.mark.parametrize("method", ["nap", "standard"])
@pytest.mark.parametrize("kind", PARTS)
def test_device_program_exact_on_integer_data(method, kind):
    """Integer-valued A and B: every sum is exact, so the float32 and
    float64 programs and the instrumented ones (whose standard exchange
    is the literal pair table, the bare program's its live slots) all
    equal the simulator bit for bit."""
    for i, shape in enumerate(SHAPES):
        c = _case(shape, kind, seed=13 * i + len(kind), integer=True)
        sim = sg.distributed_spgemm(*c["port"], method=method, backend="simulate")
        runs = [sg.distributed_spgemm(*c["port"], method=method, device="cpu",
                                      dtype=dt, integrity=integrity)
                for dt in (torch.float32, torch.float64)
                for integrity in ("off", "detect")]
        for got in runs:
            _same_csr(got, sim)


def test_standard_live_pair_arrays():
    """The live-slot exchange reads exactly the live slots of the literal
    send table, and each expansion position lands on the same value."""
    c = _case((72, 40, 56), "strided", seed=2)
    comp = sg.compile_spgemm(*c["port"], method="standard", cache=False, device="cpu")
    comp.ensure_live_pair()
    p, vpad, lb = comp.topo.n_procs, comp.vpads["pair"], comp.b_nnz_pad
    k = comp.pair_value_counts()
    assert comp.live_pad == max(1, int(k.sum(0).max()))
    assert comp.arrays["pair_live_src"].size == k.sum()
    b = np.random.default_rng(1).standard_normal((p, lb))
    literal = np.concatenate([b, np.stack([
        np.concatenate([b[s][comp.arrays["send_v"][s, r]] for s in range(p)])
        for r in range(p)])], axis=1)
    recv = np.zeros(p * comp.live_pad)
    recv[comp.arrays["pair_live_dst"]] = b.reshape(-1)[comp.arrays["pair_live_src"]]
    live = np.concatenate([b, recv.reshape(p, -1)], axis=1)
    ranks = np.arange(p)[:, None]
    np.testing.assert_array_equal(live[ranks, comp.arrays["exp_pos_live"]],
                                  literal[ranks, comp.arrays["exp_pos"]])


def test_run_counter_counts_device_runs_only():
    c = _case((40, 36, 30), "contiguous", seed=4)
    before = sg.torch_spgemm_runs()
    sg.distributed_spgemm(*c["port"], backend="simulate")
    assert sg.torch_spgemm_runs() == before
    sg.distributed_spgemm(*c["port"], device="cpu")
    comp = sg.compile_spgemm(*c["port"], device="cpu")
    run = sg.spgemm_program(comp)
    out = run(sg.pack_b_values(c["port"][1], comp, np.float32))
    assert out.shape == (2, 3, comp.c_nnz_pad) and out.dtype == torch.float32
    assert sg.torch_spgemm_runs() == before + 2


# ----------------------------- against the reference's shard_map program -----

_FAULT_SHAPE = (40, 36, 30)
_REF_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.core.integrity import (IntegrityError, MessageFault,
                                      build_fault_spec, message_phases)
    from repro.core.partition import contiguous_partition, strided_partition
    from repro.core.topology import Topology
    from repro.spgemm import (compile_spgemm, distributed_spgemm, pack_b_values,
                              spgemm_shardmap)
    from repro.spgemm.shardmap import _default_mesh
    from repro.sparse import CSR
    d = np.load(sys.argv[1])
    topo = Topology(2, 2)
    out, mism = {}, {}
    for key in d["case_names"]:
        key = str(key)
        a, b = CSR.from_dense(d[key + "_a"]), CSR.from_dense(d[key + "_b"])
        mk = contiguous_partition if "contiguous" in key else strided_partition
        rp, mp = mk(a.shape[0], 4), mk(a.shape[1], 4)
        for method in ("nap", "standard"):
            c = distributed_spgemm(a, b, rp, mp, topo, method=method,
                                   backend="shardmap")
            out["%s_%s" % (key, method)] = c.to_dense()
    a, b = CSR.from_dense(d["fault_a"]), CSR.from_dense(d["fault_b"])
    rp, mp = contiguous_partition(a.shape[0], 4), contiguous_partition(a.shape[1], 4)
    for method in ("nap", "standard"):
        comp = compile_spgemm(a, b, rp, mp, topo, method=method, cache=False)
        run = spgemm_shardmap(comp, _default_mesh(topo), integrity=True)
        spec = build_fault_spec(topo, [], method)
        c, chk = run(pack_b_values(b, comp, np.float32), spec)
        out["chk_" + method] = np.asarray(chk)
    for i, row in enumerate(d["faults"]):
        method = ("nap", "standard")[row[0]]
        f = MessageFault(phase=str(d["phase_names"][row[1]]),
                         kind=str(d["kind_names"][row[2]]), node=int(row[3]),
                         proc=int(row[4]), slot=int(row[5]), element=int(row[6]),
                         bit=int(row[7]))
        try:
            distributed_spgemm(a, b, rp, mp, topo, method=method,
                               backend="shardmap", integrity="detect", faults=[f])
            mism[str(i)] = []
        except IntegrityError as e:
            mism[str(i)] = [[m.check, m.phase, m.scope, m.node, m.proc, m.slot,
                             m.direction] for m in e.mismatches]
    np.savez(sys.argv[2], **out)
    open(sys.argv[3], "w").write(json.dumps(mism))
""")
_PHASES = ("full", "init", "inter", "final", "pair")


def _fault_rows(a, b, rp, mp, topo):
    """Per method, phase and kind, one fault on a live message: the first
    sender with a nonempty message of that phase, on its slot."""
    rows = []
    for mi, method in enumerate(("nap", "standard")):
        comm = sg.build_spgemm_plan(a, b, rp, mp, topo, method=method).comm
        sends = {"pair": comm.sends} if method == "standard" else {
            "full": comm.local_full_sends, "init": comm.local_init_sends,
            "inter": comm.inter_sends, "final": comm.local_final_sends}
        for phase, per_rank in sends.items():
            s, m = next((s, m) for s, msgs in enumerate(per_rank) for m in msgs
                        if m.size)
            slot = {"pair": m.dst, "inter": topo.node_of(m.dst)}.get(
                phase, topo.local_of(m.dst))
            for ki in range(len(FAULT_KINDS)):
                rows.append((mi, _PHASES.index(phase), ki, s // topo.ppn,
                             s % topo.ppn, slot, ki, 20))
    return np.array(rows, dtype=np.int64)


@pytest.fixture(scope="module")
def shardmap_run(tmp_path_factory):
    """The reference's float32 shard_map SpGEMM on a forced 4-device host
    platform (one subprocess): products over the shapes and partitions,
    the clean instrumented checksums, and the mismatches of every
    scripted fault."""
    tmp = tmp_path_factory.mktemp("spgemm")
    rng = np.random.default_rng(17)
    inputs, names = {}, []
    for shape in SHAPES:
        for kind in ("contiguous", "strided"):
            key = f"{kind}_{'x'.join(map(str, shape))}"
            names.append(key)
            inputs[key + "_a"] = _dense(rng, shape[0], shape[1])
            inputs[key + "_b"] = _dense(rng, shape[1], shape[2])
    m, k, n = _FAULT_SHAPE
    frng = np.random.default_rng(1)     # every nap phase carries a message
    inputs["fault_a"], inputs["fault_b"] = _dense(frng, m, k, 0.1), _dense(frng, k, n)
    topo = Topology(2, 2)
    a, b = CSR.from_dense(inputs["fault_a"]), CSR.from_dense(inputs["fault_b"])
    rp = port_part.contiguous_partition(m, 4)
    mp = port_part.contiguous_partition(k, 4)
    inputs.update(case_names=np.array(names), phase_names=np.array(_PHASES),
                  kind_names=np.array(FAULT_KINDS),
                  faults=_fault_rows(a, b, rp, mp, topo))
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REF_PROG, str(tmp / "in.npz"), str(tmp / "out.npz"),
         str(tmp / "mism.json")], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return (inputs, dict(np.load(tmp / "out.npz")),
            json.loads((tmp / "mism.json").read_text()))


@pytest.mark.parametrize("method", ["nap", "standard"])
def test_products_match_reference_shardmap(shardmap_run, method):
    inputs, out, _ = shardmap_run
    topo = Topology(2, 2)
    for key in inputs["case_names"]:
        key = str(key)
        a, b = CSR.from_dense(inputs[key + "_a"]), CSR.from_dense(inputs[key + "_b"])
        mk = port_part.contiguous_partition if "contiguous" in key \
            else port_part.strided_partition
        got = sg.distributed_spgemm(a, b, mk(a.shape[0], 4), mk(a.shape[1], 4),
                                    topo, method=method, device="cpu")
        np.testing.assert_allclose(got.to_dense(), out[f"{key}_{method}"], **F32)
        np.testing.assert_allclose(got.to_dense(),
                                   inputs[key + "_a"] @ inputs[key + "_b"], **F32)


def _fault_setup(inputs):
    topo = Topology(2, 2)
    a, b = CSR.from_dense(inputs["fault_a"]), CSR.from_dense(inputs["fault_b"])
    return (a, b, port_part.contiguous_partition(a.shape[0], 4),
            port_part.contiguous_partition(a.shape[1], 4), topo)


@pytest.mark.parametrize("method", ["nap", "standard"])
def test_instrumented_checksums_match_reference(shardmap_run, method):
    """Forward payloads are gathered values, so the clean instrumented
    program's checksum words equal the reference's bit for bit."""
    inputs, out, _ = shardmap_run
    a, b, rp, mp, topo = _fault_setup(inputs)
    comp = sg.compile_spgemm(a, b, rp, mp, topo, method=method, device="cpu",
                             cache=False)
    spec = build_fault_spec(topo, [], method)
    _, chk = sg.spgemm_program(comp, integrity=True)(
        sg.pack_b_values(b, comp, np.float32), spec)
    assert chk.dtype == torch.int64
    np.testing.assert_array_equal(chk.numpy(), out["chk_" + method].astype(np.int64))


@pytest.mark.parametrize("method", ["nap", "standard"])
def test_scripted_faults_match_reference(shardmap_run, method):
    """Every fault kind on a live message of every phase: the port raises
    with the reference's attributed mismatches; ``"recover"`` returns the
    clean product bit for bit and counts one retry."""
    inputs, _, mism = shardmap_run
    a, b, rp, mp, topo = _fault_setup(inputs)
    clean = sg.distributed_spgemm(a, b, rp, mp, topo, method=method, device="cpu",
                                  integrity="detect")
    _same_csr(clean, sg.distributed_spgemm(a, b, rp, mp, topo, method=method,
                                           device="cpu"))
    n_detected = 0
    for i, row in enumerate(inputs["faults"]):
        if ("nap", "standard")[row[0]] != method:
            continue
        f = MessageFault(phase=_PHASES[row[1]], kind=FAULT_KINDS[row[2]],
                         node=int(row[3]), proc=int(row[4]), slot=int(row[5]),
                         element=int(row[6]), bit=int(row[7]))
        want = mism[str(i)]
        report = {}
        try:
            sg.distributed_spgemm(a, b, rp, mp, topo, method=method, device="cpu",
                                  integrity="detect", faults=[f], report=report)
            got = []
        except IntegrityError as e:
            got = [[m.check, m.phase, m.scope, m.node, m.proc, m.slot, m.direction]
                   for m in e.mismatches]
        assert got == want, (f, got, want)
        assert report["wire_mismatches"] == len(want)
        n_detected += bool(want)
        report = {}
        rec = sg.distributed_spgemm(a, b, rp, mp, topo, method=method, device="cpu",
                                    integrity="recover", faults=[f], report=report)
        _same_csr(rec, clean)
        assert report["retries"] == report["recovered"] == int(bool(want))
    phases = 4 if method == "nap" else 1
    assert n_detected == phases * len(FAULT_KINDS)


# ----------------------------- validation ------------------------------------

def test_validation_errors():
    c = _case((32, 24, 16), "contiguous", seed=1, nn=2, ppn=2)
    a, b, rp, mp, topo = c["port"]
    with pytest.raises(ValueError, match="chain"):
        sg.build_spgemm_plan(a, a, rp, rp, topo)
    with pytest.raises(ValueError, match="mismatch"):
        sg.build_spgemm_plan(a, b, port_part.contiguous_partition(16, 4), mp, topo)
    with pytest.raises(ValueError, match="method"):
        sg.build_spgemm_plan(a, b, rp, mp, topo, method="x")
    with pytest.raises(ValueError, match="integrity must be"):
        sg.distributed_spgemm(a, b, rp, mp, topo, device="cpu", integrity="on")
    with pytest.raises(ValueError, match="need"):
        sg.distributed_spgemm(a, b, rp, mp, topo, device="cpu",
                              faults=[MessageFault(phase="inter")])
    with pytest.raises(ValueError, match="torch backend only"):
        sg.distributed_spgemm(a, b, rp, mp, topo, backend="simulate",
                              integrity="detect")
    with pytest.raises(ValueError, match="backend must be"):
        sg.distributed_spgemm(a, b, rp, mp, topo, backend="shardmap")
    with pytest.raises(ValueError, match="forward-only"):
        sg.distributed_spgemm(a, b, rp, mp, topo, device="cpu", integrity="detect",
                              faults=[MessageFault(phase="inter",
                                                   direction="transpose")])
    with pytest.raises(ValueError, match="compute-side"):
        sg.distributed_spgemm(a, b, rp, mp, topo, device="cpu", integrity="detect",
                              faults=[MessageFault(phase="compute")])
    with pytest.raises(ValueError, match="does not exist"):
        sg.distributed_spgemm(a, b, rp, mp, topo, device="cpu", integrity="detect",
                              faults=[MessageFault(phase="pair")])
    for dtype in (torch.float16, np.float64, "float64"):
        with pytest.raises(ValueError, match="float32 or torch.float64"):
            sg.distributed_spgemm(a, b, rp, mp, topo, device="cpu", dtype=dtype)


def test_device_backend_raises_without_cuda(monkeypatch):
    c = _case((32, 24, 16), "contiguous", seed=1, nn=2, ppn=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sg.distributed_spgemm(*c["port"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sg.compile_spgemm(*c["port"])
    _same_csr(sg.distributed_spgemm(*c["port"], backend="simulate"),
              csr_matmul(*c["port"][:2]))


# ----------------------------- RAP, materialize, level operators -------------

def test_galerkin_rap_and_distributed_hierarchy():
    """The distributed RAP (simulate backend) assembles every coarse
    level bit for bit equal to the host hierarchy; on the device backend
    (CPU) the structure is equal and the values within float32."""
    topo = Topology(n_nodes=2, ppn=2)
    a = rotated_anisotropic_2d(12, eps=0.1)
    host = smoothed_aggregation_hierarchy(a, theta=0.1, coarse_size=16)
    dist = smoothed_aggregation_hierarchy(
        a, theta=0.1, coarse_size=16,
        rap=sg.distributed_rap(topo, backend="simulate", cross_check=True))
    assert len(dist) == len(host) >= 2
    for lh, ld in zip(host, dist):
        _same_csr(lh.a, ld.a)
    runs = sg.torch_spgemm_runs()
    dev = smoothed_aggregation_hierarchy(
        a, theta=0.1, coarse_size=16,
        rap=sg.distributed_rap(topo, backend="torch", device="cpu",
                               dtype=torch.float64, cross_check=True))
    assert sg.torch_spgemm_runs() - runs == 2 * (len(host) - 1)
    for lh, ld in zip(host, dev):
        assert np.array_equal(lh.a.indices, ld.a.indices)
        np.testing.assert_allclose(ld.a.data, lh.a.data, **F64)
    lvl = host[0]
    fine = port_part.contiguous_partition(lvl.a.shape[0], topo.n_procs)
    coarse = port_part.contiguous_partition(lvl.p.shape[1], topo.n_procs)
    a_c = sg.galerkin_rap(lvl.r, lvl.a, lvl.p, fine, coarse, topo,
                          backend="simulate", cross_check=True)
    assert np.array_equal(a_c.data, host[1].a.data)
    with pytest.raises(ValueError, match="fine"):
        sg.galerkin_rap(lvl.r, lvl.a, lvl.p, coarse, coarse, topo)
    with pytest.raises(AssertionError, match="bit-for-bit"):
        bad = CSR(a_c.indptr, a_c.indices, a_c.data * (1 + 1e-15), a_c.shape)
        sg.assert_matches_host(bad, host[1].a, "simulate", "RAP")
    sg.assert_matches_host(
        CSR(a_c.indptr, a_c.indices, a_c.data * (1 + 1e-5), a_c.shape),
        host[1].a, "torch", "RAP")


def test_materialize_simulate_and_level_operators():
    """``ComposedOperator.materialize`` and ``level_operators(materialize=
    True)`` on the simulate backend: the concrete coarse operator equals
    the host Galerkin product bit for bit and the V-cycle is unchanged."""
    topo = Topology(n_nodes=2, ppn=2)
    rng = np.random.default_rng(3)
    m, nc = 48, 20
    a = CSR.from_dense(_dense(rng, m, m, 0.2))
    p = CSR.from_dense(_dense(rng, m, nc, 0.3))
    fine = port_part.contiguous_partition(m, topo.n_procs)
    coarse = port_part.contiguous_partition(nc, topo.n_procs)
    a_op = port_api.operator(a, topo, fine, backend="simulate")
    p_op = port_api.operator(p, topo, row_part=fine, col_part=coarse,
                             backend="simulate")
    gal = p_op.T @ a_op @ p_op
    conc = gal.materialize(cross_check=True)
    assert isinstance(conc, port_api.NapOperator) and conc.shape == (nc, nc)
    assert conc.row_part is coarse and conc.col_part is coarse
    host = csr_matmul(p.transpose(), csr_matmul(a, p))
    assert np.array_equal(conc.a.data, host.data)
    x = rng.standard_normal(nc)
    np.testing.assert_allclose(conc @ x, gal @ x, rtol=1e-12, atol=1e-12)

    a2 = rotated_anisotropic_2d(12, eps=0.1)
    levels = smoothed_aggregation_hierarchy(a2, theta=0.1, coarse_size=16)
    ops = level_operators(levels, topo, backend="simulate", materialize=True)
    gal2 = ops[0].galerkin(materialize=True)
    assert isinstance(gal2, port_api.NapOperator)
    assert np.array_equal(gal2.a.data, levels[1].a.data)
    b = rng.standard_normal(a2.shape[0])
    np.testing.assert_allclose(
        amg_vcycle(levels, b, operators=ops),
        amg_vcycle(levels, b, operators=None), rtol=1e-9, atol=1e-11)


def test_materialize_and_level_operators_on_the_device_backend():
    """The device SpGEMM (CPU tensors) behind ``materialize`` and
    ``level_operators(materialize=True, spgemm_backend="torch")``: every
    Galerkin product runs through the device program, the coarse
    operators keep the leftmost factor's spec and device, and the
    V-cycle matches the host one."""
    topo = Topology(n_nodes=2, ppn=2)
    a = rotated_anisotropic_2d(16, eps=0.1)
    a = CSR.from_dense(a.to_dense() + np.eye(a.shape[0]) * 1e-3)
    levels = smoothed_aggregation_hierarchy(a, theta=0.1, coarse_size=16)
    runs = sg.torch_spgemm_runs()
    ops = level_operators(levels, topo, device="cpu", local_compute="ell",
                          materialize=True, spgemm_backend="torch",
                          spgemm_dtype=torch.float64)
    assert sg.torch_spgemm_runs() - runs == 2 * (len(levels) - 1)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])
    np.testing.assert_allclose(amg_vcycle(levels, b, operators=ops),
                               amg_vcycle(levels, b, operators=None),
                               rtol=5e-3, atol=5e-4)
    runs = sg.torch_spgemm_runs()
    conc = ops[0].galerkin(materialize=True, cross_check=True)
    assert sg.torch_spgemm_runs() - runs == 2
    assert conc.spec.device == "cpu" and conc.spec.local_compute == "ell"
    assert conc.spec.backend == "torch" and conc.method == ops[0].a.method
    x = rng.standard_normal(conc.shape[1])
    want = levels[1].a.matvec(x)
    np.testing.assert_allclose(conc @ x, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(ops[0].galerkin() @ x, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    conc64 = ops[0].galerkin(materialize=True, spgemm_method="standard",
                             dtype=torch.float64)
    np.testing.assert_allclose(conc64.a.data, levels[1].a.data, **F64)
    # the SpGEMM has no multistep plan: a multistep leftmost factor
    # multiplies through nap and keeps its method on the concrete operator
    r_op = port_api.operator(levels[0].r, topo, row_part=ops[0].p.col_part,
                             col_part=ops[0].p.row_part, method="multistep",
                             device="cpu")
    conc_ms = (r_op @ ops[0].a @ ops[0].p).materialize()
    assert conc_ms.method == "multistep"
    np.testing.assert_allclose(conc_ms.a.data, levels[1].a.data, rtol=5e-5,
                               atol=5e-6 * np.abs(levels[1].a.data).max())


def test_public_names_mirror_the_reference():
    """The package exports the reference's names, with the device program
    and its run counter named for the torch backend."""
    renamed = {"spgemm_shardmap": "spgemm_program",
               "shardmap_spgemm_runs": "torch_spgemm_runs"}
    assert sorted(sg.__all__) == sorted(renamed.get(n, n) for n in ref_sg.__all__)
    assert all(hasattr(sg, n) for n in sg.__all__)
