"""Wire integrity of the port against the JAX package: checksums, the
fault transform, fault specs, verifiers, the simulate wire and the
instrumented device programs.

Exact (bit for bit) wherever the reference is exact:
- the device checksum twin against ``checksum_np`` over float32 and
  float64 payloads, odd lengths, NaN, +-inf and -0.0;
- the fault transform against the reference's jnp ``_apply_fault`` for
  every kind and every slot / element / bit edge case;
- ``build_fault_spec``, the verifiers, ``IntegrityState`` and ``SimWire``;
- the forward checksums of the instrumented nap, standard and multistep
  programs against the reference's instrumented shard_map program on a
  forced 4-device host platform, Topology(2, 2) (forward payloads are
  gathered values).
Transpose payloads are partial sums whose f32 bits depend on the
summation order, so there the port's checksums are held against
``checksum_np`` of the port's own message buffers.  Results agree at
the reference's bar (rtol 1e-4, atol 1e-5); the ABFT rows at rtol 1e-4
and atol 1e-5 times their |A| |x| mass.  Every scripted fault must give
the reference's attributed ``Mismatch`` list, on both of the port's
backends.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.comm as ref_comm
import repro.core.integrity as ref_int
import repro.core.partition as ref_part
import repro.core.spmv_jax as ref_spmv
from repro.core.topology import Topology as RefTopology
from repro.sparse.csr import CSR as RefCSR

import repro_torch.api as port_api
import repro_torch.comm as port_comm
import repro_torch.core.integrity as port_int
import repro_torch.core.partition as port_part
import repro_torch.core.spmv_torch as port_spmv
from repro_torch.core.topology import Topology
from repro_torch.sparse import random_fixed_nnz
from repro_torch.sparse.csr import CSR

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
KINDS = port_int.FAULT_KINDS
METHODS = ("nap", "standard", "multistep")


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32 if x.dtype.itemsize == 4 else np.uint64)


# ------------------------- checksum twins ------------------------------------

def _special_payloads(rng, dtype, shape):
    buf = rng.standard_normal(shape).astype(dtype)
    flat = buf.reshape(-1)
    for i, val in enumerate((np.nan, np.inf, -np.inf, -0.0, 0.0)):
        if i < flat.size:
            flat[(3 * i) % flat.size] = val
    return buf


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(3, 8), (1, 1), (4, 5), (2, 7, 3), (5, 1), (3, 13)])
def test_msg_checksums_match_checksum_np(dtype, shape):
    """One checksum per leading index, bit-equal to both packages'
    ``checksum_np`` of that message."""
    buf = _special_payloads(np.random.default_rng(sum(shape)), dtype, shape)
    got = port_spmv._msg_checksums(torch.from_numpy(buf), 1)
    want = [ref_int.checksum_np(row) for row in buf]
    assert got.dtype == torch.int64 and got.tolist() == want
    assert [port_int.checksum_np(row) for row in buf] == want


def test_msg_checksums_no_overflow_and_chunks(monkeypatch):
    """Words with every bit pattern (NaNs included) at the largest message
    of the main path (2025 slots x nv 8 = 16,200 words), folded in many
    chunks and in one."""
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2 ** 32, size=(5, 2025, 8), dtype=np.uint64)
    words[0] = 0xFFFFFFFF
    buf = words.astype(np.uint32).view(np.float32)
    want = [ref_int.checksum_np(m) for m in buf]
    assert port_spmv._msg_checksums(torch.from_numpy(buf)).tolist() == want
    monkeypatch.setattr(port_spmv, "_FOLD_CHUNK_WORDS", 3 * 16200)
    lead = torch.from_numpy(buf).reshape(5, 1, 2025, 8)
    assert port_spmv._msg_checksums(lead, 2)[:, 0].tolist() == want


@pytest.mark.parametrize("nv", [1, 3])
def test_pair_checksums_column_major(nv, monkeypatch):
    """The standard exchange's column-major table: message (s, r) read in
    its row-major [pad, nv] order."""
    rng = np.random.default_rng(nv)
    x = _special_payloads(rng, np.float32, (nv, 4, 3, 5))
    monkeypatch.setattr(port_spmv, "_FOLD_CHUNK_WORDS", nv * 3 * 5)  # a sender a chunk
    got = port_spmv._pair_checksums(torch.from_numpy(x))
    want = [[ref_int.checksum_np(np.ascontiguousarray(x[:, s, r, :].T))
             for r in range(3)] for s in range(4)]
    assert got.tolist() == want


# ------------------------- fault transform ----------------------------------

# (slot, element, bit) per rank: in range, wrapped, negative, the sign bit,
# bits outside [0, 31] (clipped)
EDGES = [(0, 0, 0), (3, 9, 31), (5, 47, 20), (-1, -2, 40), (2, 1000, -3), (1, 7, 30)]


@pytest.mark.parametrize("kind", range(len(KINDS) + 1))
def test_apply_fault_matches_reference(kind):
    import jax.numpy as jnp
    rng = np.random.default_rng(kind)
    buf = rng.standard_normal((len(EDGES), 4, 6, 2)).astype(np.float32)
    buf[0, 1] = 0.0
    buf[1, 2, 0, 0] = -0.0
    spec = np.array([(kind,) + e for e in EDGES], np.int32)
    got = port_spmv._apply_fault(torch.from_numpy(buf.copy()),
                                 torch.from_numpy(spec).long()).numpy()
    for r in range(len(EDGES)):
        want = np.asarray(ref_spmv._apply_fault(jnp.asarray(buf[r]),
                                                jnp.asarray(spec[r])))
        np.testing.assert_array_equal(_bits(got[r]), _bits(want), err_msg=str(r))
    if kind == 0:
        np.testing.assert_array_equal(_bits(got), _bits(buf))


@pytest.mark.parametrize("kind", range(1, len(KINDS) + 1))
def test_fault_pair_matches_row_major(kind):
    """The standard exchange's fault on its column-major send table equals
    the transform of the same messages laid out row-major."""
    rng = np.random.default_rng(10 + kind)
    nv, p, pad = 3, 4, 5
    x = rng.standard_normal((nv, p, p, pad)).astype(np.float32)
    spec = torch.tensor([(kind, s, e, b) for s, e, b in
                         ((1, 4, 3), (3, 14, 31), (-1, 0, 0), (0, 22, 17))])
    got = port_spmv._fault_pair(torch.from_numpy(x.copy()), spec).numpy()
    row_major = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 2, 3, 0)))
    want = port_spmv._apply_fault(row_major, spec).numpy().transpose(3, 0, 1, 2)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_corrupt_payload_np_matches_reference():
    rng = np.random.default_rng(2)
    for dtype in (np.float32, np.float64):
        v = rng.standard_normal(9).astype(dtype)
        other = rng.standard_normal(5).astype(dtype)
        for kind in KINDS:
            for kw in (dict(), dict(element=4, bit=12), dict(other=other)):
                np.testing.assert_array_equal(
                    _bits(port_int.corrupt_payload_np(v, kind, **kw)),
                    _bits(ref_int.corrupt_payload_np(v, kind, **kw)))
    with pytest.raises(ValueError):
        port_int.corrupt_payload_np(v, "gamma-ray")


# ------------------------- fault spec, verifiers, state ---------------------

def _faults(mod):
    return [mod.MessageFault(phase="inter", node=1, proc=0, slot=0, element=3, bit=20),
            mod.MessageFault(phase="full", kind="stale", node=0, proc=1, slot=1),
            mod.MessageFault(phase="compute", node=1, proc=1, element=5, bit=28),
            mod.MessageFault(phase="direct", kind="duplicate", node=0, proc=0, slot=3)]


def test_build_fault_spec_matches_reference():
    topo_r, topo_p = RefTopology(2, 2), Topology(2, 2)
    for method in METHODS:
        fr = [f for f in _faults(ref_int)
              if f.phase in ref_int.phase_index(method)]
        fp = [f for f in _faults(port_int)
              if f.phase in port_int.phase_index(method)]
        want = ref_int.build_fault_spec(topo_r, fr, method)
        got = port_int.build_fault_spec(topo_p, fp, method)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert port_int.phase_index(method) == ref_int.phase_index(method)
    bad = [([port_int.MessageFault(phase="pair")], "nap"),
           ([port_int.MessageFault(phase="full", node=5)], "nap"),
           ([port_int.MessageFault(phase="full", slot=0),
             port_int.MessageFault(phase="full", slot=1)], "nap"),
           ([port_int.MessageFault(phase="direct")], "standard")]
    for faults, method in bad:
        with pytest.raises(ValueError) as e_port:
            port_int.build_fault_spec(topo_p, faults, method)
        ref_faults = [ref_int.MessageFault(**dataclasses.asdict(f)) for f in faults]
        with pytest.raises(ValueError) as e_ref:
            ref_int.build_fault_spec(topo_r, ref_faults, method)
        assert str(e_port.value) == str(e_ref.value)
    for kw in (dict(phase="warp"), dict(phase="full", kind="gamma-ray"),
               dict(phase="compute", kind="zero"),
               dict(phase="full", direction="sideways")):
        with pytest.raises(ValueError):
            port_int.MessageFault(**kw)


def _planted(rng):
    chk = rng.integers(0, 2 ** 32, size=(2, 3, 4, 1, 5), dtype=np.uint64)
    chk = np.concatenate([chk, chk], axis=3).astype(np.int64)
    chk[0, 1, 2, 1, 3] ^= 1 << 7       # receiver disagrees: one wire fault
    chk[1, 2, 0, 0, 0] += 1
    abft = rng.standard_normal((2, 3, 3, 2)).astype(np.float32)
    abft[..., 1, :] = abft[..., 0, :]
    abft[..., 2, :] = np.abs(abft[..., 0, :]) * 10
    abft[1, 0, 1, 1] += 5.0            # an ABFT fault
    abft[0, 2, 0, 0] = np.nan          # NaN fails
    return chk, abft


def test_verifiers_and_state_match_reference():
    chk, abft = _planted(np.random.default_rng(4))
    phases = ("full", "init", "inter", "final")
    for direction in ("forward", "transpose"):
        assert port_int.verify_wire(chk, phases, 3, direction) == \
            [port_int.Mismatch(**dataclasses.asdict(m))
             for m in ref_int.verify_wire(chk.astype(np.uint32), phases, 3, direction)]
        got = port_int.verify_abft(abft, 1000, direction)
        assert [dataclasses.asdict(m) for m in got] == \
            [dataclasses.asdict(m) for m in ref_int.verify_abft(abft, 1000, direction)]
        assert len(got) == 2
    np.testing.assert_array_equal(
        port_int.abft_tolerance(abft[..., 2, :], abft[..., 0, :], abft[..., 1, :], 500),
        ref_int.abft_tolerance(abft[..., 2, :], abft[..., 0, :], abft[..., 1, :], 500))
    for mode in ("detect", "recover"):
        st_r = ref_int.IntegrityState(mode, RefTopology(2, 3), "nap", 2)
        st_p = port_int.IntegrityState(mode, Topology(2, 3), "nap", 2)
        for st, mod in ((st_r, ref_int), (st_p, port_int)):
            st.queue_fault(mod.MessageFault(phase="inter", direction="any"))
            st.queue_fault(mod.MessageFault(phase="full", direction="transpose"))
            st.arm("forward")
            st.verify(chk, abft, "forward", 1000)
            st.arm("transpose")
            st.verify(chk, abft, "transpose", 1000)
            st.disarm()
        assert st_p.report() == st_r.report()
        assert st_p.quarantine_candidates() == st_r.quarantine_candidates() != []
    with pytest.raises(ValueError):
        port_int.IntegrityState("off", Topology(2, 2), "nap")


def test_simwire_matches_reference():
    """The simulate wire over the same scripted faults: checks, injected
    count and mismatches equal."""
    rng = np.random.default_rng(9)
    dense = (rng.random((40, 40)) < 0.2) * rng.standard_normal((40, 40))
    a_r, a_p = RefCSR.from_dense(dense), CSR.from_dense(dense)
    v = rng.standard_normal(40)
    import repro.core.spmv as ref_sim
    import repro_torch.core.spmv as port_sim
    for fault in (dict(phase="inter", node=1, proc=0, slot=0),
                  dict(phase="final", kind="stale", node=1, proc=1, slot=0),
                  dict(phase="full", kind="duplicate", node=0, proc=0, slot=1)):
        d_r = ref_sim.DistSpMV.build(a_r, ref_part.contiguous_partition(40, 4),
                                     RefTopology(2, 2), pairing="aligned")
        d_p = port_sim.DistSpMV.build(a_p, port_part.contiguous_partition(40, 4),
                                      Topology(2, 2), pairing="aligned")
        w_r = ref_int.SimWire(RefTopology(2, 2), [ref_int.MessageFault(**fault)])
        w_p = port_int.SimWire(Topology(2, 2), [port_int.MessageFault(**fault)])
        np.testing.assert_array_equal(
            port_sim.simulate_nap_spmv(a_p, v, d_p.nap, wire=w_p),
            ref_sim.simulate_nap_spmv(a_r, v, d_r.nap, wire=w_r))
        assert (w_p.checks, w_p.injected) == (w_r.checks, w_r.injected)
        assert [dataclasses.asdict(m) for m in w_p.mismatches] == \
            [dataclasses.asdict(m) for m in w_r.mismatches]


# ------------------------- the reference's scenarios, both backends ---------

def band_spd(n, diag=4.0, bands=(1, 7)):
    m = np.eye(n) * diag
    for d in bands:
        idx = np.arange(n - d)
        m[idx, idx + d] = m[idx + d, idx] = -1.0
    return CSR.from_dense(m)


def _op(a, topo, integrity, backend, method="nap", **kw):
    dev = dict(device="cpu") if backend == "torch" else {}
    return port_api.operator(a, topo, part=port_part.contiguous_partition(
        a.shape[0], topo.n_procs), method=method, backend=backend,
        integrity=integrity, **dev, **kw)


@pytest.mark.parametrize("backend", ["simulate", "torch"])
def test_detect_attribution_and_recover(backend):
    """tests/test_integrity.py's scenario on the port: scripted faults on
    real edges raise with phase + scope attribution, recover reruns clean
    bit for bit, strikes accumulate against the implicated node."""
    topo = Topology(2, 2)
    a = band_spd(64)
    v = np.random.default_rng(3).standard_normal(64)
    y0 = _op(a, topo, "off", backend) @ v
    op = _op(a, topo, "detect", backend)
    assert np.array_equal(op @ v, y0)
    rep = op.integrity_report()
    assert rep["wire_mismatches"] == 0 and rep["wire_checks"] > 0, rep
    edges = [("full", 0, 0, 1, "on_node"), ("init", 0, 1, 0, "off_node"),
             ("inter", 1, 0, 0, "off_node"), ("final", 1, 1, 0, "off_node")]
    for phase, node, proc, slot, scope in edges:
        op.inject_fault(phase, "bitflip", node=node, proc=proc, slot=slot,
                        element=0, bit=20)
        with pytest.raises(port_api.IntegrityError) as ei:
            op @ v
        m = ei.value.mismatches[0]
        assert (m.phase, m.scope, m.direction) == (phase, scope, "forward")

    rec = _op(a, topo, "recover", backend)
    rec.inject_fault("inter", "bitflip", node=1, proc=0, slot=0, element=0, bit=20)
    assert np.array_equal(rec @ v, y0)
    rep = rec.integrity_report()
    assert rep["retries"] == 1 and rep["recovered"] == 1, rep
    assert rep["strikes"].get("node1") == 1, rep

    rec.T.inject_fault("inter", "bitflip", node=1, proc=0, slot=0)
    if backend == "simulate":
        with pytest.raises(NotImplementedError):
            rec.T @ v
    else:   # the device programs instrument the transpose too
        z0 = _op(a, topo, "off", backend).T @ v
        assert np.array_equal(rec.T @ v, z0)
        assert rec.integrity_report()["recovered"] == 2
    with pytest.raises(ValueError):
        _op(a, topo, "off", backend).queue_fault(port_api.MessageFault(phase="full"))
    with pytest.raises(ValueError):
        port_api.operator(a, topo, integrity="sometimes", backend=backend)


@pytest.mark.parametrize("backend", ["simulate", "torch"])
@pytest.mark.parametrize("seed", range(5))
def test_clean_apply_checksum_sweep(seed, backend):
    """Square / rectangular / strided layouts, both methods: a detect
    apply re-verifies every checksum with zero mismatches and is
    bit-identical to the uninstrumented apply (and, on simulate, to the
    reference's)."""
    rng = np.random.default_rng(seed)
    topo = Topology(2, 2)
    m = int(rng.integers(9, 70))
    n = m if seed % 2 == 0 else int(rng.integers(3, 70))
    a = random_fixed_nnz(m, int(rng.integers(2, 7)), seed=seed) if m == n else \
        CSR.from_dense((rng.random((m, n)) < 0.3) * rng.standard_normal((m, n)))
    kind = ["contiguous", "strided"][seed % 2]
    row_part = port_part.make_partition(kind, m, topo.n_procs, indptr=a.indptr,
                                        indices=a.indices, seed=seed)
    col_part = row_part if m == n else port_part.contiguous_partition(n, topo.n_procs)
    method = ["nap", "standard"][seed % 2]
    v = rng.standard_normal(n)
    u = rng.standard_normal(m)
    kw = dict(row_part=row_part, col_part=col_part, method=method, backend=backend)
    if backend == "torch":
        kw["device"] = "cpu"
    y0 = port_api.operator(a, topo, **kw) @ v
    op = port_api.operator(a, topo, integrity="detect", **kw)
    assert np.array_equal(op @ v, y0)
    assert np.array_equal(op.T @ u, port_api.operator(a, topo, **kw).T @ u)
    rep = op.integrity_report()
    assert rep["wire_mismatches"] == 0 and rep["abft_mismatches"] == 0, rep
    assert rep["wire_checks"] > 0
    if backend == "simulate":
        a_ref = RefCSR(indptr=a.indptr, indices=a.indices, data=a.data, shape=a.shape)
        rp = ref_part.make_partition(kind, m, 4, indptr=a.indptr, indices=a.indices,
                                     seed=seed)
        cp = rp if m == n else ref_part.contiguous_partition(n, 4)
        ref = ref_api.operator(a_ref, topo=RefTopology(2, 2), row_part=rp, col_part=cp,
                               method=method, backend="simulate", integrity="detect")
        assert np.array_equal(ref @ v, y0)
        ref.T @ u
        assert ref.integrity_report() == rep


# ------------------------- instrumented programs vs shard_map ---------------

_REF_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import repro.api as nap
    from repro.core.integrity import IntegrityError, MessageFault, FAULT_KINDS
    from repro.core.partition import contiguous_partition
    from repro.core.spmv_jax import pack_vector
    from repro.core.topology import Topology
    from repro.sparse import CSR
    d = np.load(sys.argv[1])
    a = CSR.from_dense(d["dense"])
    topo = Topology(2, 2)
    part = contiguous_partition(a.shape[0], 4)
    out, mism = {}, []
    ops = {}
    for method in ("nap", "standard", "multistep"):
        op = nap.operator(a, topo=topo, part=part, method=method,
                          backend="shardmap", local_compute="ell",
                          integrity="detect", threshold=int(d["threshold"]))
        ops[method] = op
        ex = op.executor
        for direction in ("forward", "transpose"):
            pad = ex.compiled.cols_pad if direction == "forward" else ex.compiled.rows_pad
            for nv in (1, 3):
                w, chk, abft = ex._run(direction)(
                    pack_vector(d["v%d" % nv], part, topo, pad))
                for k, x in (("w", w), ("chk", chk), ("abft", abft)):
                    out["%s_%s_%d_%s" % (method, direction, nv, k)] = np.asarray(x)
    for row in d["faults"]:
        method = ("nap", "standard", "multistep")[row[0]]
        direction = ("forward", "transpose")[row[1]]
        view = ops[method].T if direction == "transpose" else ops[method]
        phase = str(d["phase_names"][row[2]])
        kind = "bitflip" if row[3] == 0 else FAULT_KINDS[row[3] - 1]
        view.inject_fault(phase, kind, node=int(row[4]), proc=int(row[5]),
                          slot=int(row[6]), element=int(row[7]), bit=int(row[8]))
        try:
            view @ d["v1"]
            mism.append([])
        except IntegrityError as e:
            mism.append([[m.check, m.phase, m.scope, m.node, m.proc, m.slot,
                          m.direction] for m in e.mismatches])
    np.savez(sys.argv[2], **out)
    with open(sys.argv[3], "w") as f:
        json.dump(mism, f)
""")

PHASE_NAMES = ("full", "init", "inter", "final", "pair", "direct", "compute")


def _matrix():
    """A sparse matrix on (2, 2) whose every exchange phase carries live
    values in both directions (threshold 2 leaves the multi-step plan a
    direct share beside its node-aware phases)."""
    rng = np.random.default_rng(0)
    n = 48
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    np.fill_diagonal(dense, 4.0)
    return dense


def _port_op(dense, method, integrity="detect"):
    topo = Topology(2, 2)
    return port_api.operator(CSR.from_dense(dense), topo,
                             port_part.contiguous_partition(dense.shape[0], 4),
                             method=method, local_compute="ell", threshold=2,
                             integrity=integrity, device="cpu")


def _recorded_run(ex, direction, v, spec):
    """One instrumented run with every ``_Wire.exchange`` buffer recorded:
    ``{phase: (sent buffer, received buffer, (expect, actual))}``."""
    rec = {}
    orig = port_spmv._Wire.exchange

    def exchange(self, phase, buf, fn):
        sent = buf.clone()
        recv = orig(self, phase, buf, fn)
        rec[phase] = (sent, recv.clone(), self.chks[phase])
        return recv

    port_spmv._Wire.exchange = exchange
    try:
        out = ex.program(direction, fault_spec=spec)(ex.packed(direction, v))
    finally:
        port_spmv._Wire.exchange = orig
    return out, rec


def _detectable(kind, payload, nxt):
    """Whether the fault changes the payload's bits (the checksum sees
    exactly that): zero / drop need a nonzero payload, stale a
    non-constant one, duplicate a different next slot."""
    w, n = _bits(payload), _bits(nxt)
    if kind in ("zero", "drop"):
        return bool(w.any())
    if kind == "stale":
        return not np.array_equal(np.roll(w, 1), w)
    if kind == "duplicate":
        return not np.array_equal(w, n)
    return True


def _pick_faults(dense, v1):
    """Per method, direction, message phase and kind, the first real edge
    (sender, slot) whose payload the fault changes, from the port's
    recorded clean buffers (the standard forward's send table from the
    plan's ``send_idx``); plus a compute bitflip per method and
    direction.  Rows: (method, direction, phase, kind code, node, proc,
    slot, element, bit)."""
    rows = []
    for mi, method in enumerate(METHODS):
        ex = _port_op(dense, method).executor
        phases = port_int.message_phases(method)
        spec = torch.zeros((2, 2, len(phases) + 1, 4), dtype=torch.int32)
        for di, direction in enumerate(("forward", "transpose")):
            if method == "standard" and direction == "forward":
                c = ex.compiled
                shards = ex.packed("forward", v1).reshape(4, -1).numpy()
                send = np.stack([shards[s][c.arrays["send_idx"][s]] for s in range(4)])
                bufs = {"pair": send}
            else:
                _, rec = _recorded_run(ex, direction, v1, spec)
                bufs = {ph: rec[ph][0].numpy().reshape(4, rec[ph][0].shape[1], -1)
                        for ph in phases}
            for phase in phases:
                buf = bufs[phase].reshape(4, bufs[phase].shape[1], -1)
                n_slots = buf.shape[1]
                for ki, kind in enumerate(KINDS):
                    hit = next(((s, k) for s in range(4) for k in range(n_slots)
                                if _detectable(kind, buf[s, k],
                                               buf[s, (k + 1) % n_slots])
                                and _bits(buf[s, k]).any()), None)
                    if hit is None and kind == "bitflip":
                        hit = (0, 0)    # a flip is seen even in padding
                    if hit is None:
                        # the documented undetectable classes: a stale roll of
                        # one-value messages, a duplicate where every slot
                        # carries the same copy, any fault but a flip on a
                        # phase whose buffers are all zero
                        assert kind in ("stale", "duplicate") or not _bits(buf).any(), \
                            (method, direction, phase, kind)
                        continue
                    s, k = hit
                    live = np.flatnonzero(_bits(buf[s, k]))
                    rows.append((mi, di, PHASE_NAMES.index(phase), ki + 1,
                                 s // 2, s % 2, k, int(live[0]) if live.size else 0, 20))
            rows.append((mi, di, PHASE_NAMES.index("compute"), 0, 1, 1, 0, 2, 25))
    return np.array(rows, dtype=np.int64)


@pytest.fixture(scope="module")
def shardmap_run(tmp_path_factory):
    """The reference's instrumented shard_map programs on a forced
    4-device host platform (one subprocess): clean outputs of every
    method, direction and nv, and the mismatches of every scripted
    fault."""
    tmp = tmp_path_factory.mktemp("integrity")
    dense = _matrix()
    rng = np.random.default_rng(1)
    inputs = dict(dense=dense, threshold=2, v1=rng.standard_normal(48),
                  v3=rng.standard_normal((48, 3)),
                  phase_names=np.array(PHASE_NAMES))
    inputs["faults"] = _pick_faults(dense, inputs["v1"])
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REF_PROG, str(tmp / "in.npz"), str(tmp / "out.npz"),
         str(tmp / "mism.json")], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inputs, dict(np.load(tmp / "out.npz")), json.loads((tmp / "mism.json").read_text())


@pytest.mark.parametrize("method", METHODS)
def test_instrumented_programs_match_shardmap(shardmap_run, method):
    """Clean instrumented runs at nv = 1 and 3: forward checksums
    bit-equal to the reference's, transpose checksums equal to
    ``checksum_np`` of the port's own message buffers, results and ABFT
    rows within tolerance, the results bit-equal to the bare program's."""
    inputs, ref, _ = shardmap_run
    ex = _port_op(inputs["dense"], method).executor
    bare = _port_op(inputs["dense"], method, "off").executor
    phases = port_int.message_phases(method)
    spec = torch.zeros((2, 2, len(phases) + 1, 4), dtype=torch.int32)
    if method == "multistep":
        assert ex.stats()["direct_effective"] > 0
    for direction in ("forward", "transpose"):
        for nv in (1, 3):
            v = inputs[f"v{nv}"]
            key = f"{method}_{direction}_{nv}"
            (w, chk, abft), rec = _recorded_run(ex, direction, v, spec)
            assert chk.dtype == torch.int64 and tuple(chk.shape) == ref[key + "_chk"].shape
            assert tuple(abft.shape) == ref[key + "_abft"].shape
            assert torch.equal(chk[..., 0, :], chk[..., 1, :])
            if direction == "forward":
                np.testing.assert_array_equal(chk.numpy(), ref[key + "_chk"])
            for phase, (sent, recv, (expect, actual)) in rec.items():
                flat = recv.numpy().reshape(4, recv.shape[1], -1)
                assert actual.tolist() == [[port_int.checksum_np(m) for m in r]
                                           for r in flat], phase
                flat = sent.numpy().reshape(4, sent.shape[1], -1)
                sums = sorted(port_int.checksum_np(m) for r in flat for m in r)
                assert sorted(expect.reshape(-1).tolist()) == sums, phase
            np.testing.assert_allclose(w.numpy(), ref[key + "_w"], **TOL)
            scale = np.abs(ref[key + "_abft"][..., 2:3, :])
            assert np.all(np.abs(abft.numpy() - ref[key + "_abft"])
                          <= TOL["rtol"] * np.abs(ref[key + "_abft"]) + TOL["atol"] * scale)
            shards = bare.packed(direction, v)
            assert torch.equal(w, bare.program(direction)(shards))


@pytest.mark.parametrize("method", METHODS)
def test_scripted_faults_match_shardmap(shardmap_run, method):
    """Every fault kind on a real edge of every message phase, both
    directions, and a compute bitflip: the port raises with the
    reference's attributed mismatches, identical lists."""
    inputs, _, ref_mism = shardmap_run
    mi = METHODS.index(method)
    op = _port_op(inputs["dense"], method)
    n = 0
    for row, want in zip(inputs["faults"], ref_mism):
        if row[0] != mi:
            continue
        direction = ("forward", "transpose")[row[1]]
        view = op.T if direction == "transpose" else op
        phase = PHASE_NAMES[row[2]]
        kind = "bitflip" if row[3] == 0 else KINDS[row[3] - 1]
        view.inject_fault(phase, kind, node=int(row[4]), proc=int(row[5]),
                          slot=int(row[6]), element=int(row[7]), bit=int(row[8]))
        with pytest.raises(port_api.IntegrityError) as ei:
            view @ inputs["v1"]
        got = [[m.check, m.phase, m.scope, m.node, m.proc, m.slot, m.direction]
               for m in ei.value.mismatches]
        assert want and got == want, (phase, kind, direction)
        m = ei.value.mismatches[0]
        if phase == "compute":
            assert (m.check, m.scope, m.node, m.proc) == ("abft", "on_proc", 1, 1)
        else:
            assert m.check == "wire" and m.phase == phase
        n += 1
    # every phase in both directions takes at least its bitflip
    flips = {(r[1], PHASE_NAMES[r[2]]) for r in inputs["faults"]
             if r[0] == mi and r[3] == 1}
    assert len(flips) == 2 * len(port_int.message_phases(method))
    assert n >= 2 * (len(port_int.message_phases(method)) * (len(KINDS) - 1) + 1)
    rep = op.integrity_report()
    assert rep["faults_injected"] == n and rep["pending_faults"] == 0


@pytest.mark.parametrize("method", METHODS)
def test_recover_bit_identical_with_strikes(method):
    """``"recover"``: one fault per apply, forward and transpose, returns
    the clean result bit for bit; retries, recoveries and strikes count
    as the reference's state does."""
    dense = _matrix()
    off = _port_op(dense, method, "off")
    rec = _port_op(dense, method, "recover")
    v = np.random.default_rng(5).standard_normal((48, 2))
    y0, z0 = off @ v, off.T @ v
    first = port_int.message_phases(method)[-1]
    for direction, phase in (("forward", first), ("transpose", first),
                             ("forward", "compute")):
        view = rec.T if direction == "transpose" else rec
        view.inject_fault(phase, "bitflip", node=1, proc=1, slot=0, element=1,
                          bit=25 if phase == "compute" else 20)
        got = view @ v
        assert np.array_equal(got, z0 if direction == "transpose" else y0)
    rep = rec.integrity_report()
    assert rep["retries"] == rep["recovered"] == rep["faults_injected"] == 3, rep
    assert sum(rep["strikes"].values()) >= 3 and rep["mode"] == "recover"


def test_bare_program_is_unchanged(monkeypatch):
    """Without a fault spec no instrumentation runs: no wire, no ABFT
    arrays, one ELL launch a direction, a tensor (not a triple) back."""
    # the compile cache shares one plan between integrity modes; start
    # from none, so the plans below are the bare operators' own
    port_spmv.clear_compile_cache()
    dense = _matrix()
    calls = []
    orig = port_spmv.ell_spmm_packed
    monkeypatch.setattr(port_spmv, "ell_spmm_packed",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(port_spmv, "_Wire", None)
    for method in METHODS:
        ex = _port_op(dense, method, "off").executor
        for direction in ("forward", "transpose"):
            out = ex.program(direction)(ex.packed(direction, np.ones(48)))
            assert isinstance(out, torch.Tensor)
        assert "abft_col" not in ex.compiled.arrays
    assert len(calls) == 6


# ------------------------- traffic and chooser terms ------------------------

@pytest.mark.parametrize("integrity", ["off", "detect"])
def test_integrity_traffic_terms_match_reference(integrity):
    dense = _matrix()
    a_r, a_p = RefCSR.from_dense(dense), CSR.from_dense(dense)
    rp_r, rp_p = ref_part.contiguous_partition(48, 4), port_part.contiguous_partition(48, 4)
    t_r, t_p = RefTopology(2, 2), Topology(2, 2)
    ref_c = {"nap": ref_spmv.compile_nap(a_r, rp_r, t_r, cache=False),
             "standard": ref_spmv.compile_standard(a_r, rp_r, t_r, cache=False),
             "multistep": ref_spmv.compile_multistep(a_r, rp_r, t_r, cache=False,
                                                     threshold=2)}
    for method in METHODS:
        port = _port_op(dense, method, integrity)
        want = ref_spmv.padded_traffic(ref_c[method], integrity=integrity)
        got = {k: v for k, v in port.stats().items() if not k.startswith("messages_")}
        assert got == want, method
    import repro.core.cost_model as ref_cost
    from repro_torch.core.cost_model import BLUE_WATERS_POSTAL
    params = ref_cost.PostalParams(**dataclasses.asdict(BLUE_WATERS_POSTAL))
    for nv in (1, 3):
        ref = ref_comm.choose_comm(a_r.indptr, a_r.indices, rp_r, t_r, pairing="aligned",
                                   threshold=2, nv=nv, integrity=integrity,
                                   params=params)
        got = port_comm.choose_comm(a_p.indptr, a_p.indices, rp_p, t_p, threshold=2,
                                    nv=nv, integrity=integrity)
        for direction in ("forward", "transpose"):
            assert ref[direction]["wire_dtype"] == "f32"
            assert ref[direction] == got[direction]
        for wd in ("bf16", "fp8_e4m3"):
            ref_w = ref_comm.choose_comm(a_r.indptr, a_r.indices, rp_r, t_r,
                                         threshold=2, nv=nv, integrity=integrity,
                                         params=params, plans=ref["plans"],
                                         wire_dtype=wd)
            got_w = port_comm.choose_comm(a_p.indptr, a_p.indices, rp_p, t_p,
                                          threshold=2, nv=nv, integrity=integrity,
                                          plans=got["plans"], wire_dtype=wd)
            for direction in ("forward", "transpose"):
                assert ref_w[direction]["wire_dtype"] == wd
                assert ref_w[direction] == got_w[direction], (direction, wd)
        for name, plan in got["plans"].items():
            want = ref_comm.planned_traffic(ref["plans"][name], nv=nv,
                                            integrity=integrity)
            assert want["wire_dtype"] == "f32"
            assert port_comm.planned_traffic(plan, nv=nv, integrity=integrity) == want
    auto = port_api.operator(a_p, t_p, rp_p, comm="auto", threshold=2,
                             integrity=integrity, device="cpu")
    assert auto.autotune_report()["comm"]["forward"]["chosen"] == \
        ref["forward"]["chosen"]
