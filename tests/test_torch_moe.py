"""The port's MoE dispatch (``repro_torch.moe``) against the JAX package's
(``repro.moe``) on the CPU.

* codecs: the numpy copy word for word against the reference's
  ``encode_np`` over the whole sweep, the torch codecs against the numpy
  copy, the error budgets equal;
* plans: routing matrices, plan messages, modeled traffic and the
  flat-vs-nap verdicts equal (the same postal constants passed to both);
* executors: every ``("moe", mode)`` x wire dtype bit-equal to the
  reference's float64 executors both ways, with equal ``stats()`` and
  ``autotune_report()``, integrity over quantized words, and the cases of
  ``tests/test_moe_dispatch.py`` (empty experts, dropped tokens);
* the island: the reference's ``moe_apply_sharded`` on a forced 8-device
  host mesh (2, 4), run once in a subprocess, against the port's island
  on the same seeded inputs and converted weights, at capacity factors
  8.0 (nothing drops), 1.0 and 0.25 (copies drop), for every mode and
  wire; the inter-pod bytes the communicator counts against the buffer
  arithmetic; shared experts; and two gloo processes (this file
  re-entered as ``child``) bit-equal to one.
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

ROOT = Path(__file__).resolve().parents[1]
MODES = ("flat", "nap", "auto")
WIRES = ("f32", "bf16", "fp8_e4m3")
QUANT = ("bf16", "fp8_e4m3")
SWEEP = ("bf16_values", "bf16_midpoints", "fp8_values", "fp8_midpoints",
         "fp8_subnormals", "specials", "out_of_range", "random_f32",
         "random_f64")
CAPACITY_FACTORS = (8.0, 1.0, 0.25)
ISLAND_MESH = (2, 4)                 # (pods, chips per pod) of the island
X_SHAPE = (4, 16, 32)
N_PROC = 2
# the 2-process island: (pods, chips per pod) -> pods per process 1 and 2
PROC_LAYOUTS = ((2, 4), (4, 2))

# executor tier: the layout of tests/test_moe_dispatch.py
T, E, K, NV = 128, 8, 4, 8
TOPO = (2, 4)


def island_cfg(pkg="port", **kw):
    """``tests/multidev/moe_dispatch_prog.py``'s cfg0 of either package."""
    if pkg == "port":
        from repro_torch.configs import get_reduced
    else:
        from repro.configs import get_reduced
    return get_reduced("qwen3-moe-235b-a22b").replace(**dict(
        dict(n_experts=8, top_k=4, moe_dff=32, d_model=32, capacity_factor=8.0),
        **kw))


def island_x():
    return (np.random.default_rng(0).standard_normal(X_SHAPE) * 0.3).astype(np.float32)


def _port_params(tree):
    from repro_torch.models.convert import moe_params_from_jax
    return moe_params_from_jax(tree)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep():
    from repro_torch.moe.wire import codec_sweep
    return codec_sweep()


@pytest.mark.parametrize("section", SWEEP)
@pytest.mark.parametrize("wd", QUANT)
def test_encode_np_words_match_reference(sweep, wd, section):
    import warnings

    from repro.moe import wire as ref
    from repro_torch.moe import wire as port
    x = sweep[section]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # ml_dtypes warns on overflow
        want = ref.encode_np(x, wd)
        want_q = ref.quantize_np(x, wd)
    got = port.encode_np(x, wd)
    assert got.dtype == {"bf16": np.uint16, "fp8_e4m3": np.uint8}[wd]
    np.testing.assert_array_equal(got, want.view(got.dtype))
    got_q = port.quantize_np(x, wd)
    assert got_q.dtype == want_q.dtype
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(port.decode_np(got, wd),
                                  ref.decode_np(want, wd))


@pytest.mark.parametrize("section", SWEEP)
@pytest.mark.parametrize("wd", QUANT)
def test_encode_torch_matches_numpy(sweep, wd, section):
    """The torch codec (here on the CPU) gives the numpy copy's word for
    every non-NaN input, and a NaN word for a NaN input."""
    from repro_torch.moe import wire
    x = sweep[section]
    words = wire.encode_np(x, wd)
    with np.errstate(over="ignore"):
        t = wire.encode_torch(torch.from_numpy(x.astype(np.float32)), wd)
    assert t.dtype == wire.torch_wire_dtype(wd)
    got = t.view(torch.uint8 if wd == "fp8_e4m3" else torch.int16).numpy() \
        .view(words.dtype)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], words[~nan])
    assert np.isnan(wire.decode_np(got[nan], wd)).all()
    back = wire.decode_torch(t, wd).numpy()
    np.testing.assert_array_equal(back[~nan], wire.decode_np(words, wd, np.float32)[~nan])


def test_encode_torch_bf16_input_to_fp8(sweep):
    """The dispatch encodes bf16 tokens to fp8 directly: the same words as
    the numpy copy of their float32 values."""
    from repro_torch.moe import wire
    x = sweep["bf16_values"]
    t = wire.encode_torch(torch.from_numpy(x).to(torch.bfloat16), "fp8_e4m3")
    got = t.view(torch.uint8).numpy()
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], wire.encode_np(x, "fp8_e4m3")[~nan])


def test_f32_codecs_are_identity():
    from repro_torch.moe import wire
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    assert wire.encode_np(x, "f32") is x and wire.quantize_np(x, "f32") is x
    t = torch.from_numpy(x)
    assert wire.encode_torch(t, "f32") is t and wire.decode_torch(t, "f32") is t
    assert wire.torch_wire_dtype("f32") is None


def test_wire_constants_match_reference():
    from repro.moe import wire as ref
    from repro_torch.moe import wire as port
    assert port.WIRE_DTYPES == ref.WIRE_DTYPES and port.FP8_MAX == ref.FP8_MAX
    for wd in ref.WIRE_DTYPES:
        assert port.wire_bytes(wd) == ref.wire_bytes(wd)
        assert port.wire_eps(wd) == ref.wire_eps(wd)
        for hops in (1, 2, 3):
            assert port.wire_error_bound(wire_dtype=wd, hops=hops) == \
                ref.wire_error_bound(wire_dtype=wd, hops=hops)
    for mode in MODES:
        for wd in WIRES:
            assert port.wire_error_bound(island_cfg(moe_dispatch=mode, wire_dtype=wd)) \
                == ref.wire_error_bound(island_cfg("ref", moe_dispatch=mode,
                                                   wire_dtype=wd))
    with pytest.raises(ValueError, match="f32|bf16|fp8_e4m3"):
        port.check_wire_dtype("int4")


@pytest.mark.parametrize("hops", (1, 2))
@pytest.mark.parametrize("wd", QUANT)
def test_dispatch_error_budget_matches_reference(routing, data, wd, hops):
    from repro.moe.wire import dispatch_error_budget as ref_budget
    from repro_torch.moe.wire import dispatch_error_budget
    x, _ = data
    for cols in (x[:, 0], x):
        np.testing.assert_array_equal(
            dispatch_error_budget(routing["port"], cols, wd, hops),
            ref_budget(routing["ref"], cols, wd, hops))


@pytest.mark.parametrize("wd", QUANT)
def test_corrupt_wire_matches_reference(wd):
    from repro.moe import wire as ref
    from repro_torch.moe import wire as port
    x = np.random.default_rng(3).standard_normal(40) * 4
    words = port.encode_np(x, wd)
    prev = port.encode_np(x[::-1].copy(), wd)
    for kind in ("bitflip", "zero", "stale", "duplicate"):
        for element, bit in ((0, 0), (7, 5), (39, 15)):
            got = port.corrupt_wire_np(words, kind, element, bit, other=prev)
            want = ref.corrupt_wire_np(ref.encode_np(x, wd), kind, element, bit,
                                       other=ref.encode_np(x[::-1].copy(), wd))
            np.testing.assert_array_equal(got, want.view(got.dtype))


# ---------------------------------------------------------------------------
# plan layer
# ---------------------------------------------------------------------------

def _both_routing(ids, w):
    from repro.moe.plan import routing_matrix as ref_rm
    from repro_torch.moe.plan import routing_matrix
    return {"ref": ref_rm(ids, w, E), "port": routing_matrix(ids, w, E)}


@pytest.fixture(scope="module")
def routing():
    from repro.moe.plan import representative_routing as ref_rr
    from repro_torch.moe.plan import representative_routing
    ids, w = representative_routing(T, E, K, seed=3)
    rids, rw = ref_rr(T, E, K, seed=3)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(w, rw)
    return dict(_both_routing(ids, w), ids=ids, w=w)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    return rng.standard_normal((T, NV)) * 0.5, rng.standard_normal((E, NV))


def _topos():
    from repro.core.topology import Topology as RefTopology
    from repro_torch.core.topology import Topology
    return RefTopology(*TOPO), Topology(*TOPO)


def _parts(n_tokens=T, n_experts=E):
    from repro.moe.plan import dispatch_partitions as ref_dp
    from repro_torch.moe.plan import dispatch_partitions
    t_ref, t_port = _topos()
    return ref_dp(n_experts, n_tokens, t_ref), dispatch_partitions(n_experts, n_tokens, t_port)


def _same_csr(a, b):
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_routing_matrix_matches_reference(routing):
    _same_csr(routing["port"], routing["ref"])
    ids = np.array([[0, -1], [1, 2]], np.int32)
    w = np.array([[1.0, 0.25], [0.5, 0.5]])
    both = _both_routing(ids, w)
    _same_csr(both["port"], both["ref"])
    from repro_torch.moe.plan import routing_matrix
    with pytest.raises(ValueError):
        routing_matrix(np.array([[0, E]], np.int32), np.array([[0.5, 0.5]]), E)


def test_dispatch_partitions_match_reference():
    (er, tr), (ep, tp) = _parts()
    np.testing.assert_array_equal(ep.owner, er.owner)
    np.testing.assert_array_equal(tp.owner, tr.owner)
    from repro_torch.moe.plan import dispatch_partitions
    with pytest.raises(ValueError):
        dispatch_partitions(E + 1, T, _topos()[1])


def _plans(routing):
    from repro.moe.plan import build_dispatch_plans as ref_bdp
    from repro_torch.moe.plan import build_dispatch_plans
    t_ref, t_port = _topos()
    (er, tr), (ep, tp) = _parts()
    return (ref_bdp(routing["ref"], er, tr, t_ref),
            build_dispatch_plans(routing["port"], ep, tp, t_port))


def _same_messages(ref_lists, port_lists):
    assert len(ref_lists) == len(port_lists)
    for rm, pm in zip(ref_lists, port_lists):
        assert [(m.src, m.dst) for m in rm] == [(m.src, m.dst) for m in pm]
        for x, y in zip(rm, pm):
            np.testing.assert_array_equal(x.idx, y.idx)


def test_dispatch_plans_match_reference(routing):
    ref, port = _plans(routing)
    _same_messages(ref["flat"].sends, port["flat"].sends)
    _same_messages(ref["flat"].recvs, port["flat"].recvs)
    for field in ("inter_sends", "inter_recvs", "local_init_sends",
                  "local_init_recvs", "local_final_sends", "local_final_recvs",
                  "local_full_sends", "local_full_recvs"):
        _same_messages(getattr(ref["nap"], field), getattr(port["nap"], field))


@pytest.mark.parametrize("integrity", ("off", "detect"))
@pytest.mark.parametrize("wd", WIRES)
def test_dispatch_traffic_matches_reference(routing, wd, integrity):
    from repro.moe.plan import dispatch_traffic as ref_dt
    from repro_torch.moe.plan import dispatch_traffic
    ref, port = _plans(routing)
    for mode in ("flat", "nap"):
        for direction in ("forward", "transpose"):
            for nv in (1, NV):
                assert dispatch_traffic(port[mode], wd, nv, direction, integrity) == \
                    ref_dt(ref[mode], wd, nv, direction, integrity)
    t32 = dispatch_traffic(port["nap"], "f32", NV)
    t8 = dispatch_traffic(port["nap"], "fp8_e4m3", NV)
    assert t8["injected_inter_bytes"] * 4 == t32["injected_inter_bytes"]


@pytest.mark.parametrize("wd", WIRES)
def test_choose_dispatch_matches_reference(routing, wd):
    """The same postal constants (the reference's default) to both."""
    from repro.core.cost_model import TPU_V5E_POSTAL
    from repro.moe.plan import choose_dispatch as ref_cd
    from repro_torch.core.cost_model import PostalParams
    from repro_torch.moe.plan import choose_dispatch
    t_ref, t_port = _topos()
    (er, tr), (ep, tp) = _parts()
    params = PostalParams(**dataclasses.asdict(TPU_V5E_POSTAL))
    for nv in (1, NV, 32):
        want = ref_cd(routing["ref"], er, tr, t_ref, wire_dtype=wd, nv=nv)
        got = choose_dispatch(routing["port"], ep, tp, t_port, wire_dtype=wd,
                              nv=nv, params=params)
        for k in ("dispatch", "combine"):
            assert got[k] == want[k]
        assert {m: _plain(d) for m, d in got["stats"].items()} == \
            {m: _plain(d) for m, d in want["stats"].items()}


def test_choose_dispatch_prefers_fewer_inter_bytes(routing):
    from repro_torch.moe.plan import choose_dispatch
    (_, _), (ep, tp) = _parts()
    verdict = choose_dispatch(routing["port"], ep, tp, _topos()[1], nv=NV)
    for d in ("dispatch", "combine"):
        v = verdict[d]
        chosen = v["candidates"][v["chosen"]]["injected_inter_bytes"]
        assert all(chosen <= s["injected_inter_bytes"]
                   for s in v["candidates"].values())
        assert v["postal_params"] == "blue_waters_postal"


# ---------------------------------------------------------------------------
# executors (backend="moe"): bit-equal to the reference's
# ---------------------------------------------------------------------------

def _ops(r_ref, r_port, **kw):
    import repro.api as ref_api
    import repro_torch.api as port_api
    t_ref, t_port = _topos()
    (er, tr), (ep, tp) = _parts(r_port.shape[1])
    return (ref_api.operator(r_ref, topo=t_ref, row_part=er, col_part=tr,
                             backend="moe", **kw),
            port_api.operator(r_port, t_port, row_part=ep, col_part=tp,
                              backend="moe", **kw))


def _plain(stats):
    """Stats with their dataclass values as tuples (each package has its
    own ``PhaseStats`` class)."""
    return {k: dataclasses.astuple(v) if dataclasses.is_dataclass(v) else v
            for k, v in stats.items()}


def _comparable(rep):
    """A report without its prose note (each package names its own
    backends) and the auto verdicts' postal fields (the port's chooser
    defaults to the Blue Waters constants, the reference's to TPU v5e)."""
    rep = json.loads(json.dumps(rep))
    rep.pop("note", None)
    for d in rep.get("moe_dispatch", {}).values():
        d.pop("postal_params")
        for c in d["candidates"].values():
            c.pop("postal_time_s")
    return rep


@pytest.mark.parametrize("wd", WIRES)
@pytest.mark.parametrize("method", MODES)
def test_executor_bit_equal_to_reference(routing, data, method, wd):
    x, y = data
    ref, port = _ops(routing["ref"], routing["port"], method=method, wire_dtype=wd)
    for v in (x, x[:, 0]):
        got = port @ v
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, ref @ v)
    for u in (y, y[:, 1]):
        np.testing.assert_array_equal(port.T @ u, ref.T @ u)
    assert _plain(port.stats()) == _plain(ref.stats())
    assert _comparable(port.autotune_report()) == _comparable(ref.autotune_report())
    assert port.method == method


def test_f32_moe_matches_plain_simulators(routing, data):
    import repro_torch.api as port_api
    x, y = data
    (_, _), (ep, tp) = _parts()
    sim = {m: port_api.operator(routing["port"], _topos()[1], row_part=ep,
                                col_part=tp, backend="simulate", method=m)
           for m in ("standard", "nap")}
    for method, plain in (("flat", "standard"), ("nap", "nap")):
        op = _ops(routing["ref"], routing["port"], method=method)[1]
        np.testing.assert_array_equal(op @ x, sim[plain] @ x)
        np.testing.assert_array_equal(op.T @ y, sim[plain].T @ y)


@pytest.mark.parametrize("wd", QUANT)
def test_quantized_within_budget(routing, data, wd):
    from repro_torch.moe.wire import dispatch_error_budget
    x, _ = data
    budget = dispatch_error_budget(routing["port"], x, wd, hops=1)
    for method in ("flat", "nap"):
        exact = _ops(routing["ref"], routing["port"], method=method)[1] @ x
        out = _ops(routing["ref"], routing["port"], method=method,
                   wire_dtype=wd)[1] @ x
        assert np.all(np.abs(out - exact) <= budget)
        assert not np.array_equal(out, exact)


def test_wire_none_matches_forced_f32_wire(routing, data):
    x, _ = data
    plain = _ops(routing["ref"], routing["port"], method="nap")[1] @ x
    forced = _ops(routing["ref"], routing["port"], method="nap",
                  integrity="detect")[1] @ x
    np.testing.assert_array_equal(plain, forced)


def test_byte_accounting_tracks_wire_dtype(routing):
    from repro_torch.moe.wire import wire_bytes
    stats = {wd: _ops(routing["ref"], routing["port"], method="nap",
                      wire_dtype=wd)[1].stats() for wd in WIRES}
    for wd in WIRES:
        assert stats[wd]["bytes_per_val"] == wire_bytes(wd)
    assert stats["fp8_e4m3"]["dispatch_injected_inter_bytes"] * 4 == \
        stats["f32"]["dispatch_injected_inter_bytes"]


FAULT = dict(node=1, proc=0, slot=0, element=2, bit=6)


@pytest.mark.parametrize("method", MODES)
@pytest.mark.parametrize("wd", WIRES)
def test_detect_attributes_quantized_fault(routing, data, wd, method):
    import repro.api as ref_api
    import repro_torch.api as port_api
    x, _ = data
    ref, port = _ops(routing["ref"], routing["port"], method=method,
                     wire_dtype=wd, integrity="detect")
    np.testing.assert_array_equal(port @ x, ref @ x)      # clean apply
    # the inter-pod message of rank 4 (pod 1) to pod 0, or to rank 0 (flat)
    phase = {"nap": "inter", "flat": "pair"}[
        port.autotune_report()["dispatch_resolved"]]
    errs = []
    for op, err in ((ref, ref_api.IntegrityError), (port, port_api.IntegrityError)):
        op.inject_fault(phase, kind="bitflip", **FAULT)
        with pytest.raises(err) as ei:
            op @ x
        errs.append([dataclasses.astuple(m) for m in ei.value.mismatches])
    assert errs[1] == errs[0] and errs[1][0][1] == phase
    rep = port.integrity_report()
    assert rep["faults_injected"] == 1 and rep["wire_mismatches"] == 1
    assert rep["by_scope"]["off_node"] == 1
    assert rep == ref.integrity_report()


@pytest.mark.parametrize("wd", QUANT)
def test_recover_bit_identical_quantized(routing, data, wd):
    x, _ = data
    ref, port = _ops(routing["ref"], routing["port"], method="nap",
                     wire_dtype=wd, integrity="recover")
    base = port @ x
    port.inject_fault("inter", kind="bitflip", **FAULT)
    np.testing.assert_array_equal(port @ x, base)
    rep = port.integrity_report()
    assert rep["faults_injected"] == 1 and rep["retries"] == 1 \
        and rep["recovered"] == 1
    ref @ x
    ref.inject_fault("inter", kind="bitflip", **FAULT)
    np.testing.assert_array_equal(ref @ x, base)


@pytest.mark.parametrize("method", MODES)
def test_empty_expert_rows(data, method):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 2, size=(T, 2)).astype(np.int32)
    ids[:, 1] = 1 - ids[:, 0]
    w = np.full((T, 2), 0.5)
    both = _both_routing(ids, w)
    x, y = data
    ref, port = _ops(both["ref"], both["port"], method=method, wire_dtype="bf16")
    out = port @ x
    np.testing.assert_array_equal(out, ref @ x)
    assert not out[2:].any()
    np.testing.assert_array_equal(port.T @ y, ref.T @ y)


@pytest.mark.parametrize("method", MODES)
def test_dropped_tokens(data, method):
    from repro_torch.moe.plan import representative_routing
    ids, w = representative_routing(T, E, K, seed=3)
    ids[::7] = -1
    both = _both_routing(ids, w)
    x, y = data
    ref, port = _ops(both["ref"], both["port"], method=method)
    np.testing.assert_array_equal(port @ x, ref @ x)
    back = port.T @ y
    np.testing.assert_array_equal(back, ref.T @ y)
    assert not back[::7].any()


def test_operator_checks(routing):
    import repro_torch.api as port_api
    (_, _), (ep, tp) = _parts()
    with pytest.raises(ValueError, match="moe"):
        port_api.operator(routing["port"], _topos()[1], row_part=ep, col_part=tp,
                          backend="simulate", method="standard", wire_dtype="bf16")
    with pytest.raises(ValueError, match="f32|bf16|fp8_e4m3"):
        port_api.operator(routing["port"], _topos()[1], row_part=ep, col_part=tp,
                          backend="moe", method="nap", wire_dtype="int4")
    op = port_api.operator(routing["port"], _topos()[1], row_part=ep, col_part=tp,
                           backend="moe", method="nap", pairing="balanced")
    assert (op @ np.ones(T)).dtype == np.float64
    assert op(np.ones(T), precision="float64").dtype == np.float64


@pytest.mark.parametrize("wd", WIRES)
def test_dispatch_operator_matches_reference(routing, data, wd):
    from repro.moe.dispatch import dispatch_operator as ref_do
    from repro_torch.moe.dispatch import dispatch_operator
    x, y = data
    t_ref, t_port = _topos()
    for mode in MODES:
        routed = (routing["ids"], routing["w"])
        ref = ref_do(island_cfg("ref", moe_dispatch=mode, wire_dtype=wd),
                     topo=t_ref, routing=routed)
        port = dispatch_operator(island_cfg(moe_dispatch=mode, wire_dtype=wd),
                                 topo=t_port, routing=routed)
        np.testing.assert_array_equal(port @ x, ref @ x)
        np.testing.assert_array_equal(port.T @ y, ref.T @ y)
    a = dispatch_operator(island_cfg(moe_dispatch="auto"), t_port, n_tokens=64, seed=2)
    b = ref_do(island_cfg("ref", moe_dispatch="auto"), topo=t_ref, n_tokens=64, seed=2)
    np.testing.assert_array_equal(a @ x[:64], b @ x[:64])
    with pytest.raises(ValueError, match="routing"):
        dispatch_operator(island_cfg(), topo=t_port)


# ---------------------------------------------------------------------------
# the island against the reference's shard_map island
# ---------------------------------------------------------------------------

_REFERENCE_ISLAND = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path.insert(0, sys.argv[2])
    import test_torch_moe as t
    from repro.compat import make_mesh, set_mesh
    from repro.moe.dispatch import _router
    from repro.models.moe import (EPInfo, moe_apply_local, moe_apply_sharded,
                                  moe_init)
    mesh = make_mesh(t.ISLAND_MESH, ("pod", "model"))
    ep = EPInfo(inner_axis="model", pod_axis="pod")
    out = {}
    x = jnp.asarray(t.island_x())
    for shared in (0, 1):
        cfg0 = t.island_cfg("ref", n_shared_experts=shared)
        params = moe_init(jax.random.key(0), cfg0, jnp.float32)
        for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"params{shared}/" + "/".join(p.key for p in k)] = np.asarray(v)
        out[f"local{shared}"] = np.asarray(moe_apply_local(params, cfg0, x))
        w, ids = _router(params, cfg0, x.reshape(-1, cfg0.d_model))
        out[f"ids{shared}"], out[f"w{shared}"] = np.asarray(ids), np.asarray(w)
        runs = ([(cf, m, wd) for cf in t.CAPACITY_FACTORS for m in t.MODES
                 for wd in t.WIRES] if not shared
                else [(8.0, m, "f32") for m in ("flat", "nap")])
        for cf, mode, wd in runs:
            cfg = cfg0.replace(capacity_factor=cf, moe_dispatch=mode, wire_dtype=wd)
            fn = jax.jit(lambda p, xx: moe_apply_sharded(p, cfg, xx, ep, mesh))
            with set_mesh(mesh):
                out[f"island{shared}/{cf}/{mode}/{wd}"] = np.asarray(fn(params, x))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_island(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_ISLAND, str(out),
                           str(ROOT / "tests")], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}

    def tree(shared):
        pre = f"params{shared}/"
        flat = {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}
        t = {}
        for k, v in flat.items():
            *path, leaf = k.split("/")
            node = t
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return t

    arrays["trees"] = {s: tree(s) for s in (0, 1)}
    return arrays


def _port_island(params, cfg, x, topo=ISLAND_MESH, stats=None):
    from repro_torch.core.topology import Topology
    from repro_torch.moe.dispatch import EPInfo, moe_apply_sharded
    return moe_apply_sharded(params, cfg, x, EPInfo("model", "pod"),
                             Topology(*topo), stats=stats)


def test_router_and_local_oracle_match_reference(reference_island):
    from repro_torch.models.moe import moe_apply_local
    from repro_torch.moe.dispatch import _router
    x = torch.from_numpy(island_x())
    for shared in (0, 1):
        cfg = island_cfg(n_shared_experts=shared)
        p = _port_params(reference_island["trees"][shared])
        w, ids = _router(p, cfg, x.reshape(-1, cfg.d_model))
        np.testing.assert_array_equal(ids.numpy(), reference_island[f"ids{shared}"])
        np.testing.assert_allclose(w.numpy(), reference_island[f"w{shared}"],
                                   rtol=1e-5, atol=1e-7)
        local = moe_apply_local(p, cfg, x)
        np.testing.assert_allclose(local.numpy(), reference_island[f"local{shared}"],
                                   rtol=1e-5, atol=1e-6)
        # chunking changes the matmuls' shapes, so only their rounding
        np.testing.assert_allclose(moe_apply_local(p, cfg, x, chunk=7).numpy(),
                                   local.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wd", WIRES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_island_matches_reference(reference_island, cf, mode, wd):
    from repro_torch.moe.wire import wire_error_bound
    cfg = island_cfg(capacity_factor=cf, moe_dispatch=mode, wire_dtype=wd)
    p = _port_params(reference_island["trees"][0])
    x = torch.from_numpy(island_x())
    stats = {}
    got = _port_island(p, cfg, x, stats=stats).numpy()
    want = reference_island[f"island0/{cf}/{mode}/{wd}"]
    local = reference_island["local0"]
    scale = np.abs(local).max()
    assert stats["mode"] == ("nap" if mode == "auto" else mode)
    if wd == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        err = np.abs(got - want).max() / scale
        assert err <= wire_error_bound(cfg), (err, wire_error_bound(cfg))
    # the same rows emptied by drops
    np.testing.assert_array_equal(~got.any(-1), ~want.any(-1))
    dropped = sum(stats["dropped"].values())
    if cf == 8.0:
        assert dropped == 0
        if wd == "f32":
            assert np.abs(got - local).max() / scale <= 1e-4
    if cf == 0.25:
        assert dropped > 0 and (~got.any(-1)).any()


def test_island_shared_experts_match_reference(reference_island):
    p = _port_params(reference_island["trees"][1])
    assert set(p["shared"]) == {"w_gate", "w_up", "w_down"}
    x = torch.from_numpy(island_x())
    for mode in ("flat", "nap"):
        cfg = island_cfg(n_shared_experts=1, moe_dispatch=mode)
        got = _port_island(p, cfg, x).numpy()
        np.testing.assert_allclose(got, reference_island[f"island1/8.0/{mode}/f32"],
                                   rtol=1e-5, atol=1e-6)
        local = reference_island["local1"]
        assert np.abs(got - local).max() / np.abs(local).max() <= 1e-4


def _island_arithmetic(cfg, topo, mode, wd, d, T_pod):
    """Inter-pod bytes of one island apply from the buffer shapes: per
    payload, the messages between chips of different pods."""
    from repro_torch.moe.wire import wire_bytes
    n_out, n_in = topo
    n_chips, Tc, K = n_out * n_in, T_pod // n_in, cfg.top_k
    tok_b = 4 if wd == "f32" else wire_bytes(wd)       # f32 tokens here
    comb_b = 4 if wd == "f32" else wire_bytes(wd)
    if mode == "flat":
        cap = max(1, int(Tc * K * cfg.capacity_factor / n_chips))
        msgs = n_chips * (n_chips - n_in) * cap
    else:
        cap = Tc
        msgs = n_chips * (n_out - 1) * cap
    return {"tokens": msgs * d * tok_b, "meta": msgs * 2 * K * 4,
            "combine": msgs * d * comb_b}


@pytest.mark.parametrize("wd", WIRES)
def test_counted_inter_pod_bytes(wd):
    """At the communicator: the counts equal the buffer arithmetic, nap <
    flat, and a narrower wire counts fewer."""
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    from repro_torch.models.moe import moe_init
    x = torch.from_numpy(island_x())
    p = moe_init(0, island_cfg(), torch.float32, device="cpu")
    counted = {}
    for mode in ("flat", "nap"):
        cfg = island_cfg(capacity_factor=1.0, moe_dispatch=mode, wire_dtype=wd)
        reset_inter_node_bytes()
        _port_island(p, cfg, x)
        got = inter_node_bytes()
        axis = "nodexproc" if mode == "flat" else "node"
        want = _island_arithmetic(cfg, ISLAND_MESH, mode, wd, X_SHAPE[2],
                                  X_SHAPE[0] // ISLAND_MESH[0] * X_SHAPE[1])
        assert {k: got[f"{axis}:{k}"] for k in want} == want
        assert got[axis] == sum(want.values())
        counted[mode] = want
    for k in ("tokens", "meta", "combine"):
        assert counted["nap"][k] < counted["flat"][k]


@pytest.mark.parametrize("mode", ("flat", "nap"))
def test_bf16_model_wires(mode):
    """A bf16 model: the f32 wire ships bf16 tokens (the model dtype), so
    its dispatch counts as many bytes as the bf16 wire and twice fp8's;
    the quantized wires' float32 sums (``out_dtype``, before the model's
    one cast) stay within two hops of ``wire_error_bound`` of the f32
    wire's: both modes round the payload and then the combine (the
    reference's one-hop budget for flat is exceeded here by fp8, 0.067 >
    0.0635; it held at full width on the card)."""
    from repro_torch.core.topology import Topology
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    from repro_torch.models.moe import moe_init
    from repro_torch.moe.dispatch import EPInfo, moe_apply_sharded
    from repro_torch.moe.wire import wire_error_bound
    x = torch.from_numpy(island_x()).to(torch.bfloat16)
    cfg0 = island_cfg(dtype="bfloat16", moe_dispatch=mode)
    p = moe_init(0, cfg0, torch.bfloat16, device="cpu")
    tokens, sums = {}, {}
    axis = "nodexproc" if mode == "flat" else "node"
    for wd in WIRES:
        cfg = cfg0.replace(wire_dtype=wd)
        reset_inter_node_bytes()
        sums[wd] = moe_apply_sharded(p, cfg, x, EPInfo("model", "pod"),
                                     Topology(*ISLAND_MESH), out_dtype=torch.float32)
        assert sums[wd].dtype == torch.float32
        tokens[wd] = inter_node_bytes()[f"{axis}:tokens"]
        if wd != "f32":
            err = (sums[wd] - sums["f32"]).abs().max() / sums["f32"].abs().max()
            assert 0 < err <= wire_error_bound(wire_dtype=wd, hops=2)
    assert tokens["f32"] == tokens["bf16"] == 2 * tokens["fp8_e4m3"]
    assert torch.equal(_port_island(p, cfg0, x), sums["f32"].to(torch.bfloat16))


def test_auto_resolution_matches_reference():
    from repro.moe.dispatch import resolve_dispatch_mode as ref_resolve
    from repro_torch.moe.dispatch import resolve_dispatch_mode
    for wd in WIRES:
        for geometry in ((2, 4, 32), (4, 2, 16), (2, 4, 8)):
            mode, rep = resolve_dispatch_mode(island_cfg(wire_dtype=wd), *geometry)
            ref_mode, ref_rep = ref_resolve(island_cfg("ref", wire_dtype=wd), *geometry)
            assert mode == ref_mode
            for k in ("dispatch", "combine"):
                for name, c in rep[k]["candidates"].items():
                    r = ref_rep[k]["candidates"][name]
                    assert c["injected_inter_bytes"] == r["injected_inter_bytes"]


def test_island_geometry_checks():
    from repro_torch.core.topology import Topology
    from repro_torch.models.moe import moe_init
    from repro_torch.moe.dispatch import EPInfo, moe_apply_sharded, topology_of_mesh
    p = moe_init(0, island_cfg(), torch.float32, device="cpu")
    x = torch.from_numpy(island_x())
    with pytest.raises(ValueError, match="mesh"):
        moe_apply_sharded(p, island_cfg(), x, EPInfo("model", "pod"))
    with pytest.raises(ValueError, match="batch"):
        _port_island(p, island_cfg(), x[:3])
    with pytest.raises(ValueError, match="divide"):
        _port_island(p, island_cfg(), x, topo=(3, 1))
    assert topology_of_mesh(Topology(2, 4), EPInfo("model")) == Topology(1, 4)
    # one pod: nap degenerates to flat
    st = {}
    one = moe_apply_sharded(p, island_cfg(moe_dispatch="nap"), x,
                            EPInfo("model"), Topology(1, 8), stats=st)
    assert st["mode"] == "flat" and one.shape == x.shape


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------

PROC_RUNS = [(lay, m, wd) for lay in PROC_LAYOUTS for m in ("flat", "nap")
             for wd in ("f32", "bf16", "fp8_e4m3")]


def _proc_inputs():
    from repro_torch.models.moe import moe_init
    cfg = island_cfg(capacity_factor=1.0, dtype="bfloat16")
    p = moe_init(0, cfg, torch.bfloat16, device="cpu")
    x = torch.from_numpy(island_x()).to(torch.bfloat16)
    return cfg, p, x


def child(out_dir):
    from repro_torch.core.topology import Topology
    from repro_torch.mesh import attach, detach, mesh_for
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    from repro_torch.moe.dispatch import EPInfo, moe_apply_sharded
    info = attach(verbose=True)
    pid, world = info["process_id"], info["num_processes"]
    cfg, p, x = _proc_inputs()
    shard = x.shape[0] // world
    results, meta = {}, {}
    for lay, mode, wd in PROC_RUNS:
        mesh = mesh_for(Topology(*lay))
        before = dict(mesh.stats)
        reset_inter_node_bytes()
        got = moe_apply_sharded(p, cfg.replace(moe_dispatch=mode, wire_dtype=wd),
                                x[pid * shard:(pid + 1) * shard],
                                EPInfo("model", "pod"), mesh)
        key = f"{lay[0]}x{lay[1]}/{mode}/{wd}"
        results[key] = got.float().numpy()
        meta[key] = {"counted": inter_node_bytes(),
                     "stats": {k: mesh.stats[k] - before.get(k, 0)
                               for k in mesh.stats}}
    np.savez(Path(out_dir) / f"moe_{pid}.npz", **results)
    (Path(out_dir) / f"moe_{pid}.json").write_text(json.dumps(meta))
    detach()
    print(f"CHILD {pid} OK", flush=True)


@pytest.fixture(scope="module")
def proc_run(tmp_path_factory):
    from repro_torch.mesh import launch
    out = tmp_path_factory.mktemp("moe_mesh")
    res = launch(__file__, N_PROC, args=["child", str(out)], local_devices=1,
                 env={"JAX_PLATFORMS": "cpu", "REPRO_MESH_BACKEND": "gloo"},
                 timeout_s=600)
    runs = []
    for pid in range(N_PROC):
        assert f"CHILD {pid} OK" in res.output(pid), res.output(pid)
        with np.load(out / f"moe_{pid}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        runs.append((arrays, json.loads((out / f"moe_{pid}.json").read_text())))
    return runs


@pytest.mark.parametrize("run", PROC_RUNS, ids=["{0[0]}x{0[1]}-{1}-{2}".format(*r)
                                                for r in PROC_RUNS])
def test_two_processes_bit_equal_to_one(proc_run, run):
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    lay, mode, wd = run
    cfg, p, x = _proc_inputs()
    cfg = cfg.replace(moe_dispatch=mode, wire_dtype=wd)
    reset_inter_node_bytes()
    whole = _port_island(p, cfg, x, topo=lay).float().numpy()
    one = inter_node_bytes()
    key = f"{lay[0]}x{lay[1]}/{mode}/{wd}"
    got = np.concatenate([arrays[key] for arrays, _ in proc_run])
    np.testing.assert_array_equal(got, whole)
    # each process counts its own ranks' messages: together, the whole
    for k, v in one.items():
        assert sum(meta[key]["counted"].get(k, 0) for _, meta in proc_run) == v
    axis = "nodexproc" if mode == "flat" else "node"
    # the token payload each process sends the other, from the shapes
    n_out, n_in = lay
    c_loc, Tc, k = n_out * n_in // N_PROC, X_SHAPE[0] // n_out * X_SHAPE[1] // n_in, cfg.top_k
    if mode == "flat":
        msgs = c_loc * c_loc * max(1, int(Tc * k * cfg.capacity_factor / (n_out * n_in)))
    else:
        msgs = c_loc * (n_out // N_PROC) * Tc
    width = 2 if wd in ("f32", "bf16") else 1          # bf16 tokens here
    for _, meta in proc_run:
        st = meta[key]["stats"]
        assert st[f"sent_bytes_{axis}:tokens"] == msgs * X_SHAPE[2] * width
        assert st[f"sent_bytes_{axis}"] > st[f"sent_bytes_{axis}:tokens"]
        assert st[f"inter_node_bytes_{axis}"] == meta[key]["counted"][axis]


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "child":
        child(sys.argv[2])
    else:
        sys.exit("usage: test_torch_moe.py child OUT_DIR (under launch())")
