"""The port's standard operator (Algorithm 1) on the CPU against the JAX
package.

``op @ v`` and ``op.T @ u`` through ``repro_torch.api.operator(...,
method="standard", device="cpu")`` for every local-compute format, held
against the float64 host matvec, the reference's float64 simulate
backend and the reference's shard_map program on a forced 4-device host
platform, all at the reference's own f32 bar, rtol 1e-4 / atol 1e-5.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core.partition as ref_partition
import repro.core.spmv_jax as ref_spmv
import repro.sparse as ref_sparse
from repro.core.cost_model import TPU_V5E_LOCAL
from repro.core.topology import Topology as RefTopology

import repro_torch.api as port_api
import repro_torch.core.partition as port_partition
import repro_torch.core.spmv_torch as port_spmv
import repro_torch.sparse as port_sparse
from repro_torch.core.cost_model import LocalComputeParams
from repro_torch.core.topology import Topology

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)

# (name, generator + args, topology, partition kind)
LAYOUTS = [
    ("aniso_2x2", ("rotated_anisotropic_2d", (10,)), (2, 2), "contiguous"),
    ("random_2x3_strided", ("random_fixed_nnz", (60, 6)), (2, 3), "strided"),
]


def _layout(spec):
    _, (gen, args), (nn, ppn), kind = spec
    a_ref = getattr(ref_sparse, gen)(*args)
    a_port = getattr(port_sparse, gen)(*args)
    n = a_ref.shape[0]
    mk = f"{kind}_partition"
    return (a_ref, a_port, getattr(ref_partition, mk)(n, nn * ppn),
            getattr(port_partition, mk)(n, nn * ppn), RefTopology(nn, ppn),
            Topology(nn, ppn))


def _dense_apply(a, v):
    cols = v.reshape(v.shape[0], -1)
    out = np.stack([a.matvec(cols[:, i]) for i in range(cols.shape[1])], axis=1)
    return out.reshape((a.shape[0],) + v.shape[1:])


def _standard(a, topo, part, **kw):
    return port_api.operator(a, topo, part, method="standard", device="cpu", **kw)


@pytest.mark.parametrize("nv", [1, 4])
@pytest.mark.parametrize("local_compute", ["auto", "ell", "bsr", "coo"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[s[0] for s in LAYOUTS])
def test_standard_operator_matches_oracles(layout, local_compute, nv):
    a_ref, a_port, p_ref, p_port, t_ref, t_port = _layout(layout)
    rng = np.random.default_rng(31 + nv)
    n = a_ref.shape[0]
    v = rng.standard_normal(n) if nv == 1 else rng.standard_normal((n, nv))
    u = rng.standard_normal(v.shape)
    op = _standard(a_port, t_port, p_port, local_compute=local_compute)
    sim = ref_api.operator(a_ref, topo=t_ref, part=p_ref, backend="simulate",
                           method="standard")
    w, z = op @ v, op.T @ u
    assert w.shape == v.shape and w.dtype == np.float32
    np.testing.assert_allclose(w, _dense_apply(a_port, v), **TOL)
    np.testing.assert_allclose(z, _dense_apply(a_port.transpose(), u), **TOL)
    np.testing.assert_allclose(w, sim @ v, **TOL)
    np.testing.assert_allclose(z, sim.T @ u, **TOL)
    want = op.autotune_report()["resolved"] if local_compute == "auto" \
        else local_compute
    assert op.local_compute == want
    assert op.T.local_compute in ("ell", "coo")


def test_standard_bsr_materialize_x_is_bit_equal():
    a_ref, a_port, p_ref, p_port, t_ref, t_port = _layout(LAYOUTS[0])
    v = np.random.default_rng(5).standard_normal((a_port.shape[0], 3))
    op = _standard(a_port, t_port, p_port, local_compute="bsr")
    np.testing.assert_array_equal(op @ v, op(v, materialize_x=True))


@pytest.mark.parametrize("local_compute", ["ell", "coo"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[s[0] for s in LAYOUTS])
def test_live_slot_scatter_equals_literal_adjoint(layout, local_compute):
    """The transpose's live-slot scatter drops only exact +0.0 terms."""
    a_ref, a_port, p_ref, p_port, t_ref, t_port = _layout(layout)
    op = _standard(a_port, t_port, p_port, local_compute=local_compute)
    ex = op.executor
    u = np.random.default_rng(9).standard_normal((a_port.shape[0], 2))
    shards = ex.packed("transpose", u)
    live = ex.program("transpose")(shards)
    literal = ex.program("transpose", live_scatter=False)(shards)
    np.testing.assert_array_equal(live.numpy(), literal.numpy())
    c = ex.compiled
    assert c.live_send_slots()[0].numel() == int(c.send_counts.sum()) \
        == sum(m.size for msgs in c.plan.sends for m in msgs)


def test_standard_stats():
    a_ref, a_port, p_ref, p_port, t_ref, t_port = _layout(LAYOUTS[1])
    op = _standard(a_port, t_port, p_port)
    ref = ref_spmv.compile_standard(a_ref, p_ref, t_ref, cache=False)
    st = op.stats()
    traffic = ref_spmv.padded_traffic(ref)
    for k in ("pair_padded", "pair_effective", "pair_max_rank_effective",
              "transpose"):
        assert st[k] == traffic[k], k
    assert st["pair_effective"] <= st["pair_padded"]
    assert {"messages_inter", "messages_intra"} <= set(st)


@pytest.mark.parametrize("fmt", ["ell", "coo", "bsr"])
def test_compiled_standard_from_reference_runs_the_reference_plan(fmt):
    """The port's device program on the reference's exact plan arrays
    gives the port's own result."""
    a_ref, a_port, p_ref, p_port, t_ref, t_port = _layout(LAYOUTS[0])
    ref = ref_spmv.compile_standard(a_ref, p_ref, t_ref, cache=False)
    for c_fmt in (ref.ensure_coo, ref.ensure_ell, ref.ensure_ell_t,
                  ref.ensure_fused):
        c_fmt()
    mine = port_spmv.compile_standard(
        a_port, p_port, t_port, device="cpu",
        tuner=LocalComputeParams(**dataclasses.asdict(TPU_V5E_LOCAL)))
    n_procs = t_ref.n_procs
    counts = np.zeros((n_procs, n_procs), np.int64)
    for msgs in ref.plan.sends:
        for m in msgs:
            counts[m.src, m.dst] = m.size
    theirs = port_spmv.compiled_standard_from_reference(
        ref.arrays, counts, ref.rows_pad, ref.cols_pad, ref.buf_pad,
        ref.pair_pad, ref.nnz_pad, ref.block_shape, ref.autotune,
        (t_ref.n_nodes, t_ref.ppn), device="cpu")
    v = np.random.default_rng(2).standard_normal((a_port.shape[0], 2))
    shards = port_spmv.pack_vector(v, p_port, t_port, mine.rows_pad)
    for c in (mine, theirs):
        assert c.resolve_local_compute(fmt) == fmt
    got = [port_spmv.standard_forward(c, shards, local_compute=fmt)
           for c in (mine, theirs)]
    assert torch.equal(got[0], got[1])
    tfmt = "coo" if fmt == "coo" else "ell"
    got = [port_spmv.standard_transpose(c, shards, local_compute=tfmt)
           for c in (mine, theirs)]
    assert torch.equal(got[0], got[1])


_SHARDMAP_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import repro.api as nap
    from repro.core.partition import contiguous_partition
    from repro.core.topology import Topology
    from repro.sparse import rotated_anisotropic_2d
    d = np.load(sys.argv[1])
    a = rotated_anisotropic_2d(int(d["n"]))
    op = nap.operator(a, topo=Topology(2, 2),
                      part=contiguous_partition(a.shape[0], 4),
                      backend="shardmap", method="standard",
                      local_compute="ell")
    out = {}
    for k in ("v1", "v4"):
        out["w_" + k] = op @ d[k]
        out["z_" + k] = op.T @ d[k]
    np.savez(sys.argv[2], **out)
""")


def test_standard_operator_matches_reference_shardmap(tmp_path):
    n = 12
    rng = np.random.default_rng(22)
    inputs = {"n": n, "v1": rng.standard_normal(n * n),
              "v4": rng.standard_normal((n * n, 4))}
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SHARDMAP_PROG, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(tmp_path / "out.npz")
    a = port_sparse.rotated_anisotropic_2d(n)
    op = port_api.operator(a, Topology(2, 2), method="standard",
                           local_compute="ell", device="cpu")
    for k in ("v1", "v4"):
        np.testing.assert_allclose(op @ inputs[k], ref["w_" + k], **TOL)
        np.testing.assert_allclose(op.T @ inputs[k], ref["z_" + k], **TOL)
