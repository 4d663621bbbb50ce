"""The port's hierarchical collectives (``repro_torch.core.hier_collectives``)
against the JAX package's (``repro.core.hier_collectives``) on the CPU.

* The reference runs once in a subprocess on a forced 8-device host mesh,
  (2 pods x 4) and (4 pods x 2), as ``tests/multidev/collectives_prog.py``
  runs it; it writes its outputs to an ``.npz``.  The port runs the same
  seeded inputs rank-batched and is held against them: the all-to-alls,
  the all-gather, the compressed pod psum alone (sum and residual) and
  ``nap_moe_dispatch`` (also at a capacity that drops) bit-equal; the
  sums at rtol 1e-5 (the reference test's tolerance), in the reference's
  own order (whole arrays, not set membership); the int8 psum within the
  reference's 0.02 of the exact sum, every replica bit-equal.
* The inter-pod bytes the communicator counts equal the arithmetic of
  each function's buffers, padding included, and ``nap_psum`` moves 1/ppn
  of ``flat_psum_tree``'s where nothing pads.
* Two gloo processes (this file re-entered as ``child``) give one
  process's bits, and send the other process the bytes the blocks give.
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
LAYOUTS = ((2, 4), (4, 2))           # (pods, inner) of the 8-device mesh
LAYOUT_IDS = [f"{p}x{i}" for p, i in LAYOUTS]
CAPACITIES = (64, 3)                 # 3 drops copies
N_PROC = 2


def inputs(lay):
    """Every input of one layout, float32 numpy from a seed."""
    P = lay[0] * lay[1]
    rng = np.random.default_rng(10 + lay[0])
    dest = rng.integers(0, P, size=(P, 16, 2))
    dest[rng.random(dest.shape) < 0.1] = -1
    return dict(
        x=rng.standard_normal((P, 6, 5)).astype(np.float32),
        leaf_w=rng.standard_normal((P, 7, 3)).astype(np.float32),
        leaf_b=rng.standard_normal((P, 3, 4)).astype(np.float32),
        g=rng.standard_normal((P, 4, 3)).astype(np.float32),
        z=rng.standard_normal((P, 16, 2)).astype(np.float32),
        y=rng.standard_normal((P, P, 3)).astype(np.float32),
        w=rng.standard_normal((P, 1001)).astype(np.float32),
        r=(rng.standard_normal((P, 1001)) * 0.01).astype(np.float32),
        c=rng.standard_normal((P, 4096)).astype(np.float32),
        tokens=rng.standard_normal((P, 16, 8)).astype(np.float32),
        dest=dest.astype(np.int32),
    )


def port_tree(d):
    """The mixed-dtype tree, keys inserted out of sorted order."""
    return {"w": torch.from_numpy(d["leaf_w"]),
            "b": torch.from_numpy(d["leaf_b"]).to(torch.bfloat16)}


# ---------------------------------------------------------------------------
# the reference, once, in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, sys.argv[2])
    import test_torch_collectives as t
    from repro.compat import make_mesh, shard_map
    from repro.core import hier_collectives as hc

    out = {}
    for lay in t.LAYOUTS:
        mesh = make_mesh(lay, ("pod", "inner"))
        spec = P(("pod", "inner"))

        def run(f, *args, n_out=1):
            def body(*vs):
                got = f(*[jax.tree.map(lambda l: l[0], v) for v in vs])
                return jax.tree.map(lambda l: l[None], got)
            outs = spec if n_out == 1 else (spec,) * n_out
            fn = shard_map(body, mesh=mesh, in_specs=(spec,) * len(args),
                           out_specs=outs)
            return jax.tree.map(np.asarray, jax.jit(fn)(*args))

        d = t.inputs(lay)
        k = f"{lay[0]}x{lay[1]}/"
        tree = {"w": jnp.asarray(d["leaf_w"]),
                "b": jnp.asarray(d["leaf_b"]).astype(jnp.bfloat16)}
        out[k + "nap_psum"] = run(lambda v: hc.nap_psum(v, "inner", "pod"), d["x"])
        for name, f in (("nap_psum_tree",
                         lambda tr: hc.nap_psum_tree(tr, "inner", "pod")),
                        ("flat_psum_tree",
                         lambda tr: hc.flat_psum_tree(tr, ("pod", "inner")))):
            got = run(f, tree)
            for leaf in ("w", "b"):
                out[k + f"{name}/{leaf}"] = got[leaf].astype(np.float32)
        for axis in (0, 1):
            out[k + f"nap_all_gather/{axis}"] = run(
                lambda v: hc.nap_all_gather(v, "inner", "pod", axis=axis), d["g"])
        out[k + "nap_reduce_scatter"] = run(
            lambda v: hc.nap_reduce_scatter(v, "inner", "pod"), d["z"])
        out[k + "nap_all_to_all"] = run(
            lambda v: hc.nap_all_to_all(v, "inner", "pod"), d["y"])
        out[k + "flat_all_to_all"] = run(
            lambda v: hc.flat_all_to_all(v, "inner", "pod"), d["y"])
        s, r = run(lambda v: hc.compressed_psum_outer(v, "pod"), d["w"], n_out=2)
        out[k + "compressed/none/sum"], out[k + "compressed/none/res"] = s, r
        s, r = run(lambda v, rr: hc.compressed_psum_outer(v, "pod", rr),
                   d["w"], d["r"], n_out=2)
        out[k + "compressed/given/sum"], out[k + "compressed/given/res"] = s, r
        s1, r1 = run(lambda v: hc.nap_psum_compressed(v, "inner", "pod"), d["c"],
                     n_out=2)
        s2, r2 = run(lambda v, rr: hc.nap_psum_compressed(v, "inner", "pod", rr),
                     d["c"], r1, n_out=2)
        out[k + "npc/1/sum"], out[k + "npc/1/res"] = s1, r1
        out[k + "npc/2/sum"], out[k + "npc/2/res"] = s2, r2
        for cap in t.CAPACITIES:
            rv, rs, va = run(lambda tok, dst: hc.nap_moe_dispatch(
                tok, dst, "inner", "pod", cap), d["tokens"], d["dest"], n_out=3)
            out[k + f"moe/{cap}/recv"] = rv
            out[k + f"moe/{cap}/src"] = rs
            out[k + f"moe/{cap}/valid"] = va
    np.savez(sys.argv[1], **out)
    print("REFERENCE OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                           str(ROOT / "tests")], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _topo(lay):
    from repro_torch.core.topology import Topology
    return Topology(*lay)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _key(lay):
    return f"{lay[0]}x{lay[1]}/"


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the port's runs of every case, shared by the one- and two-process checks
# ---------------------------------------------------------------------------

def _psum_tree(fn):
    def run(d, topo, mesh):
        got = fn(port_tree(d), topo, mesh, device="cpu")
        assert list(got) == ["b", "w"] and got["b"].dtype == torch.bfloat16
        return {"w": got["w"], "b": got["b"].float()}
    return run


def _compressed(d, topo, mesh):
    from repro_torch.core.hier_collectives import compressed_psum_outer
    s, r = compressed_psum_outer(_t(d["w"]), topo, mesh, residual=_t(d["r"]),
                                 device="cpu")
    return {"sum": s, "res": r}


def _npc(d, topo, mesh):
    from repro_torch.core.hier_collectives import nap_psum_compressed
    s1, r1 = nap_psum_compressed(_t(d["c"]), topo, mesh, device="cpu")
    s2, r2 = nap_psum_compressed(_t(d["c"]), topo, mesh, residual=r1, device="cpu")
    return {"1/sum": s1, "1/res": r1, "2/sum": s2, "2/res": r2}


def _moe(cap):
    def run(d, topo, mesh):
        from repro_torch.core.hier_collectives import nap_moe_dispatch
        rv, rs, va = nap_moe_dispatch(_t(d["tokens"]), _t(d["dest"]), topo, cap,
                                      mesh, device="cpu")
        return {"recv": rv, "src": rs, "valid": va}
    return run


def _simple(name, key, **kw):
    def run(d, topo, mesh):
        from repro_torch.core import hier_collectives as hc
        return {"": getattr(hc, name)(_t(d[key]), topo, mesh, device="cpu", **kw)}
    return run


def _cases():
    from repro_torch.core import hier_collectives as hc
    cases = {
        "nap_psum": _simple("nap_psum", "x"),
        "nap_psum_tree": _psum_tree(hc.nap_psum_tree),
        "flat_psum_tree": _psum_tree(hc.flat_psum_tree),
        "nap_all_gather/0": _simple("nap_all_gather", "g", axis=0),
        "nap_all_gather/1": _simple("nap_all_gather", "g", axis=1),
        "nap_reduce_scatter": _simple("nap_reduce_scatter", "z"),
        "nap_all_to_all": _simple("nap_all_to_all", "y"),
        "flat_all_to_all": _simple("flat_all_to_all", "y"),
        "compressed": _compressed,
        "npc": _npc,
    }
    cases.update({f"moe/{cap}": _moe(cap) for cap in CAPACITIES})
    return cases


CASE_NAMES = ("nap_psum", "nap_psum_tree", "flat_psum_tree", "nap_all_gather/0",
              "nap_all_gather/1", "nap_reduce_scatter", "nap_all_to_all",
              "flat_all_to_all", "compressed", "npc") \
    + tuple(f"moe/{cap}" for cap in CAPACITIES)


def _run_case(name, lay, mesh=None, block=None):
    """One case on the whole inputs (``mesh`` None) or on a process's
    block of ranks: ``{output: numpy}``."""
    d = inputs(lay)
    if block is not None:
        d = {k: v[block[0]:block[1]] for k, v in d.items()}
    out = _cases()[name](d, _topo(lay), mesh)
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_tree_flattens_in_sorted_key_order():
    """Leaves concatenate as ``jax.tree.flatten`` orders them (dict keys
    sorted, not insertion order); each leaf comes back in its shape and
    dtype."""
    import jax
    from repro_torch.core.hier_collectives import _flatten_concat, _split_restore
    P = 2
    tree = {"z": torch.arange(P * 3.0).reshape(P, 3),
            "a": {"y": torch.full((P, 2), 7.0, dtype=torch.bfloat16),
                  "b": [torch.ones(P, 1), torch.zeros(P, 2, 2)]}}
    flat, treedef, shapes = _flatten_concat(tree, torch.device("cpu"))
    ref_order = [np.asarray(leaf) for leaf in jax.tree.leaves(
        jax.tree.map(lambda t: t.float().numpy(), tree))]
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([leaf.reshape(P, -1) for leaf in ref_order], 1))
    back = _split_restore(flat, treedef, shapes)
    assert list(back) == ["a", "z"] and list(back["a"]) == ["b", "y"]
    assert back["a"]["y"].dtype == torch.bfloat16
    assert torch.equal(back["z"], tree["z"])
    assert torch.equal(back["a"]["b"][1], tree["a"]["b"][1])


@pytest.mark.parametrize("shape, inner", [((6, 5), 4), ((30,), 3), ((7, 3), 8),
                                          ((1,), 2)])
def test_residual_shape_matches_reference(shape, inner):
    from repro.core.hier_collectives import residual_shape_for as ref_shape
    from repro_torch.core.hier_collectives import residual_shape_for
    assert residual_shape_for(shape, inner) == ref_shape(shape, inner)


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_psum_matches_reference(ref, lay):
    got = _run_case("nap_psum", lay)[""]
    want = ref[_key(lay) + "nap_psum"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    exact = inputs(lay)["x"].astype(np.float64).sum(0)
    np.testing.assert_allclose(got, np.broadcast_to(exact, got.shape), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["nap_psum_tree", "flat_psum_tree"])
@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_psum_trees_match_reference(ref, lay, name):
    """A float32 and a bfloat16 leaf, keys inserted unsorted."""
    got = _run_case(name, lay)
    for leaf in ("w", "b"):
        np.testing.assert_allclose(got[leaf], ref[_key(lay) + f"{name}/{leaf}"],
                                   rtol=1e-5)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_all_gather_bit_equal_to_reference(ref, lay, axis):
    """The whole gathered array in the reference's (inner-major) order."""
    got = _run_case(f"nap_all_gather/{axis}", lay)[""]
    want = ref[_key(lay) + f"nap_all_gather/{axis}"]
    np.testing.assert_array_equal(got, want)
    g = inputs(lay)["g"]
    order = [o * lay[1] + i for i in range(lay[1]) for o in range(lay[0])]
    np.testing.assert_array_equal(got[0], np.concatenate([g[r] for r in order], axis))


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_reduce_scatter_matches_reference(ref, lay):
    """Rank ``(o, i)`` holds chunk ``i * n_pods + o`` of the sum."""
    got = _run_case("nap_reduce_scatter", lay)[""]
    np.testing.assert_allclose(got, ref[_key(lay) + "nap_reduce_scatter"], rtol=1e-5)
    n_out, n_in = lay
    total = inputs(lay)["z"].astype(np.float64).sum(0)
    chunks = total.reshape(n_in * n_out, -1, total.shape[-1])
    for r in range(n_out * n_in):
        o, i = divmod(r, n_in)
        np.testing.assert_allclose(got[r], chunks[i * n_out + o], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_reduce_scatter_then_gather_is_the_psum(lay):
    """The FSDP pattern: the gather's order undoes the scatter's."""
    from repro_torch.core.hier_collectives import nap_all_gather, nap_reduce_scatter
    topo = _topo(lay)
    z = _t(inputs(lay)["z"])
    back = nap_all_gather(nap_reduce_scatter(z, topo, device="cpu"), topo,
                          device="cpu")
    want = z.double().sum(0).numpy()
    for r in range(topo.n_procs):
        np.testing.assert_allclose(back[r].numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["nap_all_to_all", "flat_all_to_all"])
@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_all_to_all_bit_equal_to_reference(ref, lay, name):
    got = _run_case(name, lay)[""]
    np.testing.assert_array_equal(got, ref[_key(lay) + name])
    np.testing.assert_array_equal(got, inputs(lay)["y"].transpose(1, 0, 2))


@pytest.mark.parametrize("residual", ["none", "given"])
@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_compressed_psum_outer_bit_equal_to_reference(ref, lay, residual):
    """The int8 ring over the pods alone, no inner stage: the sum and the
    new residual bit for bit (1001 values: the chunks pad)."""
    from repro_torch.core.hier_collectives import compressed_psum_outer
    d = inputs(lay)
    res = _t(d["r"]) if residual == "given" else None
    s, r = compressed_psum_outer(_t(d["w"]), _topo(lay), residual=res, device="cpu")
    k = _key(lay) + f"compressed/{residual}/"
    np.testing.assert_array_equal(s.numpy(), ref[k + "sum"])
    np.testing.assert_array_equal(r.numpy(), ref[k + "res"])


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_psum_compressed_within_reference_gate(ref, lay):
    """Within the reference test's 0.02 of the exact sum, every replica
    bit-equal, and equal to the reference's bits (a second step fed the
    residual too)."""
    got = _run_case("npc", lay)
    exact = inputs(lay)["c"].astype(np.float64).sum(0)
    for step in ("1", "2"):
        s = got[f"{step}/sum"]
        for r in range(1, s.shape[0]):
            np.testing.assert_array_equal(s[r], s[0])
        assert _rel(s[0], exact) < 0.02
        np.testing.assert_array_equal(s, ref[_key(lay) + f"npc/{step}/sum"])
        np.testing.assert_array_equal(got[f"{step}/res"],
                                      ref[_key(lay) + f"npc/{step}/res"])
    assert got["1/res"].shape[1:] == (4096 // lay[1],)


@pytest.mark.parametrize("cap", CAPACITIES)
@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_moe_dispatch_bit_equal_to_reference(ref, lay, cap):
    got = _run_case(f"moe/{cap}", lay)
    for k in ("recv", "src", "valid"):
        np.testing.assert_array_equal(got[k], ref[_key(lay) + f"moe/{cap}/{k}"])
    d = inputs(lay)
    T = d["tokens"].shape[1]
    n_chips = lay[0] * lay[1]
    delivered = 0
    for chip in range(n_chips):
        ids = got["src"][chip][got["valid"][chip]]
        assert len(set(ids.tolist())) == len(ids)          # once at most
        want = {c * T + t for c in range(n_chips) for t in range(T)
                if chip in d["dest"][c, t].tolist()}
        assert set(ids.tolist()) <= want
        if cap >= T:
            assert set(ids.tolist()) == want                # nothing drops
        np.testing.assert_array_equal(got["recv"][chip][got["valid"][chip]],
                                      d["tokens"].reshape(-1, d["tokens"].shape[2])[ids])
        delivered += len(ids)
    if cap < T:
        assert 0 < delivered < sum(len({c for c in d["dest"][s, t].tolist() if c >= 0})
                                   for s in range(n_chips) for t in range(T))


# ---------------------------------------------------------------------------
# counted bytes: the communicator's counts against the buffers' arithmetic
# ---------------------------------------------------------------------------

def _ceil(a, b):
    return -(-a // b)


def _expected_bytes(name, lay, ranks, nodes, peers, ring):
    """Bytes the case sends: ``ranks`` sending ranks, each to ``nodes``
    nodes (pod exchanges) or ``peers`` ranks (flat exchanges) on the far
    side, and ``ring`` ranks a ring hop.  ``{"axis": ..., label: bytes}``,
    padding included."""
    n_out, n_in = lay
    P = n_out * n_in
    d = inputs(lay)

    def psum_sub(n):               # a rank's pod-stage chunk, in values
        return _ceil(_ceil(n, n_in), n_out)

    def ring_hops(n):              # int8 words + one f32 scale, 2 (n_out - 1) hops
        return 2 * (n_out - 1) * ring * (_ceil(n, n_out) + 4)

    n_tree = d["leaf_w"][0].size + d["leaf_b"][0].size
    if name == "nap_psum":
        return {"axis": "node", "psum": 2 * ranks * nodes * psum_sub(d["x"][0].size) * 4}
    if name == "nap_psum_tree":
        return {"axis": "node", "psum": 2 * ranks * nodes * psum_sub(n_tree) * 4}
    if name == "flat_psum_tree":
        return {"axis": "nodexproc", "psum": 2 * ranks * peers * _ceil(n_tree, P) * 4}
    if name.startswith("nap_all_gather"):
        return {"axis": "node", "gather": ranks * nodes * d["g"][0].size * 4}
    if name == "nap_reduce_scatter":
        return {"axis": "node",
                "scatter": ranks * nodes * d["z"][0].size // (n_in * n_out) * 4}
    if name == "nap_all_to_all":
        return {"axis": "node", "all_to_all": ranks * nodes * n_in * 3 * 4}
    if name == "flat_all_to_all":
        return {"axis": "nodexproc", "all_to_all": ranks * peers * 3 * 4}
    if name == "compressed":
        return {"axis": "node", "int8": ring_hops(d["w"][0].size)}
    if name == "npc":                 # two steps, each on the inner shard
        return {"axis": "node", "int8": 2 * ring_hops(d["c"][0].size // n_in)}
    cap = int(name.split("/")[1])
    T, D = d["tokens"].shape[1:]
    K = d["dest"].shape[2]
    per = ranks * nodes * cap
    return {"axis": "node", "tokens": per * D * 4, "meta": per * K * 4,
            "srcs": per * 4}


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_counted_inter_pod_bytes(lay, name):
    """One process: every message between ranks of different pods counts,
    at its padded size, under its axis and label."""
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    n_out, n_in = lay
    P = n_out * n_in
    reset_inter_node_bytes()
    _run_case(name, lay)
    got = inter_node_bytes()
    want = _expected_bytes(name, lay, ranks=P, nodes=n_out - 1, peers=P - n_in,
                           ring=P)
    axis = want.pop("axis")
    assert {k: got.get(f"{axis}:{k}", 0) for k in want} == want
    assert got[axis] == sum(want.values())
    assert set(got) == {axis} | {f"{axis}:{k}" for k in want}


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_nap_psum_moves_one_over_inner_of_flat(lay):
    """The reference's claim (``core/hier_collectives.py:23-25``) on a
    bucket that nothing pads: nap's inter-pod bytes are 1/ppn of flat's;
    the 3-step all-to-all moves the flat one's bytes, in one pod exchange."""
    from repro_torch.core.hier_collectives import (flat_psum_tree, nap_psum_tree)
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    topo = _topo(lay)
    P = topo.n_procs
    tree = {"g": torch.randn(P, 3, P * 2, generator=torch.Generator().manual_seed(0))}
    counted = {}
    for name, fn, axis in (("nap", nap_psum_tree, "node"),
                           ("flat", flat_psum_tree, "nodexproc")):
        reset_inter_node_bytes()
        out = fn(tree, topo, device="cpu")["g"]
        counted[name] = inter_node_bytes()[axis]
        np.testing.assert_allclose(out.numpy(), np.broadcast_to(
            tree["g"].double().sum(0).numpy(), out.shape), rtol=1e-5, atol=1e-5)
    assert counted["nap"] * topo.ppn == counted["flat"]
    bucket = tree["g"][0].numel() * 4
    assert counted["flat"] == 2 * P * (P - topo.ppn) * bucket // P
    a2a = {k: _expected_bytes(k, lay, P, topo.n_nodes - 1, P - topo.ppn, P)
           for k in ("nap_all_to_all", "flat_all_to_all")}
    assert a2a["nap_all_to_all"]["all_to_all"] == a2a["flat_all_to_all"]["all_to_all"]


# ---------------------------------------------------------------------------
# the communicator's new call and generalized payloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [1, 2, -1])
@pytest.mark.parametrize("lay", [(4, 2), (3, 1), (1, 3)])
def test_node_permute_is_a_ring_roll(lay, shift):
    from repro_torch.mesh.comm import (inter_node_bytes, node_permute,
                                       reset_inter_node_bytes)
    topo = _topo(lay)
    x = torch.arange(topo.n_procs * 5, dtype=torch.float32).reshape(topo.n_procs, 5)
    reset_inter_node_bytes()
    got = node_permute(x, topo, shift=shift, label="t")
    for r in range(topo.n_procs):
        n, p = divmod(r, topo.ppn)
        src = ((n - shift) % topo.n_nodes) * topo.ppn + p
        assert torch.equal(got[r], x[src])
    counted = inter_node_bytes()
    assert counted.get("node:t", 0) == (x.numel() * 4 if topo.n_nodes > 1 else 0)


@pytest.mark.parametrize("payload", [(3,), (3, 2), (2, 2, 2)])
def test_node_all_to_all_takes_any_payload_rank(payload):
    """``recv[m, p, n] = send[n, p, m]`` whatever trails the node axis."""
    from repro_torch.mesh.comm import node_all_to_all
    topo = _topo((3, 2))
    x = torch.randn((topo.n_procs, topo.n_nodes) + payload,
                    generator=torch.Generator().manual_seed(1))
    got = node_all_to_all(x, topo)
    for r in range(topo.n_procs):
        m, p = divmod(r, topo.ppn)
        for n in range(topo.n_nodes):
            assert torch.equal(got[r, n], x[n * topo.ppn + p, m])


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core import hier_collectives as hc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = _topo((2, 2))
    x = torch.ones(4, 8)
    calls = [lambda: hc.nap_psum(x, topo), lambda: hc.nap_psum_tree({"a": x}, topo),
             lambda: hc.flat_psum_tree({"a": x}, topo),
             lambda: hc.nap_all_gather(x, topo), lambda: hc.nap_reduce_scatter(x, topo),
             lambda: hc.nap_all_to_all(torch.ones(4, 4, 2), topo),
             lambda: hc.flat_all_to_all(torch.ones(4, 4, 2), topo),
             lambda: hc.compressed_psum_outer(x, topo),
             lambda: hc.nap_psum_compressed(x, topo),
             lambda: hc.nap_moe_dispatch(torch.ones(4, 3, 2),
                                         torch.zeros(4, 3, 1, dtype=torch.int32),
                                         topo, 4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert hc.nap_psum(x, topo, device="cpu").device.type == "cpu"


def test_shape_checks():
    from repro_torch.core import hier_collectives as hc
    topo = _topo((2, 2))
    with pytest.raises(ValueError, match="leading axis holds 3 ranks"):
        hc.nap_psum(torch.ones(3, 4), topo, device="cpu")
    with pytest.raises(ValueError, match="split into 2 x 2"):
        hc.nap_reduce_scatter(torch.ones(4, 6), topo, device="cpu")
    with pytest.raises(ValueError, match="same rank axis"):
        hc.nap_psum_tree({"a": torch.ones(4, 2), "b": torch.ones(2, 2)}, topo,
                         device="cpu")


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------

def child(out_dir):
    from repro_torch.mesh import attach, detach, mesh_for
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    info = attach(verbose=True)
    pid = info["process_id"]
    results, meta = {}, {}
    for lay in LAYOUTS:
        mesh = mesh_for(_topo(lay))
        for name in CASE_NAMES:
            before = dict(mesh.stats)
            reset_inter_node_bytes()
            out = _run_case(name, lay, mesh, mesh.ranks)
            key = _key(lay) + name
            for k, v in out.items():
                results[f"{key}/{k}"] = v
            meta[key] = {"counted": inter_node_bytes(), "ranks": list(mesh.ranks),
                         "stats": {k: mesh.stats[k] - before.get(k, 0)
                                   for k in mesh.stats}}
    np.savez(Path(out_dir) / f"coll_{pid}.npz", **results)
    (Path(out_dir) / f"coll_{pid}.json").write_text(json.dumps(meta))
    detach()
    print(f"CHILD {pid} OK", flush=True)


@pytest.fixture(scope="module")
def proc_run(tmp_path_factory):
    from repro_torch.mesh import launch
    out = tmp_path_factory.mktemp("collectives_mesh")
    res = launch(__file__, N_PROC, args=["child", str(out)], local_devices=1,
                 env={"JAX_PLATFORMS": "cpu", "REPRO_MESH_BACKEND": "gloo"},
                 timeout_s=600)
    runs = []
    for pid in range(N_PROC):
        assert f"CHILD {pid} OK" in res.output(pid), res.output(pid)
        with np.load(out / f"coll_{pid}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        runs.append((arrays, json.loads((out / f"coll_{pid}.json").read_text())))
    return runs


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_two_processes_bit_equal_to_one(proc_run, lay, name):
    """Each process runs its block of pods ((2, 4): one pod a process;
    (4, 2): two); together they give the one-process run's bits and send
    the other process exactly its far-side messages."""
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    reset_inter_node_bytes()
    whole = _run_case(name, lay)
    one = inter_node_bytes()
    key = _key(lay) + name
    for k, v in whole.items():
        got = np.concatenate([arrays[f"{key}/{k}"] for arrays, _ in proc_run])
        np.testing.assert_array_equal(got, v)
    # each process counts its own ranks' inter-pod messages: together, one's
    for k, v in one.items():
        assert sum(m[key]["counted"].get(k, 0) for _, m in proc_run) == v
    n_out, n_in = lay
    P = n_out * n_in
    p_loc = P // N_PROC
    want = _expected_bytes(name, lay, ranks=p_loc, nodes=n_out - n_out // N_PROC,
                           peers=P - p_loc, ring=n_in)
    axis = want.pop("axis")
    for _, meta in proc_run:
        st = meta[key]["stats"]
        assert {k: st.get(f"sent_bytes_{axis}:{k}", 0) for k in want} == want
        assert st[f"sent_bytes_{axis}"] == sum(want.values())
        assert st["sent_bytes_node" if axis == "nodexproc" else "sent_bytes_nodexproc"] == 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "child":
        child(sys.argv[2])
    else:
        sys.exit("usage: test_torch_collectives.py child OUT_DIR (under launch())")
