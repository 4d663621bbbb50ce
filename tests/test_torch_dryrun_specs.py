"""The dry run's pure parts against the JAX package's, exactly: production
mesh shapes (``launch/mesh.py``), parameter, cache, batch and optimizer
state specs (``models/partitioning.py``, ``launch/steps.py``), the
per-device budgets ``analytic_gb`` of all 40 cells on both production
meshes, the activation spec functions (``models/actsharding.py``) and the
roofline arithmetic (``core/roofline.py``, the reference's TPU v5e
constants passed as ``chip=TPU_V5E``).

The reference's full-size shapes come from ``jax.eval_shape`` (no
memory), the port's from meta tensors; the reference's budgets from its
own functions, with axis-size dicts and a mesh that only has a
``.shape``.  A port leaf of one layer (``layers/3/attn/wq``) must carry
the reference's stacked spec without its first entry.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import roofline as jroof
from repro.core.hlo_analysis import HLOCost
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import actsharding as jact
from repro.models import build_model as jax_build
from repro.models import partitioning as jpart
from repro.models.registry import param_shapes as jax_param_shapes
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.configs.shapes import SHAPES, all_cells, cell_runnable
from repro_torch.core import roofline as roof
from repro_torch.core.op_analysis import OpCost
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps as psteps
from repro_torch.models import actsharding as pact
from repro_torch.models import partitioning as ppart
from repro_torch.models.registry import build_model, param_shapes
from repro_torch.optim.adamw import adamw_init

ARCHS = all_arch_ids()
SIZES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------

def test_production_mesh_shape_cases():
    f = pmesh.production_mesh_shape
    assert f(256) == (16, 16)
    assert f(512) == (16, 32)
    assert f(8) == (2, 4)
    assert f(1) == (1, 1)
    assert f(512, multi_pod=True) == (2, 16, 16)
    assert f(512, multi_pod=True, n_pods=4) == (4, 8, 16)
    with pytest.raises(ValueError, match="0 devices"):
        f(0)
    with pytest.raises(ValueError, match="7 devices"):
        f(7, multi_pod=True)
    with pytest.raises(ValueError, match="n_pods"):
        f(8, multi_pod=True, n_pods=1)


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_sweep_matches_reference(multi_pod):
    for n in range(0, 1025):
        for n_pods in (2, 3, 4):
            kw = dict(multi_pod=multi_pod, n_pods=n_pods)
            assert _outcome(pmesh.production_mesh_shape, n, **kw) == \
                _outcome(jmesh.production_mesh_shape, n, **kw), (n, kw)


def test_make_production_mesh_pins_and_needs_a_card(monkeypatch):
    m = pmesh.make_production_mesh(multi_pod=True, n_devices=512, n_pods=2)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.size == 512
    assert pmesh.dp_size(m) == 32 == jmesh.dp_size(m)
    single = pmesh.make_production_mesh(n_devices=256)
    assert single.shape == {"data": 16, "model": 16} and pmesh.dp_size(single) == 16
    assert pmesh.mesh_axes(True) == jmesh.mesh_axes(True)
    assert pmesh.make_production_mesh(multi_pod=True, n_devices=8).shape == \
        {"pod": 2, "data": 2, "model": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="n_devices"):
        pmesh.make_production_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert pmesh.make_production_mesh().shape == {"data": 2, "model": 4}


# --------------------------------------------------------------------------
# shapes of every arch, once
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shapes():
    """arch -> (reference model, its param shapes, port meta tree)."""
    out = {}
    for arch in ARCHS:
        jm = jax_build(jax_config(arch))
        out[arch] = (jm, jax_param_shapes(jm),
                     param_shapes(build_model(get_config(arch), device="meta")))
    return out


def _ref_specs(spec_tree):
    """path -> spec of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jpart._path_str(p): tuple(s) for p, s in flat}


def _port_specs(spec_tree):
    return {p: tuple(s) for p, s in ppart.path_leaves_specs(spec_tree)}


def _held(port: dict, ref: dict):
    """Every port spec equals the reference's; a per-layer one the stacked
    one without its first entry; every reference leaf is covered."""
    seen = set()
    for path, spec in port.items():
        parts = path.split("/")
        stacked = "/".join(p for p in parts if not p.isdigit())
        want = ref[stacked]
        if stacked != path:
            want = want[1:]
        assert spec == want, (path, spec, want)
        seen.add(stacked)
    assert seen == set(ref), set(ref) ^ seen


@pytest.mark.parametrize("zero3", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_match_reference_every_arch(shapes, multi_pod, zero3):
    sizes = SIZES[multi_pod]
    for arch in ARCHS:
        _, jshape, pshape = shapes[arch]
        cfg = get_config(arch)
        ref = _ref_specs(jpart.param_specs(jax_config(arch), jshape, multi_pod,
                                           zero3=zero3, axis_sizes=sizes))
        _held(_port_specs(ppart.param_specs(cfg, pshape, multi_pod, zero3=zero3,
                                            axis_sizes=sizes)), ref)


def test_guard_cases():
    """whisper's 51865 vocabulary and batch-1 caches drop their sharding."""
    sizes = SIZES[False]
    cfg = get_config("whisper-small")
    rules = ppart.param_rules(cfg, False)
    assert ppart._match(rules, "embed", (51865, 768), sizes) == (None, None)
    assert jpart._match(jpart.param_rules(cfg, False), "embed", (51865, 768), sizes) \
        == jax.sharding.PartitionSpec(None, None)
    assert ppart._match(rules, "embed", (51200, 768), sizes) == ("model", None)
    crules = ppart.cache_rules(get_config("zamba2-2.7b"), True)
    got = ppart._match(crules, "shared/k", (9, 1, 524288, 32, 80), SIZES[True])
    assert got == (None, None, "model", None, None)
    for a, b in [((16, 32), {"data": 16}), ((3, 5), {"model": 16})]:
        spec = ppart.P("data", "model")
        assert tuple(ppart._guard(spec, a, b)) == tuple(jpart._guard(
            jax.sharding.PartitionSpec("data", "model"), a, b))


def _ref_cache(jm, cfg, shape):
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return jax.eval_shape(lambda: jm.init_cache(b, s))
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    ps = jax_param_shapes(jm)
    if cfg.is_encoder_decoder:
        fr = jax.ShapeDtypeStruct((b, cfg.encoder_seq, cfg.d_model), jnp.float32)
        return jax.eval_shape(lambda p, t, f: jm.prefill(p, t, f), ps, toks, fr)[1]
    return jax.eval_shape(lambda p, t: jm.prefill(p, t), ps, toks)[1]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_match_reference(shapes, multi_pod, shape_name):
    sizes, shape = SIZES[multi_pod], SHAPES[shape_name]
    for arch in ARCHS:
        jm = shapes[arch][0]
        cfg = get_config(arch)
        ref_cache = _ref_cache(jm, jm.cfg, shape)
        port_cache = build_model(cfg, device="meta").init_cache(shape.global_batch,
                                                                shape.seq_len)
        ref = _ref_specs(jpart.cache_specs(jm.cfg, ref_cache, multi_pod, axis_sizes=sizes))
        port = _port_specs(ppart.cache_specs(cfg, port_cache, multi_pod, axis_sizes=sizes))
        assert port == ref, arch
        assert ppart.batch_spec(multi_pod) == tuple(jpart.batch_spec(multi_pod))
        assert ppart.frames_spec(multi_pod) == tuple(jpart.frames_spec(multi_pod))


# --------------------------------------------------------------------------
# optimizer state and the per-device budgets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_opt_state_specs_match_reference(shapes, multi_pod, state_dtype):
    sizes = SIZES[multi_pod]
    for arch in ("gemma2-2b", "qwen3-moe-235b-a22b", "zamba2-2.7b"):
        jm, jshape, pshape = shapes[arch]
        jcfg = jax_config(arch).replace(opt_state_dtype=state_dtype)
        cfg = get_config(arch).replace(opt_state_dtype=state_dtype)
        jo = jax.eval_shape(lambda p: jax_adamw_init(p, jsteps.adamw_config_for(jcfg)), jshape)
        po = adamw_init(pshape, psteps.adamw_config_for(cfg))
        for with_state in (True, False):
            ref = _ref_specs(jsteps.opt_state_spec_tree(
                jcfg, jshape, multi_pod, jo if with_state else None, sizes))
            port = _port_specs(psteps.opt_state_spec_tree(
                cfg, pshape, multi_pod, po if with_state else None, sizes))
            _held(port, ref)


def _ref_analytic(jm, jshape, arch, shape_name, multi_pod):
    """The reference's ``build_cell`` budget arithmetic, from its own
    functions, on a mesh that only has a ``.shape``."""
    cfg, shape, sizes = jax_config(arch), SHAPES[shape_name], SIZES[multi_pod]
    mesh = types.SimpleNamespace(shape=sizes)
    pspec = jpart.param_specs(cfg, jshape, multi_pod, axis_sizes=sizes)
    params_gb = jsteps._sharded_gb(jshape, pspec, sizes)
    if shape.kind == "train":
        opt_cfg = jsteps.adamw_config_for(cfg)
        oshape = jax.eval_shape(lambda p: jax_adamw_init(p, opt_cfg), jshape)
        ospec = jsteps.opt_state_spec_tree(cfg, jshape, multi_pod, oshape, sizes)
        opt_gb = jsteps._sharded_gb(oshape, ospec, sizes)
        grads_gb = params_gb * (4 / jnp.dtype(cfg.dtype).itemsize)
        act = (cfg.n_layers * (shape.global_batch // max(cfg.grad_accum, 1))
               * shape.seq_len * cfg.d_model * 2
               / (jmesh.dp_size(mesh) * mesh.shape.get("model", 1))) / 1e9
        return {"params": params_gb, "opt": opt_gb, "grads": grads_gb,
                "residuals": act, "total": params_gb + opt_gb + grads_gb + act}
    cache = _ref_cache(jm, cfg, shape)
    cache_gb = jsteps._sharded_gb(cache, jpart.cache_specs(cfg, cache, multi_pod,
                                                           axis_sizes=sizes), sizes)
    return {"params": params_gb, "cache": cache_gb, "total": params_gb + cache_gb}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_analytic_gb_matches_reference_every_cell(shapes, multi_pod):
    mesh = pmesh.make_production_mesh(multi_pod=multi_pod,
                                      n_devices=512 if multi_pod else 256, n_pods=2)
    cells = all_cells()
    assert len(cells) == 40
    for arch, shape_name in cells:
        jm, jshape, _ = shapes[arch]
        cell = psteps.build_cell(arch, shape_name, mesh)
        want = _ref_analytic(jm, jshape, arch, shape_name, multi_pod)
        assert set(cell.analytic_gb) == set(want)
        for k, v in want.items():
            assert cell.analytic_gb[k] == pytest.approx(v, rel=1e-12, abs=0), \
                (arch, shape_name, k)
        assert cell.kind == SHAPES[shape_name].kind
        assert cell_runnable(arch, shape_name) == cell_runnable(arch, shape_name)


def test_batch_specs_and_inputs():
    m = pmesh.make_production_mesh(multi_pod=True, n_devices=512)
    jm = types.SimpleNamespace(shape=m.shape)
    for arch in ("whisper-small", "gemma2-2b"):
        for shape_name, shape in SHAPES.items():
            port = psteps.batch_specs_for(get_config(arch), shape, True, m)
            ref = jsteps.batch_specs_for(jax_config(arch), shape, True, jm)
            assert {k: tuple(v) for k, v in port.items()} == \
                {k: tuple(v) for k, v in ref.items()}
            pin = psteps.input_specs(get_config(arch), shape)
            rin = jsteps.input_specs(jax_config(arch), shape)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in pin.items()} \
                == {k: (tuple(v.shape), str(v.dtype)) for k, v in rin.items()}
            assert all(v.device.type == "meta" for v in pin.values())


def test_sharded_gb_math():
    tree = {"a": torch.empty((16, 32), device="meta")}
    assert psteps._sharded_gb(tree, {"a": ppart.P("data", "model")},
                              {"data": 4, "model": 8}) == pytest.approx(16 * 32 * 4 / 32 / 1e9)
    assert psteps._sharded_gb(tree, {"a": ppart.P(("pod", "data"), None)},
                              {"pod": 2, "data": 4}) == pytest.approx(16 * 32 * 4 / 8 / 1e9)


# --------------------------------------------------------------------------
# activation spec functions
# --------------------------------------------------------------------------

class _Mesh:
    def __init__(self, shape):
        self.shape = shape


def _ref_act(multi_pod, sizes, cfg):
    obj = jact.ActShard()
    obj.mesh, obj.multi_pod, obj.cfg = _Mesh(sizes), multi_pod, cfg
    got = []
    obj._cs = lambda x, spec: got.append(tuple(spec)) or x
    return obj, got


@pytest.mark.parametrize("multi_pod", [False, True])
def test_activation_spec_functions_match_reference(multi_pod):
    rng = np.random.default_rng(29)
    for sizes in ({"data": 2, "model": 4}, {"data": 4, "model": 3},
                  {"pod": 2, "data": 2, "model": 2}):
        if multi_pod != ("pod" in sizes):
            continue
        for sp in (True, False):
            cfg = get_config("gemma2-2b").replace(sp_residuals=sp)
            obj, got = _ref_act(multi_pod, sizes, cfg)
            for _ in range(40):
                b, s, h, g = (int(v) for v in rng.integers(1, 13, 4))
                x3 = jax.ShapeDtypeStruct((b, s, 8), jnp.float32)
                for fn, jfn in ((pact.hidden_spec, obj.cs_hidden),
                                (pact.full_hidden_spec, obj.cs_full_hidden),
                                (pact.logits_spec, obj.cs_logits),
                                (pact.kv_spec, obj.cs_kv)):
                    got.clear()
                    jfn(x3)
                    assert fn(x3.shape, sizes, multi_pod, cfg) == got[0]
                got.clear()
                obj.cs_logits(jax.ShapeDtypeStruct((b, s, 2, 8), jnp.float32))
                assert pact.logits_spec((b, s, 2, 8), sizes, multi_pod, cfg) == got[0]
                got.clear()
                obj.cs_kv(jax.ShapeDtypeStruct((b, s, 8), jnp.float32))
                assert pact.kv_spec((b, s, 8), sizes, multi_pod, cfg) == got[0]
                q = jax.ShapeDtypeStruct((b, s, h, g, 8), jnp.float32)
                k = jax.ShapeDtypeStruct((b, s, h, 8), jnp.float32)
                got.clear()
                obj.cs_qkv(q, k, k)
                qs, ks = pact.qkv_specs(q.shape, sizes, multi_pod, cfg)
                assert [qs, ks, ks] == got


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------

def test_roofline_matches_reference_field_by_field():
    assert roof.TPU_V5E.peak_flops == jroof.PEAK_FLOPS
    assert roof.TPU_V5E.hbm_bw == jroof.HBM_BW
    assert roof.TPU_V5E.link_bw == jroof.LINK_BW
    assert roof.TPU_V5E.links == jroof.LINKS_PER_CHIP
    assert roof.HEADER == jroof.HEADER
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for g in (0, 1, 2, 3.5, 16, 256):
            assert roof._wire_factor(kind, g) == jroof._wire_factor(kind, g)
    for kind in ("train", "prefill", "decode"):
        assert roof.model_flops_for(kind, 123456789, 4096) == \
            jroof.model_flops_for(kind, 123456789, 4096)
    hlo = HLOCost(dot_flops=3.1e15, hbm_bytes=7.7e12,
                  collective_bytes={"all-reduce": 1e9, "all-to-all": 3e8,
                                    "collective-permute": 5e7},
                  group_sizes={"all-reduce": [16, 16, 32], "all-to-all": [2]},
                  dci_bytes=4e7)
    mine = OpCost(dot_flops=hlo.dot_flops, hbm_bytes=hlo.hbm_bytes,
                  collective_bytes=dict(hlo.collective_bytes),
                  group_sizes={k: list(v) for k, v in hlo.group_sizes.items()},
                  dci_bytes=hlo.dci_bytes)
    for chips in (1, 256, 512):
        want = jroof.build_roofline("a", "s", "m", chips, hlo, 9.9e17)
        got = roof.build_roofline("a", "s", "m", chips, mine, 9.9e17, chip=roof.TPU_V5E)
        for f in ("arch", "shape", "mesh", "chips", "flops", "hbm_bytes",
                  "collective_bytes", "collective_by_kind", "t_compute", "t_memory",
                  "t_collective", "t_collective_wire", "model_flops", "useful_ratio"):
            assert getattr(got, f) == getattr(want, f), f
        for p in ("dominant", "step_time", "mfu", "hardware_util"):
            assert getattr(got, p) == getattr(want, p), p
        assert got.row() == want.row()
    h100 = roof.build_roofline("a", "s", "m", 1, mine, 1e15)
    assert h100.chip is roof.H100_SXM
    assert h100.t_compute == mine.dot_flops / 989e12
    assert h100.t_memory == mine.hbm_bytes / 3.35e12
    assert math.isclose(roof.H100_SXM.link_bw * roof.H100_SXM.links, 450e9)
