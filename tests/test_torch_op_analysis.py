"""The operator counter (``core/op_analysis.py``) against the JAX
package's HLO reader (``core/hlo_analysis.py``) and by hand; the same
count on the CPU and on ``meta``; the kernel wrappers' declared work and
meta results; the island's exchanges against the communicator's own
count; the activation sites of reduced programs against the reference's;
and the dry run's command line.

``dot_flops`` equals the reference's ``analyze_hlo`` exactly on the
programs of ``tests/test_hlo_analysis.py`` (written as torch loops) and on
a reduced gemma2-2b ``loss``, ``prefill`` and ``decode_step`` at a
sequence of one attention block; at two blocks the port's count is the
reference's less the products of the query x key blocks the causal mask
covers whole, which the port skips.
"""
import json
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.hlo_analysis import analyze_hlo
from repro.models import actsharding as jact
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.models.registry import param_shapes as jax_param_shapes

from repro_torch.configs import get_reduced
from repro_torch.core.op_analysis import count_ops
from repro_torch.core.topology import Topology
from repro_torch.kernels.bsr_spmv.fused import fused_bsr_spmm, fused_bsr_spmm_packed
from repro_torch.kernels.bsr_spmv.kernel import bsr_spmm_padded
from repro_torch.kernels.decode_attn.kernel import decode_attention_grouped
from repro_torch.kernels.ell_spmv.kernel import ell_spmm_packed
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import ProductionMesh
from repro_torch.launch.steps import adamw_config_for, make_train_step
from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
from repro_torch.models.moe import EPInfo, moe_apply_sharded, moe_init
from repro_torch.models.registry import build_model, param_shapes
from repro_torch.optim.adamw import adamw_init


def _hlo(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


# --------------------------------------------------------------------------
# against the reference's HLO reader
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loops_match_reference_hlo(device):
    """A scan of 10 products and a 3 x 5 nested scan, as Python loops."""
    def g(x):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=10)
        return y

    def h(x):
        def outer(c, _):
            y, _ = jax.lax.scan(lambda cc, _: (cc @ cc, None), c, None, length=5)
            return y, None
        y, _ = jax.lax.scan(outer, x, None, length=3)
        return y

    want_g = _hlo(g, jax.ShapeDtypeStruct((64, 64), jnp.float32)).dot_flops
    want_h = _hlo(h, jax.ShapeDtypeStruct((32, 32), jnp.float32)).dot_flops
    x = torch.ones((64, 64), device=device)
    with count_ops() as cg:
        for _ in range(10):
            x = x @ x
    y = torch.ones((32, 32), device=device)
    with count_ops() as ch:
        for _ in range(3):
            for _ in range(5):
                y = y @ y
    assert cg.dot_flops == want_g == 10 * 2 * 64 ** 3
    assert ch.dot_flops == want_h == 15 * 2 * 32 ** 3


@pytest.fixture(scope="module")
def gemma():
    jm = jax_build(jax_reduced("gemma2-2b"))
    pm = build_model(get_reduced("gemma2-2b"), device="meta")
    pm.load(param_shapes(pm))
    return jm, jax_param_shapes(jm), pm


def _skipped_products(cfg, b, s):
    """FLOPs of the query x key block pairs the causal mask covers whole."""
    bq, bkv = min(cfg.attn_block_q, s), min(cfg.attn_block_kv, s)
    pairs = sum(1 for iq in range(-(-s // bq)) for ikv in range(-(-s // bkv))
                if ikv * bkv > min((iq + 1) * bq, s) - 1)
    return pairs * 2 * 2 * b * cfg.n_heads * bq * bkv * cfg.head_dim * cfg.n_layers


@pytest.mark.parametrize("s", [32, 64])
def test_gemma2_loss_and_prefill_match_reference_hlo(gemma, s):
    jm, ps, pm = gemma
    b = 2
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    want_loss = _hlo(lambda p, t: jm.loss(p, {"tokens": t, "labels": t}), ps, tok).dot_flops
    want_prefill = _hlo(lambda p, t: jm.prefill(p, t), ps, tok).dot_flops
    t = torch.zeros((b, s), dtype=torch.int32, device="meta")
    with torch.no_grad(), count_ops() as loss:
        pm.loss({"tokens": t, "labels": t})
    with count_ops() as prefill:
        pm.prefill(t)
    skipped = _skipped_products(pm.cfg, b, s)
    assert (s == 32) == (skipped == 0)
    assert loss.dot_flops == want_loss - skipped
    assert prefill.dot_flops == want_prefill - skipped


def test_gemma2_decode_matches_reference_hlo(gemma):
    """One token against a full cache of 16 (inside the window of 16: the
    kernel's declared rows are the reference's whole cache)."""
    jm, ps, pm = gemma
    b, s = 2, 16
    cache = jax.eval_shape(lambda: jm.init_cache(b, s))
    want = _hlo(lambda p, c, t: jm.decode_step(p, c, t), ps, cache,
                jax.ShapeDtypeStruct((b, 1), jnp.int32)).dot_flops
    pc = pm.init_cache(b, s)
    pc.update(pos=s - 1, length=torch.full((b,), s - 1, dtype=torch.int32, device="meta"))
    with count_ops() as got:
        pm.decode_step(pc, torch.zeros((b, 1), dtype=torch.int32, device="meta"))
    assert got.dot_flops == want
    k = got.kernels["decode_attention_grouped"]
    cfg = pm.cfg
    assert k["calls"] == cfg.n_layers
    assert k["flops"] == cfg.n_layers * 4.0 * b * s * cfg.n_heads * cfg.head_dim


# --------------------------------------------------------------------------
# by hand
# --------------------------------------------------------------------------

def test_hbm_bytes_by_hand():
    a = torch.ones((4, 8))
    w = torch.ones((8, 16))
    with count_ops() as c:
        y = a @ w                        # 128 + 512 in, 256 out
        z = y.t().reshape(64)[:32]       # a transpose's flattening copies; views
        e = torch.empty((3, 3))          # writes nothing
        s = (y + 1.0).sum()              # 256 in, 256 out; 256 in, 4 out
    assert z.shape == (32,) and e.numel() == 9 and float(s) == 9 * 64
    copy = 2 * 64 * 4                    # the flattening: a clone in and out
    assert c.dot_flops == 2 * 4 * 16 * 8
    assert c.hbm_bytes == (128 + 512 + 256) + copy + (256 + 256) + (256 + 4)


# --------------------------------------------------------------------------
# the same count on every device
# --------------------------------------------------------------------------

def _model(arch, device, **over):
    cfg = get_reduced(arch).replace(**over)
    kw = dict(mesh=Topology(2, 2), ep=EPInfo("model", "pod")) if cfg.is_moe else {}
    m = build_model(cfg, device, **kw)
    return m.load(param_shapes(m)) if device == "meta" else m.init(0)


SAME_COUNT_LAYERS = {"gemma2-2b": dict(n_layers=2, remat=True), "qwen3-moe-235b-a22b": dict(n_layers=2),
                     "whisper-small": dict(n_layers=1, encoder_layers=1)}


def _programs(arch, device, b=4, s=32, **over):
    m = _model(arch, device, **over)
    cfg = m.cfg
    tok = torch.zeros((b, s), dtype=torch.int32, device=device)
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model), device=device)
    opt_cfg = adamw_config_for(cfg)
    state = adamw_init(m.param_tree(), opt_cfg)
    step = make_train_step(m, opt_cfg)
    out = {}
    with count_ops() as out["train"]:
        step(state, dict(tokens=tok, labels=tok, **extra))
    with count_ops() as out["prefill"]:
        _, cache = m.prefill(tok, *extra.values())
    cache["pos"] = s - 1
    cache["length"] = torch.full((b,), s - 1, dtype=torch.int32, device=device)
    with count_ops() as out["decode"]:
        m.decode_step(cache, tok[:, :1])
    return out


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-small", "qwen3-moe-235b-a22b"])
def test_cpu_and_meta_count_the_same(arch):
    size = dict(s=16) if arch == "qwen3-moe-235b-a22b" else {}
    size.update(SAME_COUNT_LAYERS[arch])
    cpu, meta = _programs(arch, "cpu", **size), _programs(arch, "meta", **size)
    for kind in ("train", "prefill", "decode"):
        a, b = cpu[kind], meta[kind]
        assert a.dot_flops == b.dot_flops and a.dot_flops > 0, kind
        assert a.hbm_bytes == b.hbm_bytes, kind
        assert a.operators == b.operators, kind
        assert a.kernels == b.kernels, kind
        assert a.collective_bytes == b.collective_bytes, kind
        assert a.dci_bytes == b.dci_bytes, kind
    if arch != "qwen3-moe-235b-a22b":
        assert cpu["decode"].kernels["decode_attention_grouped"]["calls"] > 0
    else:
        assert cpu["train"].dci_bytes > 0


def test_kernel_wrappers_on_meta_report_declared_work():
    m = "meta"
    q = torch.empty((2, 3, 4, 16), dtype=torch.bfloat16, device=m)
    k = torch.empty((2, 3, 40, 16), dtype=torch.bfloat16, device=m)
    lengths = torch.empty((2,), dtype=torch.int32, device=m)
    for window, span, rows in ((0, None, 80), (8, None, 16), (0, 10, 20), (8, 10, 16)):
        with count_ops() as c:
            out = decode_attention_grouped(q, k, k, lengths, scale=0.25, window=window,
                                           span=span)
        assert out.shape == (2, 3, 4, 16) and out.dtype == torch.float32
        assert out.device.type == "meta"
        w = c.kernels["decode_attention_grouped"]
        assert w == {"calls": 1.0, "flops": 4.0 * rows * 3 * 4 * 16,
                     "bytes": q.numel() * 2 + 2 * rows * 3 * 16 * 2 + 8 + 2 * 3 * 4 * 16 * 4}
        assert c.operators == 0 and c.dot_flops == w["flops"]

    cols = torch.empty((4, 10, 3), dtype=torch.int32, device=m)
    vals = torch.empty((4, 10, 3), dtype=torch.float32, device=m)
    xs = (torch.empty((4, 7, 2), device=m), torch.empty((4, 5, 2), device=m))
    with count_ops() as c:
        out = ell_spmm_packed(cols, vals, xs)
    assert out.shape == (4, 10, 2) and out.device.type == "meta"
    assert c.kernels["ell_spmm_packed"] == {
        "calls": 1.0, "flops": 2.0 * 4 * 10 * 3 * 2,
        "bytes": 2 * 4 * 10 * 3 * 4 + 4 * 12 * 2 * 4 + 4 * 10 * 2 * 4}

    bcols = torch.empty((4, 5, 3), dtype=torch.int32, device=m)
    blocks = torch.empty((4, 5, 3, 8, 4), device=m)
    bxs = (torch.empty((4, 6, 4, 2), device=m), torch.empty((4, 2, 4, 2), device=m))
    for fn, args, name in ((fused_bsr_spmm_packed, (bcols, blocks, bxs), "fused_bsr_spmm_packed"),
                           (fused_bsr_spmm, (bcols, blocks, bxs[0]), "fused_bsr_spmm")):
        with count_ops() as c:
            out = fn(*args)
        segs = bxs if name.endswith("packed") else bxs[:1]
        assert out.shape == (4, 5, 8, 2) and out.device.type == "meta"
        assert c.kernels[name] == {
            "calls": 1.0, "flops": 2.0 * 4 * 5 * 3 * 8 * 4 * 2,
            "bytes": 4 * 5 * 3 * 4 + blocks.numel() * 4 + sum(x.numel() * 4 for x in segs)
            + 4 * 5 * 8 * 2 * 4}
    with count_ops() as c:
        out = bsr_spmm_padded(bcols[0], blocks[0], bxs[0][0])
    assert out.shape == (5, 8, 2) and out.device.type == "meta"
    assert c.kernels["bsr_spmm_padded"]["flops"] == 2.0 * 5 * 3 * 8 * 4 * 2


def test_kernel_on_cpu_counts_its_declared_work_only():
    """The plain version under the wrapper counts nothing; the lengths on
    the CPU give the rows inside the masks."""
    gen = torch.Generator().manual_seed(29)
    q = torch.randn((2, 3, 4, 16), generator=gen)
    k = torch.randn((2, 3, 40, 16), generator=gen)
    lengths = torch.tensor([5, 40], dtype=torch.int32)
    with count_ops() as c:
        out = decode_attention_grouped(q, k, k, lengths, scale=0.25, window=30)
    assert torch.isfinite(out).all() and c.operators == 0
    rows = 5 + 30
    assert c.kernels["decode_attention_grouped"]["flops"] == 4.0 * rows * 3 * 4 * 16
    with count_ops() as meta:
        decode_attention_grouped(q.to("meta"), k.to("meta"), k.to("meta"),
                                 lengths.to("meta"), scale=0.25, window=30, span=20)
    assert meta.kernels["decode_attention_grouped"]["flops"] == 4.0 * 2 * 20 * 3 * 4 * 16


# --------------------------------------------------------------------------
# the island's exchanges
# --------------------------------------------------------------------------

def test_island_exchanges_match_the_communicators_count():
    """On the example's 2 pods x 4 chips: dci_bytes is what
    ``inter_node_bytes()`` counts (per axis too), nap below flat, the same
    on meta.  The reference's HLO counts, per device, the whole operand of
    every collective whose first replica group spans both pods; the port
    counts, over the whole island, the bytes whose source and destination
    pods differ (ROADMAP, item 7c)."""
    cfg = get_reduced("qwen3-moe-235b-a22b").replace(
        n_experts=8, top_k=4, moe_dff=64, d_model=64, capacity_factor=8.0)
    topo, ep = Topology(2, 4), EPInfo("model", "pod")
    got = {}
    for device in ("cpu", "meta"):
        p = moe_init(0, cfg, torch.float32, device="cpu")
        x = torch.randn((4, 16, 64), generator=torch.Generator().manual_seed(0))
        if device == "meta":
            p = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in p.items()}
            x = x.to("meta")
        for mode in ("flat", "nap"):
            reset_inter_node_bytes()
            with count_ops() as c:
                moe_apply_sharded(p, cfg.replace(moe_dispatch=mode), x, ep, topo)
            counted = {k: v for k, v in inter_node_bytes().items() if ":" not in k}
            assert c.dci_by_axis == counted
            assert c.dci_bytes == sum(counted.values()) > 0
            assert set(c.collective_bytes) <= {"all-to-all", "collective-permute"}
            got[device, mode] = (c.dci_bytes, c.total_collective_bytes, c.dot_flops)
    assert got["cpu", "nap"][0] < got["cpu", "flat"][0]
    assert got["cpu", "flat"] == got["meta", "flat"]
    assert got["cpu", "nap"] == got["meta", "nap"]
    # one pod: nothing crosses a pod, and no exchange over a group of one counts
    with count_ops() as one:
        moe_apply_sharded(p, cfg, x, EPInfo("model", None), Topology(1, 4))
    assert one.dci_bytes == 0 and one.group_sizes.get("all-to-all") \
        and set(one.group_sizes["all-to-all"]) == {4}


# --------------------------------------------------------------------------
# activation sites against the reference's
# --------------------------------------------------------------------------

SITE_CASES = {  # one layer a scan, so the reference's traced body runs once
    "gemma2-2b": dict(n_layers=1),
    "qwen3-moe-235b-a22b": dict(n_layers=1),
    "deepseek-v2-236b": dict(n_layers=2),
    "whisper-small": dict(n_layers=1, encoder_layers=1),
    "zamba2-2.7b": dict(n_layers=1, shared_attn_every=1),
    "rwkv6-3b": dict(n_layers=1),
}
MESHES = {False: {"data": 2, "model": 4}, True: {"pod": 2, "data": 2, "model": 2}}


@pytest.fixture
def ref_sites(monkeypatch):
    """Records the reference's constraints as (site, shape, spec)."""
    rec, site = [], {"now": None}

    def cs(self, x, spec):
        now = site["now"]
        rec.append((now.pop(0) if isinstance(now, list) else now, tuple(x.shape),
                    tuple(spec)))
        return x

    def wrap(name, label):
        orig = getattr(jact.ActShard, name)

        def f(self, *a):
            site["now"] = list(label) if isinstance(label, tuple) else label
            return orig(self, *a)
        return f

    monkeypatch.setattr(jact.ActShard, "_cs", cs)
    for name, label in (("cs_hidden", "hidden"), ("cs_logits", "logits"),
                        ("cs_full_hidden", "full_hidden"), ("cs_kv", "kv"),
                        ("cs_qkv", ("q", "k", "v"))):
        monkeypatch.setattr(jact.ActShard, name, wrap(name, label))
    monkeypatch.setattr(jact, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda a, s: rec.append(("params", tuple(a.shape), tuple(s))) or a)
    monkeypatch.setattr(jmoe, "moe_apply_sharded",
                        lambda p, cfg, h, ep, mesh, **kw: jmoe.moe_apply_local(p, cfg, h))
    return rec


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list(SITE_CASES))
def test_activation_sites_match_reference(ref_sites, arch, multi_pod):
    sizes = MESHES[multi_pod]
    b, s = 4, 32
    jcfg = jax_reduced(arch).replace(**SITE_CASES[arch])
    jm = jax_build(jcfg, mesh=types.SimpleNamespace(shape=sizes), multi_pod=multi_pod)
    ps = jax_param_shapes(jm)
    pm = build_model(get_reduced(arch).replace(**SITE_CASES[arch]), "meta",
                     shard_mesh=ProductionMesh(tuple(sizes), tuple(sizes.values())))
    pm.load(param_shapes(pm))
    tok_j = jax.ShapeDtypeStruct((b, s), jnp.int32)
    tok = torch.zeros((b, s), dtype=torch.int32, device="meta")
    enc = jcfg.is_encoder_decoder
    fr_j = jax.ShapeDtypeStruct((b, jcfg.encoder_seq, jcfg.d_model), jnp.float32)
    fr = torch.zeros((b, jcfg.encoder_seq, jcfg.d_model), device="meta")
    batch_j = dict(tokens=tok_j, labels=tok_j, **({"frames": fr_j} if enc else {}))
    batch = dict(tokens=tok, labels=tok, **({"frames": fr} if enc else {}))
    programs = {
        "loss": (lambda: jax.eval_shape(jm.loss, ps, batch_j),
                 lambda: pm.loss(batch)),
        "prefill": (lambda: jax.eval_shape(jm.prefill, ps, tok_j, *([fr_j] if enc else [])),
                    lambda: pm.prefill(tok, *([fr] if enc else []))),
    }
    cache_j = jax.eval_shape(lambda: jm.init_cache(b, s))
    cache = pm.init_cache(b, s)
    cache.update(pos=s - 1, length=torch.full((b,), s - 1, dtype=torch.int32, device="meta"))
    programs["decode"] = (
        lambda: jax.eval_shape(jm.decode_step, ps, cache_j, jax.ShapeDtypeStruct((b, 1), jnp.int32)),
        lambda: pm.decode_step(cache, tok[:, :1]))
    for name, (ref_run, port_run) in programs.items():
        ref_sites.clear()
        ref_run()
        with torch.no_grad(), count_ops(trace_sites=True) as c:
            port_run()
        assert c.sites == ref_sites, (arch, name)
        assert len(c.sites) > 0 or name != "loss"


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def test_dryrun_main_writes_records(tmp_path, capsys):
    out = tmp_path / "d.json"
    args = ["--arch", "gemma2-2b", "--shape", "decode_32k", "--set", "n_layers=2",
            "--one-card", "--out", str(out)]
    assert dryrun.main(args) == 0
    rec = json.loads(out.read_text())["cells"]
    a, one = rec["gemma2-2b|decode_32k|16x16"], rec["gemma2-2b|decode_32k|1"]
    for r in (a, one):
        assert r["ok"] and r["kind"] == "decode" and r["overrides"] == {"n_layers": 2}
        assert r["ops"]["kernels"]["decode_attention_grouped"]["calls"] == 2
        assert set(r["memory"]["analytic"]) == {"params", "cache", "total"}
        assert "xla_cost" not in r and r["roofline"]["chip"] == "H100 SXM"
    assert a["chips"] == 256 and one["chips"] == 1
    assert a["ops"]["per_chip"] == "global / chips"
    assert a["ops"]["dot_flops_per_chip"] == pytest.approx(a["ops"]["dot_flops"] / 256)
    assert one["roofline"]["t_compute"] == pytest.approx(one["ops"]["dot_flops"] / 989e12)
    assert dryrun.main(args) == 0
    assert "(cached)" in capsys.readouterr().out
    assert dryrun.main(["--arch", "gemma2-2b", "--shape", "long_500k", "--out", str(out)]) == 0
    skip = json.loads(out.read_text())["cells"]["gemma2-2b|long_500k|16x16"]
    assert skip["ok"] and skip["skipped"] and "documented skip" in skip["reason"]
