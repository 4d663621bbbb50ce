"""The port's MoE LMs (qwen3-moe-235b-a22b; deepseek-v2-236b with MLA
attention, shared experts and a dense first layer) against the JAX
package's on the CPU.

Weights come from the reference's ``LM.init`` and cross through
``params_from_jax``; inputs come from seeded numpy generators.  MLA is
held at rtol 1e-5 / atol 1e-6, the LMs' ``hidden``, ``prefill`` and
forward ``loss`` at rtol 1e-4 / atol 1e-4 (the two frameworks sum the
same float32 products in other orders), teacher-forced decoding against
``hidden`` + head at the reference's own rtol 2e-2 / atol 2e-3, and the
expert-parallel island against the local oracle at atol 1e-5 with no
copy dropped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.configs import shapes as jax_shapes
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build
from repro.models.registry import count_active_params as jax_active
from repro.models.registry import count_params as jax_count

from repro_torch.configs import get_config, get_reduced, shapes
from repro_torch.core.topology import Topology
from repro_torch.launch import serve
from repro_torch.models import (attention, build_model, count_active_params,
                                count_params, param_shapes)
from repro_torch.models.common import head_logits
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves_with_path

ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v2-236b"]
DS = "deepseek-v2-236b"
TOL = dict(rtol=1e-4, atol=1e-4)
MLA_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, its params as numpy, port model with them)."""
    arch = request.param
    jm = jax_build(jax_reduced(arch))
    tree = jax.device_get(jm.init(jax.random.key(4)))
    pm = build_model(get_reduced(arch), device="cpu").load(params_from_jax(tree))
    return arch, jm, tree, pm


def _tokens(arch, vocab, shape, salt=0):
    return np.random.default_rng(len(arch) + salt).integers(0, vocab, shape)


# ---------------------------------------------------------------------------
# configs and the shape grid
# ---------------------------------------------------------------------------

def test_deepseek_config_matches_reference():
    for mine, ref in ((get_config(DS), jax_config(DS)),
                      (get_reduced(DS), jax_reduced(DS))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    cfg = get_config(DS)
    assert (cfg.mla_kv_lora, cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
            cfg.first_dense_layers, cfg.d_ff) == (512, 160, 6, 2, 1, 12288)


def test_shape_grid_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC == jax_shapes.SUBQUADRATIC
    assert shapes.all_cells() == jax_shapes.all_cells()
    for arch, shape in jax_shapes.all_cells():
        assert shapes.cell_runnable(arch, shape) == jax_shapes.cell_runnable(arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_counts_match_reference(arch):
    """Meta tensors: no allocation at 235B parameters."""
    model = build_model(get_config(arch), device="cpu")
    leaves = list(tree_leaves_with_path(param_shapes(model)))
    assert all(t.device.type == "meta" for _, t in leaves)
    jm = jax_build(jax_config(arch))
    assert count_params(model) == jax_count(jm)
    assert count_active_params(model) == jax_active(jm)
    routers = [t for path, t in leaves if path[-1] == "router"]
    assert routers and all(t.dtype == torch.float32 for t in routers)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    """deepseek's reduced config, one layer's MLA weights from the
    reference (numpy) and the port's copy of them."""
    cfg = jax_reduced(DS)
    tree = jax.device_get(jax_build(cfg).init(jax.random.key(5)))
    jp = jax.tree.map(lambda a: a[0], tree["layers"]["attn"])
    tp = params_from_jax(tree)["layers"][0]["attn"]
    assert set(jp) == set(tp) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                                  "wkv_b", "wo"}
    return get_reduced(DS), jp, tp


def test_mla_apply_matches_reference(mla):
    cfg, jp, tp = mla
    x = np.random.default_rng(11).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax_attn.mla_apply(jp, jax_reduced(DS), jnp.asarray(x)))
    got = attention.mla_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **MLA_TOL)
    out, c_kv, k_rope = attention.mla_attend(tp, cfg, torch.from_numpy(x))
    _, _, jc, jk = jax_attn._mla_qkv(jp, jax_reduced(DS), jnp.asarray(x),
                                     jnp.arange(40)[None, :])
    np.testing.assert_allclose(c_kv.numpy(), np.asarray(jc), **MLA_TOL)
    np.testing.assert_allclose(k_rope.numpy(), np.asarray(jk), **MLA_TOL)


def test_mla_decode_matches_reference(mla):
    """8 absorbed-attention steps; the latent cache written in place."""
    cfg, jp, tp = mla
    b, max_seq, n = 3, 12, 8
    xs = np.random.default_rng(12).standard_normal((n, b, 1, cfg.d_model)) \
        .astype(np.float32)
    jcache = jax_attn.mla_init_cache(jax_reduced(DS), b, max_seq, jnp.float32)
    tcache = attention.mla_init_cache(cfg, b, max_seq, torch.float32, "cpu")
    c_kv = tcache["c_kv"]
    step = jax.jit(lambda c, x, ln: jax_attn.mla_decode(jp, jax_reduced(DS), x, c, ln))
    for t in range(n):
        length = np.full((b,), t, np.int32)
        want, jcache = step(jcache, jnp.asarray(xs[t]), jnp.asarray(length))
        got, out = attention.mla_decode(tp, cfg, torch.from_numpy(xs[t]), tcache,
                                        torch.from_numpy(length), pos=t)
        assert out is tcache and out["c_kv"] is c_kv
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLA_TOL,
                                   err_msg=f"step {t}")
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   **MLA_TOL)
    assert not tcache["c_kv"][:, n:].any()


def test_mla_full_cache_raises(mla):
    cfg, _, tp = mla
    cache = attention.mla_init_cache(cfg, 1, 2, torch.float32, "cpu")
    x = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="KV cache full"):
        attention.mla_decode(tp, cfg, x, cache, torch.full((1,), 2, dtype=torch.int32),
                             pos=2)


# ---------------------------------------------------------------------------
# the LMs
# ---------------------------------------------------------------------------

def test_hidden_and_loss_match_reference(pair):
    arch, jm, tree, pm = pair
    toks = _tokens(arch, pm.cfg.vocab, (2, 48))
    labels = _tokens(arch, pm.cfg.vocab, (2, 48), salt=1)
    labels[:, :3] = -1
    want = np.asarray(jm.hidden(tree, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        got = pm.hidden(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jl = float(jm.loss(tree, {"tokens": jnp.asarray(toks, jnp.int32),
                              "labels": jnp.asarray(labels, jnp.int32)}))
    tl = pm.loss({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert tl.dtype == torch.float32 and tl.requires_grad
    np.testing.assert_allclose(tl.item(), jl, **TOL)


def test_prefill_matches_reference(pair):
    arch, jm, tree, pm = pair
    toks = _tokens(arch, pm.cfg.vocab, (2, 40), salt=2)
    jlogits, jcache = jax.jit(jm.prefill)(tree, jnp.asarray(toks, jnp.int32))
    logits, cache = pm.prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    groups = [g for g in ("dense_layers", "layers") if g in jcache]
    assert groups == (["dense_layers", "layers"] if arch == DS else ["layers"])
    for group in groups:
        assert set(cache[group]) == set(jcache[group])
        for name, want in jcache[group].items():
            np.testing.assert_allclose(cache[group][name].numpy(), np.asarray(want),
                                       **TOL, err_msg=f"{group}/{name}")
    assert cache["pos"] == 40 and cache["length"].tolist() == [40, 40]


def test_decode_matches_prefill(pair):
    """Teacher-forced decode reproduces the full-sequence logits (the
    reference's ``test_decode_matches_prefill``, on the port)."""
    arch, _, _, pm = pair
    toks = torch.from_numpy(_tokens(arch, pm.cfg.vocab, (1, 8), salt=3))
    with torch.no_grad():
        want = head_logits(pm.hidden(toks), pm.head_matrix(), pm.cfg.final_softcap)
    cache, got = pm.init_cache(1, 8), []
    for t in range(8):
        logits, cache = pm.decode_step(cache, toks[:, t:t + 1])
        got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("mode", ["flat", "nap"])
@pytest.mark.parametrize("arch", ARCHS)
def test_island_lm_matches_local(arch, mode):
    """``mesh=Topology(2, 2)``: the MoE blocks through the island (batch
    over 2 pods of 2 chips, 2 experts a chip), prefill and decode steps
    within 1e-5 of the local oracle's, no copy dropped."""
    cfg = get_reduced(arch).replace(moe_dispatch=mode, wire_dtype="f32",
                                    capacity_factor=4.0)
    local = build_model(cfg, device="cpu").init(9)
    island = build_model(cfg, device="cpu", mesh=Topology(2, 2))
    island.load(local.param_tree())
    island.moe_stats = []
    toks = torch.from_numpy(_tokens(arch, cfg.vocab, (4, 16), salt=4))
    a, _ = local.prefill(toks)
    b, _ = island.prefill(toks)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)
    ca, cb = local.init_cache(4, 2), island.init_cache(4, 2)
    for t in range(2):
        a, ca = local.decode_step(ca, toks[:, t:t + 1])
        b, cb = island.decode_step(cb, toks[:, t:t + 1])
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"step {t}")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert len(island.moe_stats) == 3 * n_moe
    assert {s["mode"] for s in island.moe_stats} == {mode}
    assert all(v == 0 for s in island.moe_stats for v in s["dropped"].values())


def test_loaded_router_stays_float32():
    """A bfloat16 model keeps its router in float32, as the reference
    draws it; every other weight takes the model's dtype."""
    cfg = get_reduced("qwen3-moe-235b-a22b").replace(dtype="bfloat16")
    tree = build_model(get_reduced("qwen3-moe-235b-a22b"), device="cpu").init(2) \
        .param_tree()
    pm = build_model(cfg, device="cpu").load(tree)
    for path, t in tree_leaves_with_path(pm.param_tree()):
        assert t.dtype == (torch.float32 if path[-1] == "router" else torch.bfloat16), path
    toks = torch.from_numpy(_tokens("q", cfg.vocab, (2, 8)))
    logits, _ = pm.prefill(toks)
    assert torch.isfinite(logits).all()


def test_serve_main_deepseek_on_cpu(capsys):
    res = serve.main(["--arch", DS, "--device", "cpu"])
    cfg = get_reduced(DS)
    assert res.tokens.shape == (4, 16) and torch.isfinite(res.logits).all()
    assert set(res.cache) == {"dense_layers", "layers", "length", "pos"}
    assert res.cache["layers"]["c_kv"].shape == (cfg.n_layers - 1, 4, 128, cfg.mla_kv_lora)
    assert res.cache["pos"] == 32 + 16
    assert "generated ids" in capsys.readouterr().out
