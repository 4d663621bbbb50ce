"""The port's Mamba2 block (``models/ssm.py``) and zamba2 hybrid
(``models/zamba.py``) against the JAX package's on the CPU.

Weights come from the reference's ``init`` (a block's ``mamba2_init``, or
the whole model's, crossed through ``params_from_jax``); inputs from
seeded numpy generators.  Every function of the block is held at rtol
1e-4 / atol 1e-5 (the reference's float32 tolerance), the model's
``hidden``, forward ``loss``, ``prefill`` (logits and every cache leaf,
the Mamba states at the reference's zeros) and teacher-forced
``decode_step`` at rtol 1e-4 / atol 1e-4, and the reference's own checks
(chunked vs sequential, decode continuing a state, decode vs ``hidden``)
at its tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import ssm as jax_ssm
from repro.models.registry import count_params as jax_count

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import build_model, count_params, ssm
from repro_torch.models.common import head_logits
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zamba import ZambaModel
from repro_torch.optim.adamw import tree_leaves_with_path

ARCH = "zamba2-2.7b"
FN_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
F32_LEAVES = ("dt_bias", "a_log", "d_skip")


def _np(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=FN_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=msg)


@pytest.fixture(scope="module")
def block():
    """The reduced config, one block's weights from the reference (numpy;
    a_log, dt_bias and d_skip moved off their constant init, so that the
    decay and skip terms are exercised) and the port's copy of them."""
    jp = dict(jax.device_get(jax_ssm.mamba2_init(jax.random.key(0), jax_reduced(ARCH),
                                                 jnp.float32)))
    rng = np.random.default_rng(30)
    for k in F32_LEAVES:
        jp[k] = np.asarray(jp[k]) + _np(rng, *np.shape(jp[k]))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return get_reduced(ARCH), jp, tp


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Keys, shapes and dtypes; dt_bias, a_log and d_skip float32 in a
    bf16 block."""
    cfg = get_reduced(ARCH)
    want = jax.eval_shape(lambda k: jax_ssm.mamba2_init(k, jax_reduced(ARCH),
                                                        getattr(jnp, dtype)),
                          jax.random.key(0))
    got = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg, getattr(torch, dtype))
    meta = ssm.mamba2_init(None, cfg, getattr(torch, dtype))
    assert set(got) == set(meta) == set(want)
    for k, w in want.items():
        for t in (got[k], meta[k]):
            assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == w.dtype.name, k
    assert all(got[k].dtype == torch.float32 for k in F32_LEAVES)


@pytest.mark.parametrize("carried", [False, True], ids=["zero_tail", "carried_tail"])
def test_project_matches_reference(block, carried):
    """The projections and the causal conv, from zeros or a carried tail."""
    cfg, jp, tp = block
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 12, cfg.d_model)
    d_in = cfg.ssm_expand * cfg.d_model
    tail = _np(rng, 2, cfg.ssm_conv - 1, d_in) if carried else None
    want = jax_ssm._project(jp, jax_reduced(ARCH), jnp.asarray(x),
                            None if tail is None else jnp.asarray(tail))
    got = ssm._project(tp, cfg, torch.from_numpy(x),
                       None if tail is None else torch.from_numpy(tail))
    for name, g, w in zip(("u", "z", "B", "C", "dt", "conv"), got, want):
        _close(g, w, msg=name)
    assert got[4].dtype == torch.float32


@pytest.mark.parametrize("seq", [16, 48], ids=["one_chunk", "three_chunks"])
def test_mamba2_apply_matches_reference(block, seq):
    cfg, jp, tp = block
    x = _np(np.random.default_rng(2), 2, seq, cfg.d_model)
    want = jax_ssm.mamba2_apply(jp, jax_reduced(ARCH), jnp.asarray(x))
    _close(ssm.mamba2_apply(tp, cfg, torch.from_numpy(x)), want)


def test_mamba2_decode_matches_reference(block):
    """8 steps from a random state, each output and the carried state."""
    cfg, jp, tp = block
    rng = np.random.default_rng(3)
    b, d_in = 2, cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    st = {"h": _np(rng, b, h, cfg.ssm_head_dim, cfg.ssm_state),
          "conv": _np(rng, b, cfg.ssm_conv - 1, d_in)}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    for t in range(8):
        x = _np(rng, b, 1, cfg.d_model)
        jy, jst = jax_ssm.mamba2_decode(jp, jax_reduced(ARCH), jnp.asarray(x), jst)
        ty, tst = ssm.mamba2_decode(tp, cfg, torch.from_numpy(x), tst)
        _close(ty, jy, msg=f"step {t}")
    for k in st:
        _close(tst[k], jst[k], msg=k)


def test_mamba2_scan_ref_matches_reference(block):
    cfg, jp, tp = block
    x = _np(np.random.default_rng(4), 2, 20, cfg.d_model)
    want = jax_ssm.mamba2_scan_ref(jp, jax_reduced(ARCH), jnp.asarray(x))
    _close(ssm.mamba2_scan_ref(tp, cfg, torch.from_numpy(x)), want)


def test_init_state_matches_reference():
    cfg = get_reduced(ARCH)
    want = jax_ssm.mamba2_init_state(jax_reduced(ARCH), 3, jnp.bfloat16)
    got = ssm.mamba2_init_state(cfg, 3, torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in want.items()}
    assert not any(v.any() for v in got.values())


def test_chunked_matches_sequential(block):
    """The reference's ``test_mamba2_chunked_matches_sequential``, on the port."""
    cfg, _, tp = block
    x = torch.from_numpy(_np(np.random.default_rng(0), 2, cfg.ssm_chunk * 3, cfg.d_model))
    _close(ssm.mamba2_apply(tp, cfg, x), ssm.mamba2_scan_ref(tp, cfg, x).numpy(),
           dict(rtol=2e-4, atol=2e-4))


def test_decode_continues_state(block):
    """The reference's ``test_mamba2_decode_continues_state``, on the port."""
    cfg, _, tp = block
    s = cfg.ssm_chunk
    x = torch.from_numpy(_np(np.random.default_rng(1), 1, s + 4, cfg.d_model))
    full = ssm.mamba2_scan_ref(tp, cfg, x)
    state = ssm.mamba2_init_state(cfg, 1, torch.float32, "cpu")
    for t in range(s):
        _, state = ssm.mamba2_decode(tp, cfg, x[:, t:t + 1], state)
    outs = []
    for t in range(s, s + 4):
        y, state = ssm.mamba2_decode(tp, cfg, x[:, t:t + 1], state)
        outs.append(y)
    _close(torch.cat(outs, 1), full[:, s:].numpy())


def test_ssd_masks_with_where(block):
    """Above the diagonal the chunk's decay ratio overflows to inf; the
    selection drops it, so a steep decay still gives finite outputs equal
    to the sequential oracle's."""
    cfg, jp, tp = block
    steep = dict(tp, a_log=torch.full_like(tp["a_log"], 4.0),
                 dt_bias=torch.full_like(tp["dt_bias"], 3.0))
    x = torch.from_numpy(_np(np.random.default_rng(6), 1, cfg.ssm_chunk, cfg.d_model,
                             scale=1.0))
    u, z, bm, cm, dt, _ = ssm._project(steep, cfg, x)
    lcum = torch.cumsum(dt * -torch.exp(steep["a_log"]), dim=1)
    assert torch.isinf(torch.exp(lcum[:, :, None] - lcum[:, None])).any()
    got = ssm.mamba2_apply(steep, cfg, x)
    assert torch.isfinite(got).all()
    _close(got, ssm.mamba2_scan_ref(steep, cfg, x).numpy(), dict(rtol=2e-4, atol=2e-4))


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params as numpy, port model with them)."""
    jm = jax_build(jax_reduced(ARCH))
    tree = jax.device_get(jm.init(jax.random.key(6)))
    pm = build_model(get_reduced(ARCH), device="cpu").load(params_from_jax(tree))
    return jm, tree, pm


def _tokens(vocab, shape, salt=0):
    return np.random.default_rng(23 + salt).integers(0, vocab, shape)


def test_build_model_gives_the_hybrid(pair):
    _, _, pm = pair
    assert isinstance(pm, ZambaModel) and pm.n_apps == 2
    assert len(pm.mamba_layers) == get_reduced(ARCH).n_layers


def test_hidden_and_loss_match_reference(pair):
    jm, tree, pm = pair
    toks = _tokens(pm.cfg.vocab, (2, 32))
    labels = _tokens(pm.cfg.vocab, (2, 32), salt=1)
    labels[:, :3] = -1
    want = np.asarray(jm.hidden(tree, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        got = pm.hidden(torch.from_numpy(toks))
    _close(got, want, TOL)
    jl = float(jm.loss(tree, {"tokens": jnp.asarray(toks, jnp.int32),
                              "labels": jnp.asarray(labels, jnp.int32)}))
    tl = pm.loss({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), jl, **TOL)


def test_prefill_matches_reference(pair):
    """Logits and every cache leaf: the shared block's k / v of each
    application and the Mamba states at the reference's zeros."""
    jm, tree, pm = pair
    toks = _tokens(pm.cfg.vocab, (2, 32), salt=2)
    jlogits, jcache = jax.jit(jm.prefill)(tree, jnp.asarray(toks, jnp.int32))
    logits, cache = pm.prefill(torch.from_numpy(toks))
    _close(logits, jlogits, TOL)
    for group in ("shared", "mamba"):
        assert set(cache[group]) == set(jcache[group])
        for name, want in jcache[group].items():
            assert cache[group][name].dtype == getattr(torch, want.dtype.name)
            _close(cache[group][name], want, TOL, msg=f"{group}/{name}")
    assert not any(v.any() for v in cache["mamba"].values())
    assert cache["shared"]["k"].shape[:3] == (pm.n_apps, 2, 32)
    assert cache["pos"] == 32 and cache["length"].tolist() == [32, 32]


def test_decode_steps_match_reference(pair):
    """12 teacher-forced steps through both shared-block applications:
    logits at every step, then every cache leaf."""
    jm, tree, pm = pair
    toks = _tokens(pm.cfg.vocab, (2, 12), salt=3)
    decode = jax.jit(jm.decode_step)
    jcache, tcache = jm.init_cache(2, 16), pm.init_cache(2, 16)
    k_before = tcache["shared"]["k"]
    for t in range(12):
        jl, jcache = decode(tree, jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, out = pm.decode_step(tcache, torch.from_numpy(toks[:, t:t + 1]))
        assert out is tcache and tl.shape == (2, 1, pm.cfg.vocab)
        _close(tl, jl, TOL, msg=f"step {t}")
    assert tcache["shared"]["k"] is k_before
    for group in ("shared", "mamba"):
        for name, want in jcache[group].items():
            _close(tcache[group][name], want, TOL, msg=f"{group}/{name}")
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
    assert tcache["pos"] == 12


def test_decode_matches_hidden(pair):
    """The reference's ``test_decode_matches_prefill``, on the port."""
    _, _, pm = pair
    toks = torch.from_numpy(_tokens(pm.cfg.vocab, (1, 8), salt=4))
    with torch.no_grad():
        want = head_logits(pm.hidden(toks), pm.head_matrix())
    cache, got = pm.init_cache(1, 8), []
    for t in range(8):
        logits, cache = pm.decode_step(cache, toks[:, t:t + 1])
        got.append(logits[:, 0])
    _close(torch.stack(got, 1), want.numpy(), dict(rtol=2e-2, atol=2e-3))


def test_full_cache_raises(pair):
    """A cache as long as its prompt (``prefill``'s) takes no more tokens."""
    _, _, pm = pair
    toks = torch.from_numpy(_tokens(pm.cfg.vocab, (1, 16), salt=5))
    _, cache = pm.prefill(toks)
    with pytest.raises(ValueError, match="KV cache full"):
        pm.decode_step(cache, toks[:, :1])


def test_param_tree_and_counts_match_reference():
    """The full config's tree and count (2,340,162,720) on meta tensors."""
    model = build_model(get_config(ARCH), device="cpu")
    jm = jax_build(jax_config(ARCH))
    assert count_params(model) == jax_count(jm) == 2_340_162_720
    flat = dict(tree_leaves_with_path(model.init_tree(None)))
    assert all(t.device.type == "meta" for t in flat.values())
    n = get_config(ARCH).n_layers
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.eval_shape(
            jm.init, jax.random.key(0))):
        keys = tuple(p.key for p in path)
        if keys[0] == "mamba_layers":
            got = [flat[(keys[0], i) + keys[1:]] for i in range(n)]
            shape = leaf.shape[1:]
        else:
            got, shape = [flat[keys]], leaf.shape
        for t in got:
            assert (tuple(t.shape), str(t.dtype)[6:]) == (shape, leaf.dtype.name), keys
    assert len(flat) == len(jax.tree.leaves(jax.eval_shape(jm.init, jax.random.key(0)))) \
        + (n - 1) * 9         # a layer: norm and 8 Mamba2 leaves


def test_load_keeps_float32_leaves():
    tree = build_model(get_reduced(ARCH), device="cpu").init(1).param_tree()
    pm = build_model(get_reduced(ARCH).replace(dtype="bfloat16"), device="cpu").load(tree)
    for path, t in tree_leaves_with_path(pm.param_tree()):
        assert t.dtype == (torch.float32 if path[-1] in F32_LEAVES else torch.bfloat16), path
    logits, _ = pm.prefill(torch.from_numpy(_tokens(512, (2, 16))))
    assert torch.isfinite(logits).all()


def test_build_model_refuses_a_mesh():
    with pytest.raises(ValueError, match="MoE family"):
        build_model(get_reduced(ARCH), device="cpu", mesh=object())


def test_serve_main_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen", "4", "--max-seq", "16"])
    assert res.tokens.shape == (2, 4) and torch.isfinite(res.logits).all()
    assert set(res.cache) == {"mamba", "shared", "length", "pos"}
    assert res.cache["pos"] == 10
    assert "generated ids" in capsys.readouterr().out
