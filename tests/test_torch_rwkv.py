"""The port's RWKV6 (``models/rwkv.py`` and the SSM family of ``LM``)
against the JAX package's on the CPU.

Weights come from the reference's ``init`` (a block's ``rwkv6_init``, or
the whole model's, crossed through ``params_from_jax``); inputs from
seeded numpy generators.  Every function of the block is held at rtol
1e-4 / atol 1e-5 (the reference's float32 tolerance), the model's
``hidden``, forward ``loss``, ``prefill`` and teacher-forced
``decode_step`` at rtol 1e-4 / atol 1e-4 (the two frameworks sum the same
float32 products in other orders), and the reference's own checks
(stepwise vs chunked, decode vs ``hidden``) at its tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import rwkv as jax_rwkv
from repro.models.registry import count_params as jax_count

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import build_model, count_params, rwkv
from repro_torch.models.common import head_logits
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves_with_path

ARCH = "rwkv6-3b"
FN_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def block():
    """The reduced config, one block's weights from the reference (numpy)
    and the port's copy of them."""
    jp = jax.device_get(jax_rwkv.rwkv6_init(jax.random.key(2), jax_reduced(ARCH),
                                            jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return get_reduced(ARCH), jp, tp


def _jstate(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tstate(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _random_state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    h, n = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    return {"S": _np(rng, b, h, n, n), "last_x": _np(rng, b, cfg.d_model),
            "last_x_c": _np(rng, b, cfg.d_model)}


def _close(got, want, tol=FN_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the block's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Keys, shapes and dtypes; ``w0`` and ``u`` float32 in a bf16 block."""
    cfg = get_reduced(ARCH)
    want = jax.eval_shape(lambda k: jax_rwkv.rwkv6_init(k, jax_reduced(ARCH),
                                                        getattr(jnp, dtype)),
                          jax.random.key(0))
    got = rwkv.rwkv6_init(torch.Generator().manual_seed(0), cfg, getattr(torch, dtype))
    meta = rwkv.rwkv6_init(None, cfg, getattr(torch, dtype))
    assert set(got) == set(meta) == set(want)
    for k, w in want.items():
        for t in (got[k], meta[k]):
            assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == w.dtype.name, k
    assert got["w0"].dtype == got["u"].dtype == torch.float32


def test_time_mix_inputs_match_reference(block):
    cfg, jp, tp = block
    rng = np.random.default_rng(1)
    x, last = _np(rng, 2, 12, cfg.d_model), _np(rng, 2, cfg.d_model)
    want = jax_rwkv._time_mix_inputs(jp, jax_reduced(ARCH), jnp.asarray(x),
                                     jnp.asarray(last))
    got = rwkv._time_mix_inputs(tp, cfg, torch.from_numpy(x), torch.from_numpy(last))
    for name, g, w in zip("rkvgw", got, want):
        _close(g, w, msg=name)
    assert got[4].dtype == torch.float32


def test_wkv_matches_reference(block):
    cfg, jp, tp = block
    rng = np.random.default_rng(2)
    b, d, n = 3, cfg.d_model, cfg.rwkv_head_size
    r, k, v = (_np(rng, b, d) for _ in range(3))
    w = rng.uniform(0.2, 0.99, (b, d)).astype(np.float32)
    s = _np(rng, b, d // n, n, n)
    jy, js = jax_rwkv._wkv(*map(jnp.asarray, (r, k, v, w, jp["u"], s)), n)
    ty, ts = rwkv._wkv(*map(torch.from_numpy, (r, k, v, w, np.array(jp["u"]), s)), n)
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("fresh", [True, False], ids=["zero_state", "carried_state"])
def test_time_mix_matches_reference(block, fresh):
    cfg, jp, tp = block
    x = _np(np.random.default_rng(3), 2, 12, cfg.d_model)
    st = _random_state(cfg, 2, 4)
    if fresh:
        st = {k: np.zeros_like(v) for k, v in st.items()}
    st = {k: st[k] for k in ("S", "last_x")}
    jy, js = jax_rwkv.rwkv6_time_mix(jp, jax_reduced(ARCH), jnp.asarray(x), _jstate(st))
    ty, ts = rwkv.rwkv6_time_mix(tp, cfg, torch.from_numpy(x), _tstate(st))
    _close(ty, jy)
    for k in ("S", "last_x"):
        _close(ts[k], js[k], msg=k)


@pytest.mark.parametrize("chunk", [4, 8])
def test_time_mix_chunked_matches_reference(block, chunk):
    cfg, jp, tp = block
    x = _np(np.random.default_rng(5), 2, 32, cfg.d_model)
    st = {k: v for k, v in _random_state(cfg, 2, 6).items() if k != "last_x_c"}
    jy, js = jax_rwkv.rwkv6_time_mix_chunked(jp, jax_reduced(ARCH), jnp.asarray(x),
                                             _jstate(st), chunk=chunk)
    ty, ts = rwkv.rwkv6_time_mix_chunked(tp, cfg, torch.from_numpy(x), _tstate(st),
                                         chunk=chunk)
    _close(ty, jy)
    _close(ts["S"], js["S"])


def test_channel_mix_matches_reference(block):
    cfg, jp, tp = block
    rng = np.random.default_rng(7)
    x, last = _np(rng, 2, 12, cfg.d_model), _np(rng, 2, cfg.d_model)
    jy, js = jax_rwkv.rwkv6_channel_mix(jp, jax_reduced(ARCH), jnp.asarray(x),
                                        {"last_x_c": jnp.asarray(last)})
    ty, ts = rwkv.rwkv6_channel_mix(tp, cfg, torch.from_numpy(x),
                                    {"last_x_c": torch.from_numpy(last)})
    _close(ty, jy)
    _close(ts["last_x_c"], js["last_x_c"])


@pytest.mark.parametrize("chunk", [0, 8], ids=["stepwise", "chunked"])
def test_block_apply_matches_reference(block, chunk):
    """``rwkv_chunk`` picks the form: the chunked one when it divides S."""
    cfg, jp, tp = block
    rng = np.random.default_rng(8)
    x = _np(rng, 2, 16, cfg.d_model)
    n1, n2 = (rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32) for _ in range(2))
    st = _random_state(cfg, 2, 9)
    jy, js = jax_rwkv.rwkv6_block_apply(jp, jax_reduced(ARCH).replace(rwkv_chunk=chunk),
                                        jnp.asarray(x), _jstate(st), jnp.asarray(n1),
                                        jnp.asarray(n2))
    ty, ts = rwkv.rwkv6_block_apply(tp, cfg.replace(rwkv_chunk=chunk), torch.from_numpy(x),
                                    _tstate(st), torch.from_numpy(n1), torch.from_numpy(n2))
    _close(ty, jy)
    assert set(ts) == set(js) == {"S", "last_x", "last_x_c"}
    for k in js:
        _close(ts[k], js[k], msg=k)


# ---------------------------------------------------------------------------
# the reference's own checks (tests/test_ssm_rwkv.py), on the port
# ---------------------------------------------------------------------------

def test_scan_matches_stepwise(block):
    cfg, _, tp = block
    b, s = 2, 12
    x = torch.from_numpy(_np(np.random.default_rng(2), b, s, cfg.d_model))
    st0 = rwkv.rwkv6_init_state(cfg, b, torch.float32, "cpu")
    st0 = {k: st0[k] for k in ("S", "last_x")}
    full, st_full = rwkv.rwkv6_time_mix(tp, cfg, x, st0)
    st, outs = st0, []
    for t in range(s):
        y, st = rwkv.rwkv6_time_mix(tp, cfg, x[:, t:t + 1], st)
        outs.append(y)
    _close(torch.cat(outs, 1), full.numpy())
    _close(st["S"], st_full["S"].numpy())


def test_chunked_matches_scan(block):
    cfg, _, tp = block
    b = 2
    x = torch.from_numpy(_np(np.random.default_rng(5), b, 32, cfg.d_model))
    st0 = rwkv.rwkv6_init_state(cfg, b, torch.float32, "cpu")
    st0 = {k: st0[k] for k in ("S", "last_x")}
    want, st_w = rwkv.rwkv6_time_mix(tp, cfg, x, st0)
    got, st_g = rwkv.rwkv6_time_mix_chunked(tp, cfg, x, st0, chunk=8)
    _close(got, want.numpy())
    _close(st_g["S"], st_w["S"].numpy())
    want2, _ = rwkv.rwkv6_time_mix(tp, cfg, x, st_w)
    got2, _ = rwkv.rwkv6_time_mix_chunked(tp, cfg, x, st_g, chunk=8)
    _close(got2, want2.numpy())


def test_decay_is_data_dependent(block):
    cfg, _, tp = block
    x1 = torch.from_numpy(_np(np.random.default_rng(3), 1, 4, cfg.d_model, scale=1.0))
    last = torch.zeros((1, cfg.d_model))
    w1 = rwkv._time_mix_inputs(tp, cfg, x1, last)[4]
    w2 = rwkv._time_mix_inputs(tp, cfg, 2.0 * x1, last)[4]
    assert not torch.allclose(w1, w2)
    assert bool((w1 > 0).all() and (w1 < 1).all())


def test_chunked_sequence_must_divide(block):
    cfg, _, tp = block
    x = torch.zeros((1, 10, cfg.d_model))
    st = {"S": torch.zeros((1, cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size,
                            cfg.rwkv_head_size)), "last_x": torch.zeros((1, cfg.d_model))}
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv.rwkv6_time_mix_chunked(tp, cfg, x, st, chunk=4)


# ---------------------------------------------------------------------------
# the model (LM's SSM family)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0, 8], ids=["stepwise", "chunked"])
def pair(request):
    """(JAX model, its params as numpy, port model with them), at the
    config's stepwise scan and at ``rwkv_chunk`` 8."""
    jm = jax_build(jax_reduced(ARCH).replace(rwkv_chunk=request.param))
    tree = jax.device_get(jm.init(jax.random.key(3)))
    pm = build_model(get_reduced(ARCH).replace(rwkv_chunk=request.param),
                     device="cpu").load(params_from_jax(tree))
    return jm, tree, pm


def _tokens(vocab, shape, salt=0):
    return np.random.default_rng(17 + salt).integers(0, vocab, shape)


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
    """Logits and every layer's final state."""
    jm, tree, pm = pair
    toks = _tokens(pm.cfg.vocab, (2, 24), salt=2)
    jlogits, jcache = jax.jit(jm.prefill)(tree, jnp.asarray(toks, jnp.int32))
    logits, cache = pm.prefill(torch.from_numpy(toks))
    _close(logits, jlogits, TOL)
    assert set(cache["state"]) == set(jcache["state"]) == {"S", "last_x", "last_x_c"}
    for k, want in jcache["state"].items():
        _close(cache["state"][k], want, TOL, msg=k)
    assert cache["pos"] == 24 and cache["length"].tolist() == [24, 24]


def test_decode_steps_match_reference(pair):
    """12 teacher-forced steps, logits and the final states."""
    jm, tree, pm = pair
    toks = _tokens(pm.cfg.vocab, (2, 12), salt=3)
    decode = jax.jit(jm.decode_step)
    jcache, tcache = jm.init_cache(2, 16), pm.init_cache(2, 16)
    for t in range(12):
        jl, jcache = decode(tree, jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, tcache = pm.decode_step(tcache, torch.from_numpy(toks[:, t:t + 1]))
        assert tl.shape == (2, 1, pm.cfg.vocab) and tl.dtype == torch.float32
        _close(tl, jl, TOL, msg=f"step {t}")
    for k, want in jcache["state"].items():
        _close(tcache["state"][k], want, TOL, msg=k)
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


def test_decode_continues_from_prefill(pair):
    """``prefill``'s states carry on: decoding past the prompt gives the
    logits of the whole sequence's ``hidden``."""
    _, _, pm = pair
    toks = torch.from_numpy(_tokens(pm.cfg.vocab, (2, 16), salt=5))
    with torch.no_grad():
        want = head_logits(pm.hidden(toks), pm.head_matrix())
    logits, cache = pm.prefill(toks[:, :8])
    _close(logits, want[:, 7].numpy(), TOL)
    for t in range(8, 16):
        logits, cache = pm.decode_step(cache, toks[:, t:t + 1])
        _close(logits[:, 0], want[:, t].numpy(), TOL, msg=f"step {t}")


def test_param_tree_and_counts_match_reference():
    """The full config's tree and count (2,900,298,240) on meta tensors;
    ``w0`` and ``u`` float32 in its bf16 weights."""
    model = build_model(get_config(ARCH), device="cpu")
    jm = jax_build(jax_config(ARCH))
    assert count_params(model) == jax_count(jm) == 2_900_298_240
    want = jax.eval_shape(jm.init, jax.random.key(0))
    got = model.init_tree(None)
    flat = {path: t for path, t in tree_leaves_with_path(got)}
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(get_config(ARCH).n_layers):
                t = flat[("layers", i) + tuple(keys[1:])]
                assert (t.shape, str(t.dtype)[6:]) == (leaf.shape[1:], leaf.dtype.name)
        else:
            t = flat[tuple(keys)]
            assert (tuple(t.shape), str(t.dtype)[6:]) == (leaf.shape, leaf.dtype.name)
    assert len(flat) == 2 + 22 * get_config(ARCH).n_layers     # embed, final_norm (tied)


def test_load_keeps_float32_leaves():
    """A bf16 model loads a float32 tree with ``w0`` and ``u`` kept float32."""
    tree = build_model(get_reduced(ARCH), device="cpu").init(1).param_tree()
    pm = build_model(get_reduced(ARCH).replace(dtype="bfloat16"), device="cpu").load(tree)
    for path, t in tree_leaves_with_path(pm.param_tree()):
        assert t.dtype == (torch.float32 if path[-1] in ("w0", "u") else torch.bfloat16), path
    logits, cache = pm.prefill(torch.from_numpy(_tokens(512, (2, 8))))
    assert torch.isfinite(logits).all() and cache["state"]["S"].dtype == torch.float32


def test_serve_main_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen", "4", "--max-seq", "16"])
    assert res.tokens.shape == (2, 4) and torch.isfinite(res.logits).all()
    assert set(res.cache) == {"state", "length", "pos"} and res.cache["pos"] == 10
    assert "generated ids" in capsys.readouterr().out
