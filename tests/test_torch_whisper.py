"""The port's whisper encoder-decoder (``models/whisper.py``) against the
JAX package's on the CPU.

Weights come from the reference's ``init`` (the whole model's, crossed
through ``params_from_jax``); tokens and frame embeddings from seeded
numpy generators.  ``sinusoidal`` and the cross-attention functions are
held at rtol 1e-4 / atol 1e-5 (the reference's float32 tolerance), the
model's ``encode``, ``hidden``, forward ``loss``, ``prefill`` and
teacher-forced ``decode_step`` at rtol 1e-4 / atol 1e-4.  The reference's
decode cache takes ``xk`` / ``xv`` from its own ``prefill``, the port's
from ``cross_cache``; the logits after the prompt are also held against
the reference's ``prefill(tokens, frames)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import whisper as jax_whisper
from repro.models.registry import count_params as jax_count

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import build_model, count_params, whisper
from repro_torch.models.common import head_logits
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves_with_path

ARCH = "whisper-small"
FN_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, GEN, MAX_SEQ = 2, 8, 8, 24


def _close(got, want, tol=FN_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=msg)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params as numpy, port model with them)."""
    jm = jax_build(jax_reduced(ARCH))
    tree = jax.device_get(jm.init(jax.random.key(7)))
    pm = build_model(get_reduced(ARCH), device="cpu").load(params_from_jax(tree))
    return jm, tree, pm


def _tokens(vocab, shape, salt=0):
    return np.random.default_rng(29 + salt).integers(0, vocab, shape)


def _frames(cfg, b=B, salt=0):
    return np.random.default_rng(31 + salt).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 64, 768])
def test_sinusoidal_matches_reference(d):
    pos = np.arange(64)
    _close(whisper.sinusoidal(torch.from_numpy(pos), d),
           jax_whisper.sinusoidal(jnp.asarray(pos), d))
    lens = np.array([[0], [7], [40]])
    _close(whisper.sinusoidal(torch.from_numpy(lens), d),
           jax_whisper.sinusoidal(jnp.asarray(lens), d))


@pytest.fixture(scope="module")
def xattn(pair):
    """Layer 0's cross-attention weights (numpy, and the port's copy)."""
    _, tree, _ = pair
    jp = {k: np.asarray(v[0]) for k, v in tree["dec_layers"]["xattn"].items()}
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_xattn_init_matches_reference():
    cfg = get_reduced(ARCH)
    want = jax.eval_shape(lambda k: jax_whisper._xattn_init(k, jax_reduced(ARCH),
                                                            jnp.bfloat16),
                          jax.random.key(0))
    for gen in (torch.Generator().manual_seed(0), None):
        got = whisper._xattn_init(gen, cfg, torch.bfloat16)
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
            {k: (w.shape, torch.bfloat16) for k, w in want.items()}


def test_xattn_kv_and_apply_match_reference(xattn):
    jp, tp = xattn
    cfg, jcfg = get_reduced(ARCH), jax_reduced(ARCH)
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    jk, jv = jax_whisper._xattn_kv(jp, jcfg, jnp.asarray(enc))
    tk, tv = whisper._xattn_kv(tp, cfg, torch.from_numpy(enc))
    _close(tk, jk)
    _close(tv, jv)
    want = jax_whisper._xattn_apply(jp, jcfg, jnp.asarray(x), jk, jv)
    _close(whisper._xattn_apply(tp, cfg, torch.from_numpy(x), tk, tv), want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_encode_matches_reference(pair):
    jm, tree, pm = pair
    fr = _frames(pm.cfg)
    with torch.no_grad():
        got = pm.encode(torch.from_numpy(fr))
    _close(got, jm.encode(tree, jnp.asarray(fr)), TOL)


def test_hidden_and_loss_match_reference(pair):
    jm, tree, pm = pair
    toks = _tokens(pm.cfg.vocab, (B, 32))
    labels = _tokens(pm.cfg.vocab, (B, 32), salt=1)
    labels[:, :3] = -1
    fr = _frames(pm.cfg, salt=1)
    enc = jm.encode(tree, jnp.asarray(fr))
    want = jm.hidden(tree, jnp.asarray(toks, jnp.int32), enc)
    with torch.no_grad():
        got = pm.hidden(torch.from_numpy(toks), torch.from_numpy(np.array(enc)))
    _close(got, want, TOL)
    jl = float(jm.loss(tree, {"tokens": jnp.asarray(toks, jnp.int32),
                              "labels": jnp.asarray(labels, jnp.int32),
                              "frames": jnp.asarray(fr)}))
    tl = pm.loss({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
                  "frames": torch.from_numpy(fr)})
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), jl, **TOL)


def test_prefill_matches_reference(pair):
    """Logits and every cache leaf; ``cross_cache`` gives its xk / xv."""
    jm, tree, pm = pair
    toks, fr = _tokens(pm.cfg.vocab, (B, 24), salt=2), _frames(pm.cfg, salt=2)
    jlogits, jcache = jax.jit(jm.prefill)(tree, jnp.asarray(toks, jnp.int32),
                                          jnp.asarray(fr))
    logits, cache = pm.prefill(torch.from_numpy(toks), torch.from_numpy(fr))
    _close(logits, jlogits, TOL)
    for name in ("k", "v"):
        _close(cache["layers"][name], jcache["layers"][name], TOL, msg=name)
    cross = pm.cross_cache(torch.from_numpy(fr))
    for name in ("xk", "xv"):
        _close(cache[name], jcache[name], TOL, msg=name)
        assert torch.equal(cross[name], cache[name])
    assert cache["pos"] == 24 and cache["length"].tolist() == [24, 24]


@pytest.fixture(scope="module")
def decoded(pair):
    """PROMPT teacher-forced and GEN greedy steps through both models:
    the reference's cache takes xk / xv from its own ``prefill``, the
    port's from ``cross_cache``.  Returns the logits of both, the greedy
    ids, the final caches and the inputs."""
    jm, tree, pm = pair
    prompts, fr = _tokens(pm.cfg.vocab, (B, PROMPT), salt=3), _frames(pm.cfg, salt=3)
    _, jpre = jax.jit(jm.prefill)(tree, jnp.asarray(prompts, jnp.int32), jnp.asarray(fr))
    jcache = jm.init_cache(B, MAX_SEQ)
    jcache.update(xk=jpre["xk"], xv=jpre["xv"])
    tcache = pm.init_cache(B, MAX_SEQ)
    tcache.update(pm.cross_cache(torch.from_numpy(fr)))
    decode = jax.jit(jm.decode_step)
    jl_all, tl_all, ids = [], [], []
    for t in range(PROMPT + GEN):
        if t < PROMPT:
            tok = prompts[:, t:t + 1]
        else:
            tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
            ids.append(tok[:, 0])
        jl, jcache = decode(tree, jcache, jnp.asarray(tok, jnp.int32))
        tl, tcache = pm.decode_step(tcache, torch.from_numpy(tok))
        jl_all.append(np.asarray(jl))
        tl_all.append(tl)
    return dict(jl=jl_all, tl=tl_all, ids=np.stack(ids, 1), jcache=jcache,
                tcache=tcache, prompts=prompts, frames=fr)


def test_decode_steps_match_reference(decoded):
    for t, (tl, jl) in enumerate(zip(decoded["tl"], decoded["jl"])):
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        _close(tl, jl, TOL, msg=f"step {t}")
        if t >= PROMPT:
            np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                          decoded["ids"][:, t - PROMPT])
    jc, tc = decoded["jcache"], decoded["tcache"]
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name], TOL, msg=name)
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    assert tc["pos"] == PROMPT + GEN


def test_prompt_logits_match_reference_prefill(pair, decoded):
    """The teacher-forced prompt's last logits against the reference's
    ``prefill(tokens, frames)``."""
    jm, tree, _ = pair
    jlogits, _ = jax.jit(jm.prefill)(tree, jnp.asarray(decoded["prompts"], jnp.int32),
                                     jnp.asarray(decoded["frames"]))
    _close(decoded["tl"][PROMPT - 1][:, 0], jlogits, TOL)


def test_generate_matches_the_steps(pair, decoded):
    """``serve.generate(frames=)`` gives the same greedy ids and logits."""
    _, _, pm = pair
    res = serve.generate(pm, decoded["prompts"], GEN, MAX_SEQ, frames=decoded["frames"])
    np.testing.assert_array_equal(res.tokens.numpy(), decoded["ids"])
    _close(res.prompt_logits, decoded["tl"][PROMPT - 1].numpy(), dict(rtol=0, atol=0))
    assert len(res.step_ms) == GEN and res.cache["pos"] == PROMPT + GEN


def test_generate_without_frames_keeps_zero_cross_caches(pair):
    _, _, pm = pair
    res = serve.generate(pm, _tokens(pm.cfg.vocab, (B, 4), salt=6), 2, 8)
    assert not res.cache["xk"].any() and not res.cache["xv"].any()
    assert torch.isfinite(res.logits).all()


def test_decode_matches_hidden(pair):
    """Teacher-forced decode reproduces ``hidden`` over the encoder output
    (the reference's decode-vs-prefill tolerance)."""
    _, _, pm = pair
    toks = torch.from_numpy(_tokens(pm.cfg.vocab, (1, 8), salt=4))
    fr = torch.from_numpy(_frames(pm.cfg, b=1, salt=4))
    with torch.no_grad():
        want = head_logits(pm.hidden(toks, pm.encode(fr)), pm.head_matrix())
    cache, got = pm.init_cache(1, 8), []
    cache.update(pm.cross_cache(fr))
    for t in range(8):
        logits, cache = pm.decode_step(cache, toks[:, t:t + 1])
        got.append(logits[:, 0])
    _close(torch.stack(got, 1), want.numpy(), dict(rtol=2e-2, atol=2e-3))


def test_decode_reaches_the_kernel_wrapper(pair, monkeypatch):
    """Each decoder layer calls ``decode_attention_grouped`` twice a step:
    its self-attention (``gqa_decode``) and its cross-attention over the
    ``encoder_seq`` rows, with the cross caches read in place."""
    _, _, pm = pair
    from repro_torch.models import attention
    calls = []

    def spy(q, k, v, lengths, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), lengths.tolist()))
        return orig(q, k, v, lengths, **kw)

    orig = whisper.decode_attention_grouped
    monkeypatch.setattr(whisper, "decode_attention_grouped", spy)
    monkeypatch.setattr(attention, "decode_attention_grouped", spy)
    cache = pm.init_cache(B, 4)
    pm.decode_step(cache, torch.zeros((B, 1), dtype=torch.int64))
    cfg = pm.cfg
    g = cfg.n_heads // cfg.n_kv_heads
    want_x = ((B, cfg.n_kv_heads, g, cfg.head_dim),
              (B, cfg.n_kv_heads, cfg.encoder_seq, cfg.head_dim), [cfg.encoder_seq] * B)
    assert calls[1::2] == [want_x] * cfg.n_layers
    assert [c[1][2] for c in calls[0::2]] == [4] * cfg.n_layers


def test_param_tree_and_counts_match_reference():
    """The full config's tree and count (294,683,904) on meta tensors."""
    model = build_model(get_config(ARCH), device="cpu")
    jm = jax_build(jax_config(ARCH))
    assert count_params(model) == jax_count(jm) == 294_683_904
    flat = dict(tree_leaves_with_path(model.init_tree(None)))
    cfg = get_config(ARCH)
    n = {"enc_layers": cfg.encoder_layers, "dec_layers": cfg.n_layers}
    want = jax.eval_shape(jm.init, jax.random.key(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = tuple(p.key for p in path)
        if keys[0] in n:
            got = [flat[(keys[0], i) + keys[1:]] for i in range(n[keys[0]])]
            shape = leaf.shape[1:]
        else:
            got, shape = [flat[keys]], leaf.shape
        for t in got:
            assert (tuple(t.shape), str(t.dtype)[6:]) == (shape, leaf.dtype.name), keys
    # an encoder layer 9 leaves, a decoder layer 14; embed, enc_norm, final_norm
    assert len(flat) == 3 + 9 * cfg.encoder_layers + 14 * cfg.n_layers


def test_serve_main_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen", "4", "--max-seq", "16"])
    assert res.tokens.shape == (2, 4) and torch.isfinite(res.logits).all()
    assert set(res.cache) == {"layers", "xk", "xv", "length", "pos"}
    assert res.cache["xk"].abs().sum() > 0 and res.cache["pos"] == 10
    assert "generated ids" in capsys.readouterr().out


def test_frames_need_an_encoder():
    lm = build_model(get_reduced("gemma2-2b"), device="cpu").init(0)
    with pytest.raises(ValueError, match="no encoder"):
        serve.generate(lm, np.zeros((1, 2), np.int64), 1, 4, frames=np.zeros((1, 3, 4)))
