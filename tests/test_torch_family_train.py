"""Training the last three families (whisper-small, zamba2-2.7b, rwkv6-3b)
against the JAX package on the CPU, at their reduced configs.

Weights come from the reference's ``init`` (crossed with
``params_from_jax``), batches from the bigram pipeline and, for whisper,
the driver's frames (``data.step_frames``).  Each leaf of the port's
``loss`` gradient is held within 1e-4 of its max |grad| to
``jax.grad(model.loss)``, with and without remat; whisper's two
microbatches against one at the same tolerance.  At zamba2's own chunk
(``ssm_chunk`` 128, 256 tokens) the reference's chunked SSD has a NaN
gradient (its masked ``exp(lcum_i - lcum_j)`` overflows above the
diagonal, ``src/repro/models/ssm.py:91-93``), and so has its chunked WKV
under a steep decay: the port's are finite and held to the sequential
forms.  The driver's frames are the reference driver's draw bit for bit,
``launch.train.main`` trains each family (a resumed run bit-equal to an
uninterrupted one), and a bf16 step keeps every parameter and optimizer
leaf in the reference's dtype.  The three-step ``make_train_step`` runs
against the reference's are ``test_torch_train.py``'s ``STEP_CASES``.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import build_model as jax_build
from repro.models import rwkv as jax_rwkv
from repro.models import ssm as jax_ssm
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLM, step_frames
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, rwkv, ssm
from repro_torch.models.convert import LAYER_GROUPS, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_at, tree_leaves_with_path

ARCHS = ["whisper-small", "zamba2-2.7b", "rwkv6-3b"]
SEQ = 32                      # zamba2's reduced chunk (16) divides it
FN_TOL = dict(rtol=1e-4, atol=1e-5)


def _grads_close(got, want, what):
    """Within 1e-4 of the leaf's max |grad| (``test_torch_train.py``'s rule)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                               err_msg=what)


def _host_batch(cfg, seed, batch=2):
    return train.step_batch(cfg, SyntheticLM(cfg.vocab, SEQ, seed=seed), 0, batch)


def _port_grads(cfg, params, batch):
    """The port's loss and grads of one microbatch (``model.loss``'s)."""
    pm = build_model(cfg.replace(grad_accum=1), device="cpu").load(params_from_jax(params))
    loss, grads = make_train_step(pm, AdamWConfig()).loss_and_grad(
        train.to_device(batch, "cpu"))
    return float(loss), grads


def _reference_path(tree, path):
    """The reference's leaf (or its shape) at a port path: a stacked
    group's layer index dropped."""
    if path[0] in LAYER_GROUPS:
        return tree_at(tree[path[0]], path[2:])
    return tree_at(tree, path)


@pytest.fixture(scope="module", params=ARCHS)
def reference_grads(request):
    """(arch, the reference's weights, the batch, its loss and its
    ``jax.grad(model.loss)``), reduced config, float32."""
    arch = request.param
    jm = jax_build(jax_reduced(arch))
    params = jax.device_get(jm.init(jax.random.key(3)))
    batch = _host_batch(get_reduced(arch), seed=4)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return arch, params, batch, float(loss), jax.device_get(grads)


# --------------------------- the loss gradient -------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_grads_match_reference(reference_grads, remat):
    """Every leaf's gradient of the mean token NLL: whisper through both
    stacks and its tied head, zamba2's shared block summed over its
    applications, rwkv6 through the stepwise recurrence its config ships."""
    arch, params, batch, want_loss, want = reference_grads
    loss, got = _port_grads(get_reduced(arch).replace(remat=remat), params, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    want = params_from_jax(want)
    got_leaves, want_leaves = list(tree_leaves_with_path(got)), list(tree_leaves_with_path(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        _grads_close(g.numpy(), w.numpy(), f"{arch} {path}")


def test_remat_matches_no_remat(reference_grads):
    """The layers recomputed in the backward give the grads of the plain
    forward."""
    arch, params, batch, _, _ = reference_grads
    cfg = get_reduced(arch)
    plain_loss, plain = _port_grads(cfg, params, batch)
    remat_loss, remat = _port_grads(cfg.replace(remat=True), params, batch)
    assert remat_loss == plain_loss
    for (path, a), (_, b) in zip(tree_leaves_with_path(remat), tree_leaves_with_path(plain)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()), err_msg=str(path))


def test_whisper_grad_accum_matches_one_microbatch():
    """Two microbatches, the frames split with the tokens, sum to the
    grads of the whole batch (float32 accumulators)."""
    cfg = get_reduced("whisper-small")
    batch = train.to_device(_host_batch(cfg, seed=5, batch=4), "cpu")
    out = []
    for accum in (1, 2):
        pm = build_model(cfg.replace(grad_accum=accum), device="cpu").init(7)
        out.append(make_train_step(pm, AdamWConfig()).loss_and_grad(batch))
    np.testing.assert_allclose(float(out[1][0]), float(out[0][0]), rtol=1e-5)
    for (path, a), (_, b) in zip(tree_leaves_with_path(out[0][1]),
                                 tree_leaves_with_path(out[1][1])):
        assert b.dtype == torch.float32
        _grads_close(b.numpy(), a.numpy(), f"accum grad {path}")


# --------------------------- the masked exponents ------------------------------------

def test_ssd_grad_finite_at_chunk_128():
    """zamba2's ``ssm_chunk`` 128 over 256 tokens at the default init
    (``a_log`` 0): the reference's chunked gradient is NaN, the port's is
    finite and matches ``jax.grad`` of the reference's sequential oracle;
    the forward stays within the reference's tolerance of its chunked form."""
    cfg = get_reduced("zamba2-2.7b").replace(ssm_chunk=128)
    jcfg = jax_reduced("zamba2-2.7b").replace(ssm_chunk=128)
    jp = jax.device_get(jax_ssm.mamba2_init(jax.random.key(0), jcfg, jnp.float32))
    x = (np.random.default_rng(8).standard_normal((2, 256, cfg.d_model)) * 0.5
         ).astype(np.float32)

    def jax_loss(fn):
        return jax.grad(lambda p, x: jnp.sum(jnp.sin(fn(p, jcfg, x))), argnums=(0, 1))(
            jp, jnp.asarray(x))

    chunked = jax_loss(jax_ssm.mamba2_apply)
    nans = {k: int(np.isnan(np.asarray(v)).sum()) for k, v in chunked[0].items()}
    assert nans == {"a_log": 8, "bc_proj": 2048, "conv_w": 0, "d_skip": 0, "dt_bias": 8,
                    "dt_proj": 512, "in_proj": 0, "out_proj": 0}, nans
    oracle_p, oracle_x = jax_loss(jax_ssm.mamba2_scan_ref)

    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = ssm.mamba2_apply(tp, cfg, tx)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax_ssm.mamba2_apply(jp, jcfg, jnp.asarray(x))),
                               **FN_TOL)
    got = torch.autograd.grad(torch.sin(y).sum(), list(tp.values()) + [tx])
    for (k, _), g in zip(tp.items(), got):
        _grads_close(g.numpy(), oracle_p[k], k)
    _grads_close(got[-1].numpy(), oracle_x, "x")


def test_chunked_wkv_grad_finite_under_steep_decay():
    """rwkv6's chunked form with w0 = 2.5 (a log decay of about -12 a
    step, so the unmasked exponents of a 16-token chunk reach ~+180, past
    float32's exp): the reference's chunked gradient is NaN, the port's is
    finite and matches the stepwise form's, values and state too."""
    cfg, jcfg = get_reduced("rwkv6-3b"), jax_reduced("rwkv6-3b")
    chunk = 16
    jp = dict(jax.device_get(jax_rwkv.rwkv6_init(jax.random.key(0), jcfg, jnp.float32)))
    jp["w0"] = np.full_like(np.asarray(jp["w0"]), 2.5)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 2 * chunk, cfg.d_model)).astype(np.float32)
    n = cfg.rwkv_head_size
    st = {"S": (rng.standard_normal((2, cfg.d_model // n, n, n)) * 0.3).astype(np.float32),
          "last_x": rng.standard_normal((2, cfg.d_model)).astype(np.float32)}
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jp.items()}
    with torch.no_grad():
        *_, w = rwkv._time_mix_inputs(tp, cfg, torch.from_numpy(x),
                                      torch.from_numpy(st["last_x"]))
        steepest = -torch.log(w).reshape(2, 2, chunk, -1)[:, :, 1:].sum(2).max()
    assert steepest > 88.73        # log(float32 max): exp of the unmasked exponent is inf

    def jax_loss(p):
        y, s = jax_rwkv.rwkv6_time_mix_chunked(p, jcfg, jnp.asarray(x),
                                               {k: jnp.asarray(v) for k, v in st.items()},
                                               chunk=chunk)
        return jnp.sum(jnp.sin(y)) + jnp.sum(s["S"])

    assert any(np.isnan(np.asarray(g)).any() for g in jax.grad(jax_loss)(jp).values())

    def port(fn):
        y, s = fn(tp, cfg, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in st.items()})
        grads = torch.autograd.grad(torch.sin(y).sum() + s["S"].sum(), list(tp.values()),
                                    allow_unused=True)
        return y.detach(), s["S"].detach(), grads

    y, s, got = port(lambda *a: rwkv.rwkv6_time_mix_chunked(*a, chunk=chunk))
    y_ref, s_ref, want = port(rwkv.rwkv6_time_mix)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **FN_TOL)
    np.testing.assert_allclose(s.numpy(), s_ref.numpy(), **FN_TOL)
    for k, g, w in zip(tp, got, want):
        assert (g is None) == (w is None), k      # the channel mix is not on this path
        if w is not None:
            _grads_close(g.numpy(), w.numpy(), k)


# --------------------------- the driver ----------------------------------------------

@pytest.mark.parametrize("step", [0, 7])
def test_frames_equal_reference_driver_draw(step):
    """``step_frames`` is ``repro/launch/train.py``'s per-step draw bit for
    bit, and the batch reaches the device as float32 frames beside int64
    tokens."""
    cfg = get_reduced("whisper-small")
    shape = (3, cfg.encoder_seq, cfg.d_model)
    want = np.asarray(jnp.asarray(np.random.default_rng(step).standard_normal(shape),
                                  jnp.float32))
    got = step_frames(step, *shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    batch = train.to_device(train.step_batch(cfg, SyntheticLM(cfg.vocab, SEQ), step, 3),
                            "cpu")
    assert batch["frames"].dtype == torch.float32
    assert batch["tokens"].dtype == batch["labels"].dtype == torch.int64
    np.testing.assert_array_equal(batch["frames"].numpy().view(np.uint32), got.view(np.uint32))
    assert "frames" not in train.step_batch(get_reduced("rwkv6-3b"),
                                            SyntheticLM(cfg.vocab, SEQ), step, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_and_resume_is_bit_equal(arch, tmp_path):
    args = ["--arch", arch, "--device", "cpu", "--steps", "8", "--batch", "4",
            "--seq", str(SEQ), "--lr", "3e-3", "--ckpt-every", "4", "--log-every", "4"]
    run = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(run.losses) == 8 and np.isfinite(run.losses).all()
    assert np.isfinite(run.grad_norms).all() and run.opt_state["step"] == 8
    assert type(run.model).__name__ == {"whisper-small": "WhisperModel",
                                        "zamba2-2.7b": "ZambaModel"}.get(arch, "LM")
    # the run stopped after step 4's checkpoint, then resumed from it
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_00000008")
    try:
        resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
        assert resumed.start_step == 4 and resumed.losses == run.losses[4:]
    except SystemExit as e:      # the end rule over 4 losses; the save came first
        assert "loss did not decrease" in str(e)
    whole, extra_a = load_checkpoint(str(tmp_path / "a"))
    again, extra_b = load_checkpoint(str(tmp_path / "b"))
    assert extra_a == extra_b == {"step": 8} and set(whole) == set(again)
    for name in whole:
        np.testing.assert_array_equal(np.asarray(again[name]), np.asarray(whole[name]),
                                      err_msg=name)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_keeps_reference_dtypes(arch, state_dtype):
    """A bf16 model's step: each parameter, moment and master leaf in the
    dtype of the reference's after its step (rwkv6's ``w0`` / ``u`` and
    Mamba2's ``dt_bias`` / ``a_log`` / ``d_skip`` float32 beside bf16)."""
    over = dict(dtype="bfloat16", opt_state_dtype=state_dtype, grad_accum=1)
    cfg = get_reduced(arch).replace(**over)
    jm = jax_build(jax_reduced(arch).replace(**over))
    jopt = JaxAdamWConfig(state_dtype=state_dtype)
    batch = _host_batch(cfg, seed=6)
    pshape = jax.eval_shape(jm.init, jax.random.key(0))
    _, want_p, want_s = jax.eval_shape(
        jax_train_step(jm, jopt), pshape, jax.eval_shape(lambda p: jax_adamw_init(p, jopt),
                                                         pshape),
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    pm = build_model(cfg, device="cpu").init(0)
    state = adamw_init(pm.param_tree(), AdamWConfig(state_dtype=state_dtype))
    loss, gnorm = make_train_step(pm, AdamWConfig(state_dtype=state_dtype))(
        state, train.to_device(batch, "cpu"))
    assert np.isfinite(float(loss)) and torch.isfinite(gnorm)
    assert set(state) == set(want_s) and state["step"] == 1
    got = [("params", pm.param_tree(), want_p)] + \
        [(key, state[key], want_s[key]) for key in ("m", "v", "master")]
    dtypes = set()
    for key, tree, want in got:
        leaves = list(tree_leaves_with_path(tree))
        stacked = {(p[0],) + p[2:] if p[0] in LAYER_GROUPS else p for p, _ in leaves}
        assert len(stacked) == len(jax.tree.leaves(want)), key
        for path, t in leaves:
            w = _reference_path(want, path)
            assert str(t.dtype)[6:] == w.dtype.name, (key, path, t.dtype, w.dtype)
            dtypes.add(w.dtype.name)
    assert {"bfloat16", "float32"} <= dtypes
