"""rwkv6's chunked WKV (``rwkv6_time_mix_chunked``, ``rwkv_chunk`` > 0)
under a steep decay, against the stepwise recurrence and the JAX
package's forms on the CPU.

The decay is w = exp(-exp(w0 + LoRA)).  Once exp(w0 + LoRA) passes ~104,
w is 0 in float32; the reference's chunked form takes ``log(w)`` of it
(``src/repro/models/rwkv.py:126``), gets -inf and a gradient that is NaN
in every element.  The port's takes the log decay whole, -exp(w0 + LoRA),
and its gradient stays finite and equal to the stepwise form's.  Layout:
the reduced config, float32, B 2, S 32, chunk 8, one block's weights from
the reference's ``rwkv6_init`` with ``w0`` filled, loss sum(y^2) + sum(S).

Gradients are held per leaf within 1e-5 of the leaf's max |grad| (two
float32 summation orders of the same products)
and, against the reference, differences below float32's smallest normal
number (2^-126) are not counted: at w0 = 4.7 the decay leaves' gradients
(``w0``, ``w_lora_a``, ``w_lora_b``, ``mix_w``) are carried by subnormal
decays alone, which XLA's CPU backend flushes to zero and PyTorch keeps.
Below the fault the port's chunked form meets the reference's chunked
form at its tolerance (rtol 1e-4 / atol 1e-5, the gradient's atol 1e-5 of
the leaf's max |grad|): the forward up to w0 = 3, the gradient up to
w0 = 1 (from w0 ~ 3 on the reference's gradient is NaN already, by exp of
a difference of running sums above the diagonal, and from w0 ~ 4.5 its
forward too: XLA flushes the subnormal w to 0 before the log).
Last, the model's train step at ``rwkv_chunk`` 8 in the fault's regime
against the stepwise form's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import rwkv as jax_rwkv

from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, rwkv
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves_with_path

ARCH = "rwkv6-3b"
CHUNK = 8
FN_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_GATE = 1e-5                              # of each leaf's max |grad|
NORMAL = float(np.finfo(np.float32).tiny)     # 2^-126
# the time mix's weights (the channel mix is not on this path)
TIME_MIX = ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "wr", "wk", "wv", "wg", "wo",
            "w0", "w_lora_a", "w_lora_b", "u", "ln_x")


def _weights(w0):
    """One block's time-mix weights from the reference's init, ``w0`` filled."""
    jp = jax.device_get(jax_rwkv.rwkv6_init(jax.random.key(0), jax_reduced(ARCH),
                                            jnp.float32))
    out = {k: np.array(jp[k]) for k in TIME_MIX}
    out["w0"] = np.full_like(out["w0"], w0)
    return out


def _inputs(cfg):
    """x [2, 32, d] from a seed and a zero state."""
    x = np.random.default_rng(11).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    n = cfg.rwkv_head_size
    st = {"S": np.zeros((2, cfg.d_model // n, n, n), np.float32),
          "last_x": np.zeros((2, cfg.d_model), np.float32)}
    return x, st


def _reference(w0, chunked):
    """The reference's y and S, and ``jax.grad`` of the loss by leaf (``x`` too)."""
    cfg = jax_reduced(ARCH)
    jp = _weights(w0)
    x, st = _inputs(cfg)
    fn = (functools.partial(jax_rwkv.rwkv6_time_mix_chunked, chunk=CHUNK) if chunked
          else jax_rwkv.rwkv6_time_mix)

    def loss(p, x):
        y, s = fn(p, cfg, x, {k: jnp.asarray(v) for k, v in st.items()})
        return jnp.sum(y ** 2) + jnp.sum(s["S"])

    y, s = fn(jp, cfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads["x"] = np.asarray(gx)
    return np.asarray(y), np.asarray(s["S"]), grads


def _port(w0, chunked):
    """The port's y and S, and the loss's gradient by leaf (``x`` too)."""
    cfg = get_reduced(ARCH)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in _weights(w0).items()}
    x, st = _inputs(cfg)
    tx = torch.from_numpy(x).requires_grad_()
    st = {k: torch.from_numpy(v) for k, v in st.items()}
    if chunked:
        y, s = rwkv.rwkv6_time_mix_chunked(tp, cfg, tx, st, chunk=CHUNK)
    else:
        y, s = rwkv.rwkv6_time_mix(tp, cfg, tx, st)
    got = torch.autograd.grad((y ** 2).sum() + s["S"].sum(), list(tp.values()) + [tx])
    grads = {k: g.numpy() for k, g in zip(list(tp) + ["x"], got)}
    return y.detach().numpy(), s["S"].detach().numpy(), grads


def _grads_within(got, want, floor=0.0):
    """Every leaf finite and within GRAD_GATE of its max |want| (or ``floor``)."""
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        atol = max(GRAD_GATE * float(np.abs(w).max()), floor)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# the log of an underflowed decay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w0", [4.7, 5.0])
def test_chunked_grad_finite_where_decay_underflows(w0):
    """w = exp(-exp(w0 + LoRA)) is 0 in float32 here: the port's chunked
    gradient is finite in every leaf and equals the stepwise form's, the
    port's and the reference's; the reference's chunked gradient is NaN in
    every element of every leaf (the shared fault, repaired in the port)."""
    y, s, got = _port(w0, chunked=True)
    y_step, s_step, want = _port(w0, chunked=False)
    _grads_within(got, want)
    np.testing.assert_allclose(y, y_step, **FN_TOL)
    np.testing.assert_allclose(s, s_step, **FN_TOL)
    _, _, ref = _reference(w0, chunked=False)
    _grads_within(got, ref, floor=NORMAL)
    _, _, ref_chunked = _reference(w0, chunked=True)
    assert all(np.isnan(g).all() for g in ref_chunked.values())


def test_rates_give_the_decay_and_its_log():
    """``_time_mix_inputs``' w is exp(-rate) of ``_time_mix_rates``; at
    w0 = 4.7 every w is below float32's normal range and most are 0, while
    the chunked form's log decay -rate stays finite."""
    cfg = get_reduced(ARCH)
    tp = {k: torch.from_numpy(v) for k, v in _weights(4.7).items()}
    x, st = _inputs(cfg)
    x, last = torch.from_numpy(x), torch.from_numpy(st["last_x"])
    *rkvg, rate = rwkv._time_mix_rates(tp, x, last)
    *rkvg_w, w = rwkv._time_mix_inputs(tp, cfg, x, last)
    for a, b in zip(rkvg, rkvg_w):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(w, torch.exp(-rate), rtol=0, atol=0)
    assert rate.dtype == torch.float32
    assert bool((w < NORMAL).all()) and float((w == 0).float().mean()) > 0.5
    assert bool(torch.isfinite(-rate).all())


# ---------------------------------------------------------------------------
# below the fault: the reference's chunked form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w0", [-2.0, 1.0, 3.0])
def test_chunked_forward_matches_reference_chunked(w0):
    y, s, _ = _port(w0, chunked=True)
    y_ref, s_ref, _ = _reference(w0, chunked=True)
    np.testing.assert_allclose(y, y_ref, **FN_TOL)
    np.testing.assert_allclose(s, s_ref, **FN_TOL)


@pytest.mark.parametrize("w0", [-2.0, 1.0])
def test_chunked_grad_matches_reference_chunked(w0):
    """FN_TOL with its atol scaled to the leaf: 1e-5 of its max |grad|
    (gradients reach ~80 here, where an atol of 1e-5 is a few float32
    roundings of the sums' terms)."""
    _, _, got = _port(w0, chunked=True)
    _, _, want = _reference(w0, chunked=True)
    for k, w in want.items():
        atol = max(FN_TOL["atol"], GRAD_GATE * float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, rtol=FN_TOL["rtol"], atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# the model's train step at rwkv_chunk 8 in the fault's regime
# ---------------------------------------------------------------------------

STEPS, LR = 2, 1e-3


def _filled_tree(w0):
    """The reduced model's weights from the seed, every layer's ``w0`` filled."""
    tree = build_model(get_reduced(ARCH), device="cpu").init(3).param_tree()
    with torch.no_grad():
        for layer in tree["layers"]:
            layer["block"]["w0"].fill_(w0)
    return tree


def _train(tree, chunk):
    """``STEPS`` make_train_step steps of 4 x 32 bigram tokens: the losses,
    grad norms and the parameters after each step (copies)."""
    cfg = get_reduced(ARCH).replace(rwkv_chunk=chunk, grad_accum=1)
    model = build_model(cfg, device="cpu").load(tree)
    opt = AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS)
    step = make_train_step(model, opt)
    state = adamw_init(model.param_tree(), opt)
    ds = SyntheticLM(cfg.vocab, 32, seed=4)
    losses, norms, params = [], [], []
    for i in range(STEPS):
        loss, gnorm = step(state, train.to_device(train.step_batch(cfg, ds, i, 4), "cpu"))
        losses.append(float(loss))
        norms.append(float(gnorm))
        params.append({p: t.detach().clone() for p, t in tree_leaves_with_path(
            model.param_tree())})
    return losses, norms, params


def test_train_step_chunked_in_fault_regime():
    """The reduced model with every ``w0`` at 4.7 (every decay 0 in
    float32): two steps at ``rwkv_chunk`` 8 give finite losses and grad
    norms, the losses within rtol 1e-4 of the stepwise form's, and the
    parameters after step 1 as ``test_torch_train.py`` holds them: within
    2 lr of the stepwise form's and 99% within 1e-6 of max |p|."""
    tree = _filled_tree(4.7)
    losses, norms, params = _train(tree, CHUNK)
    want_losses, want_norms, want = _train(tree, 0)
    assert np.isfinite(losses).all() and np.isfinite(norms).all(), (losses, norms)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-4)
    scale = max(float(t.abs().max()) for t in want[0].values())
    for path, w in want[0].items():
        diff = (params[0][path] - w).abs()
        assert float(diff.max()) <= 2 * LR, (path, float(diff.max()))
        assert float((diff <= 1e-6 * scale).float().mean()) >= 0.99, path
