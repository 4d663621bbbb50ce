"""The port's train step and training driver against the JAX package's on
the CPU.  Three ``make_train_step`` steps (gemma2-2b at grad_accum 1 and
2, the reduced MoE LMs through their local oracle at 1, whisper-small
over the driver's frames, zamba2-2.7b and rwkv6-3b at 1; float32 and int8
moments) start from the reference's state after two of its steps,
converted by ``opt_state_from_jax``: losses rtol 1e-4, parameters within
``2 lr steps`` (AdamW moves an element by about +-lr wherever its gradient
sits at round-off level) and at least 99% of them within 1e-6 of max |p|.
Two microbatches against one: grads within 1e-4 of max |grad|.  The
driver runs on the CPU, and a run resumed from its checkpoint is
bit-equal to the uninterrupted one.  Parameter counts of every ported
full config equal the reference's, with no allocation.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import build_model as jax_build
from repro.models.registry import count_active_params as jax_active
from repro.models.registry import count_params as jax_count
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import (build_model, count_active_params, count_params,
                                param_shapes)
from repro_torch.models.convert import (LAYER_GROUPS, opt_state_from_jax,
                                        params_from_jax)
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_at, tree_leaves_with_path

FULL = ["gemma2-2b", "gemma2-9b", "gemma2-27b", "llama3-405b", "chameleon-34b"]


def _grads_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                               err_msg=what)


def _stacked(tree_j, path):
    if path[0] in LAYER_GROUPS:
        return np.asarray(tree_at(tree_j[path[0]], path[2:])[path[1]])
    return np.asarray(tree_at(tree_j, path))


# --------------------------- the train step -----------------------------------------

TRAIN_STEPS, WARM_STEPS, LR = 3, 2, 3e-3
STEP_CASES = [pytest.param("gemma2-2b", accum, dtype, id=f"{accum}-{dtype}")
              for accum in (1, 2) for dtype in ("float32", "int8")] + \
    [pytest.param(arch, 1, dtype, id=f"{arch}-1-{dtype}")
     for arch in ("qwen3-moe-235b-a22b", "deepseek-v2-236b", "whisper-small",
                  "zamba2-2.7b", "rwkv6-3b")
     for dtype in ("float32", "int8")]
# the last three families take 32 tokens (zamba2's chunked SSD needs a
# sequence its chunk, 16, divides)
STEP_SEQ = {"whisper-small": 32, "zamba2-2.7b": 32, "rwkv6-3b": 32}


@pytest.mark.parametrize("arch,accum,state_dtype", STEP_CASES)
def test_train_steps_match_reference(arch, accum, state_dtype):
    over = dict(grad_accum=accum, opt_state_dtype=state_dtype)
    cfg = get_reduced(arch).replace(**over)
    jm = jax_build(jax_reduced(arch).replace(**over))
    kw = dict(lr=LR, warmup_steps=1, total_steps=10, state_dtype=state_dtype)
    jcfg = JaxAdamWConfig(**kw)
    step = jax.jit(jax_train_step(jm, jcfg))
    params = jm.init(jax.random.key(5))
    state = jax_adamw_init(params, jcfg)
    ds = JaxSyntheticLM(jm.cfg.vocab, STEP_SEQ.get(arch, 40), seed=2)
    for s in range(WARM_STEPS):      # a state with moments in it
        _, params, state = step(params, state, {k: jnp.asarray(v) for k, v in
                                                train.step_batch(cfg, ds, s, 4).items()})
    params, state = jax.device_get(params), jax.device_get(state)
    pm = build_model(cfg, device="cpu").load(params_from_jax(params))
    opt_state = opt_state_from_jax(state)
    pstep = make_train_step(pm, AdamWConfig(**kw))
    for s in range(WARM_STEPS, WARM_STEPS + TRAIN_STEPS):
        batch = train.step_batch(cfg, ds, s, 4)
        want, params, state = step(params, state, {k: jnp.asarray(v)
                                                   for k, v in batch.items()})
        loss, gnorm = pstep(opt_state, train.to_device(batch, "cpu"))
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
        assert torch.isfinite(gnorm)
    assert opt_state["step"] == int(state["step"]) == WARM_STEPS + TRAIN_STEPS
    scale = max(float(np.abs(np.asarray(x)).max()) for x in jax.tree.leaves(params))
    for path, p in tree_leaves_with_path(pm.param_tree()):
        diff = np.abs(p.detach().numpy() - _stacked(params, path))
        assert diff.max() <= 2 * LR * TRAIN_STEPS, (path, diff.max())
        assert (diff <= 1e-6 * scale).mean() >= 0.99, (path, (diff > 1e-6 * scale).mean())


def test_grad_accum_matches_one_microbatch():
    """Two microbatches sum to the grads of the whole batch (float32)."""
    cfg = get_reduced("gemma2-2b")
    batch = train.to_device(JaxSyntheticLM(cfg.vocab, 40, seed=4).batch(0, 4), "cpu")
    out = []
    for accum in (1, 2):
        pm = build_model(cfg.replace(grad_accum=accum), device="cpu").init(7)
        out.append(make_train_step(pm, AdamWConfig()).loss_and_grad(batch))
    np.testing.assert_allclose(float(out[1][0]), float(out[0][0]), rtol=1e-5)
    for (path, a), (_, b) in zip(tree_leaves_with_path(out[0][1]),
                                 tree_leaves_with_path(out[1][1])):
        assert b.dtype == torch.float32
        _grads_close(b.numpy(), a.numpy(), f"accum grad {path}")


# --------------------------- the driver and counts ---------------------------------

def test_train_main_runs_and_resume_is_bit_equal(tmp_path, capsys):
    args = ["--arch", "gemma2-2b", "--device", "cpu", "--steps", "8", "--batch", "4",
            "--seq", "32", "--lr", "3e-3", "--ckpt-every", "4", "--log-every", "1"]
    run = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(run.losses) == 8 and np.isfinite(run.losses).all()
    assert np.isfinite(run.grad_norms).all() and len(run.fwd_bwd_ms) == 8
    assert run.start_step == 0 and run.opt_state["step"] == 8
    assert run.model.cfg.grad_accum == 1
    assert "loss did not decrease" not in capsys.readouterr().out
    # the run stopped after step 4's checkpoint, then resumed from it
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_00000008")
    try:
        resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
        assert resumed.start_step == 4 and len(resumed.losses) == 4
        assert resumed.losses == run.losses[4:]
    except SystemExit as e:      # the end rule over 4 losses; the save came first
        assert "loss did not decrease" in str(e)
    whole, extra_a = load_checkpoint(str(tmp_path / "a"))
    again, extra_b = load_checkpoint(str(tmp_path / "b"))
    assert extra_a == extra_b == {"step": 8}
    assert set(whole) == set(again) and any(k.startswith("0/layers/3/") for k in whole)
    for name in whole:
        np.testing.assert_array_equal(np.asarray(again[name]), np.asarray(whole[name]),
                                      err_msg=name)


@pytest.mark.parametrize("arch", FULL)
def test_counts_match_reference_without_allocation(arch):
    model = build_model(get_config(arch), device="cpu")
    assert all(t.device.type == "meta" for _, t in tree_leaves_with_path(param_shapes(model)))
    jm = jax_build(jax_config(arch))
    assert count_params(model) == jax_count(jm)
    assert count_active_params(model) == jax_active(jm)
