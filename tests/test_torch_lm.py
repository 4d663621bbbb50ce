"""The port's LM serving path against the JAX package's on the CPU: the
dense family and the MoE family (qwen3-moe's GQA + MoE blocks,
deepseek-v2's MLA, shared experts and dense first layer).

Weights come from the reference's ``LM.init`` and cross through
``params_from_jax``; prompts come from a seeded numpy generator.  Both
models teacher-force an 8-token prompt, then decode 32 tokens greedily:
40 steps, which cross gemma2's reduced sliding window of 16.  Logits are
compared at every step at rtol 1e-4 / atol 1e-4 (float32 configs; the two
frameworks sum the same products in other orders), greedy ids exactly,
and the final caches at the same tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids as jax_arch_ids
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models.registry import count_params as jax_count_params

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import ModelConfig, build_model, count_params
from repro_torch.models.convert import params_from_jax

MOE_ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v2-236b"]
ARCHS = ["gemma2-2b", "llama3-405b", "chameleon-34b"] + MOE_ARCHS
# the families ported last (the encoder-decoder, the hybrid and rwkv6)
LATE = ["whisper-small", "zamba2-2.7b", "rwkv6-3b"]
B, PROMPT, GEN, MAX_SEQ = 2, 8, 32, 48
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, its params as numpy, port model with them)."""
    arch = request.param
    jm = jax_build(jax_reduced(arch))
    tree = jax.device_get(jm.init(jax.random.key(1)))
    pm = build_model(get_reduced(arch), device="cpu").load(params_from_jax(tree))
    return arch, jm, tree, pm


def _prompts(arch, vocab):
    return np.random.default_rng(len(arch)).integers(0, vocab, (B, PROMPT))


def test_decode_steps_match_reference(pair):
    arch, jm, tree, pm = pair
    prompts = _prompts(arch, pm.cfg.vocab)
    decode = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, MAX_SEQ)
    tcache = pm.init_cache(B, MAX_SEQ)
    ids = []
    for t in range(PROMPT + GEN):
        if t < PROMPT:
            tok = prompts[:, t:t + 1]
        else:
            tok = np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None]
            got = tlogits[:, -1].argmax(-1)[:, None].numpy()
            np.testing.assert_array_equal(got, tok)
            ids.append(tok[:, 0])
        jlogits, jcache = decode(tree, jcache, jnp.asarray(tok, jnp.int32))
        tlogits, tcache = pm.decode_step(tcache, torch.tensor(tok))
        assert tlogits.shape == (B, 1, pm.cfg.vocab) and tlogits.dtype == torch.float32
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL,
                                   err_msg=f"{arch} step {t}")
    groups = [g for g in ("dense_layers", "layers") if g in jcache]
    assert sorted(groups) == sorted(g for g in tcache if g.endswith("layers"))
    for group in groups:
        assert set(tcache[group]) == set(jcache[group])
        for name in jcache[group]:
            np.testing.assert_allclose(tcache[group][name].numpy(),
                                       np.asarray(jcache[group][name]), **TOL,
                                       err_msg=f"{arch} {group}/{name}")
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
    assert tcache["pos"] == PROMPT + GEN

    # serve.generate on the CPU gives the same greedy ids
    res = serve.generate(pm, prompts, GEN, MAX_SEQ)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(ids, axis=1))
    assert len(res.step_ms) == GEN and res.prefill_ms > 0
    np.testing.assert_allclose(res.logits.numpy(), tlogits.numpy(), rtol=0, atol=0)


def test_param_tree_and_count_match_reference(pair):
    arch, jm, tree, pm = pair
    assert count_params(pm) == jax_count_params(jm)
    drawn = build_model(get_reduced(arch), device="cpu").init(0)
    assert {k: v.shape for k, v in drawn.state_dict().items()} == \
        {k: v.shape for k, v in pm.state_dict().items()}
    assert all(v.dtype == torch.float32 for v in drawn.state_dict().values())


def test_cache_is_updated_in_place_and_overflow_raises(pair):
    arch, _, _, pm = pair
    cache = pm.init_cache(1, 2)
    name = next(iter(cache["layers"]))           # k, or MLA's c_kv
    k = cache["layers"][name]
    tok = torch.zeros((1, 1), dtype=torch.int64)
    for step in range(2):
        _, out = pm.decode_step(cache, tok)
        assert out is cache and out["layers"][name] is k
        assert k[:, :, step].abs().sum() > 0
    with pytest.raises(ValueError, match="KV cache full"):
        pm.decode_step(cache, tok)


def test_serve_main_on_cpu(capsys):
    res = serve.main(["--arch", "gemma2-2b", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "4", "--gen", "3", "--max-seq", "8"])
    assert res.tokens.shape == (2, 3)
    assert "generated ids" in capsys.readouterr().out
    with pytest.raises(ValueError, match="max_seq"):
        serve.main(["--arch", "gemma2-2b", "--device", "cpu", "--prompt-len",
                    "8", "--gen", "4", "--max-seq", "8"])


@pytest.mark.parametrize("arch", jax_arch_ids())
def test_configs_match_reference(arch):
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_reduced(arch), jax_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", MOE_ARCHS + LATE)
def test_reference_configs_build(arch):
    """The MoE family and the three families ported last resolve by name
    and build from the reference's config, each as its family's model."""
    cfg = ModelConfig(**dataclasses.asdict(jax_reduced(arch)))
    assert get_config(arch).name == arch
    model = build_model(cfg, device="cpu")
    assert model.cfg == cfg
    assert type(model).__name__ == type(jax_build(jax_reduced(arch))).__name__
