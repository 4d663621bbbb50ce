"""The port's ``LM.hidden``, ``loss`` and ``prefill`` against the JAX
package's on the CPU, for gemma2-2b, llama3-405b and chameleon-34b
reduced (``hidden``, ``loss`` and the grads also for the reduced MoE
LMs, qwen3-moe-235b-a22b and deepseek-v2-236b, through their local
dense-masked oracle); weights from the reference's ``LM.init`` through
``params_from_jax``, tokens from a seeded numpy generator.  Hidden rtol
1e-4 / atol 1e-4, the loss rtol 1e-5, each grad leaf within 1e-4 of its
max |grad|; ``remat`` on bit-equal to off; prefill's last logits and
cache rtol 1e-4 / atol 1e-4, and the port's own teacher-forced decode
against its ``hidden`` at the reference test's rtol 2e-2 / atol 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build

from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.common import head_logits
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_at, tree_leaves_with_path

ARCHS = ["gemma2-2b", "llama3-405b", "chameleon-34b"]
MOE_ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v2-236b"]


def _grads_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                               err_msg=what)


# --------------------------- the LM -----------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, its params as numpy, a token batch)."""
    arch = request.param
    jm = jax_build(jax_reduced(arch))
    tree = jax.device_get(jm.init(jax.random.key(3)))
    rng = np.random.default_rng(len(arch))
    cfg = jm.cfg
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)}
    batch["labels"][0, :4] = -1
    return arch, jm, tree, batch


def _port(arch, tree, **over):
    return build_model(get_reduced(arch).replace(**over), device="cpu").load(
        params_from_jax(tree))


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _stacked(tree_j, path):
    if path[0] in ("layers", "dense_layers"):
        return np.asarray(tree_at(tree_j[path[0]], path[2:])[path[1]])
    return np.asarray(tree_at(tree_j, path))


@pytest.mark.parametrize("pair", ARCHS + MOE_ARCHS, indirect=True)
def test_hidden_loss_and_grads_match_reference(pair):
    arch, jm, tree, batch = pair
    pm = _port(arch, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    np.testing.assert_allclose(pm.hidden(torch.tensor(batch["tokens"])).detach().numpy(),
                               np.asarray(jm.hidden(tree, jb["tokens"])),
                               rtol=1e-4, atol=1e-4)
    want, jgrads = jax.value_and_grad(jm.loss)(tree, jb)
    loss = pm.loss(_torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    params = pm.param_tree()
    leaves = [p for _, p in tree_leaves_with_path(params)]
    grads = torch.autograd.grad(loss, leaves)
    for (path, _), g in zip(tree_leaves_with_path(params), grads):
        _grads_close(g.numpy(), _stacked(jgrads, path), f"{arch} grad {path}")


def test_remat_equals_no_remat(pair):
    arch, _, tree, batch = pair
    out = []
    for remat in (False, True):
        pm = _port(arch, tree, remat=remat)
        loss = pm.loss(_torch_batch(batch))
        leaves = [p for _, p in tree_leaves_with_path(pm.param_tree())]
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_prefill_matches_reference_and_decode(pair):
    arch, jm, tree, batch = pair
    pm = _port(arch, tree)
    tokens = batch["tokens"]
    jlogits, jcache = jm.prefill(tree, jnp.asarray(tokens))
    logits, cache = pm.prefill(torch.tensor(tokens))
    assert logits.shape == (2, pm.cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(cache["length"].numpy(), np.asarray(jcache["length"]))
    assert cache["pos"] == tokens.shape[1]
    # the port's own teacher-forced decode against its hidden + head
    with torch.no_grad():
        want = head_logits(pm.hidden(torch.tensor(tokens)), pm.head_matrix(),
                           pm.cfg.final_softcap)
    dcache = pm.init_cache(2, tokens.shape[1])
    steps = []
    for t in range(tokens.shape[1]):
        out, dcache = pm.decode_step(dcache, torch.tensor(tokens[:, t:t + 1]))
        steps.append(out[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(steps[-1].numpy(), logits.numpy(), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(dcache["layers"][name].numpy(),
                                   cache["layers"][name].numpy(), rtol=1e-4, atol=1e-4)
