"""The port's blocked attention and chunked cross-entropy against the JAX
package's on the CPU: Sq and Skv that the blocks do not divide, a query
offset, a window with softcap, Dv != Dk and non-causal attention; labels
of -1, a chunk that does not divide S and softcap.  Values rtol 1e-5,
grads (``torch.autograd`` against ``jax.grad``) within 1e-4 of max |grad|;
``l2_norm`` rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import blocked_attention as jax_attention
from repro.models.common import chunked_xent as jax_xent
from repro.models.common import l2_norm as jax_l2_norm

from repro_torch.models.common import blocked_attention, chunked_xent, l2_norm


def _grads_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                               err_msg=what)


# --------------------------- blocked attention ---------------------------------

ATTN_CASES = {
    # name: (B, Sq, Skv, Hkv, G, Dk, Dv, kwargs)
    "ragged_blocks": (2, 37, 37, 2, 2, 8, 8, dict(block_q=16, block_kv=16)),
    "q_offset": (1, 10, 37, 2, 3, 8, 8, dict(q_offset=27, block_q=4, block_kv=16)),
    "window_softcap": (2, 45, 45, 1, 2, 16, 16, dict(window=7, softcap=5.0,
                                                     block_q=8, block_kv=16)),
    "dv_ne_dk": (1, 33, 33, 2, 1, 12, 6, dict(block_q=16, block_kv=8)),
    "not_causal": (2, 20, 33, 2, 2, 8, 8, dict(causal=False, block_q=8, block_kv=16)),
    "single_block": (1, 12, 12, 2, 2, 8, 8, dict(window=5)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blocked_attention_matches_reference(case):
    b, sq, skv, hkv, g, dk, dv, kw = ATTN_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((b, sq, hkv, g, dk)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dk)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    ct = rng.standard_normal((b, sq, hkv, g, dv)).astype(np.float32)
    jkw = dict(kw)
    if "window" in jkw:
        jkw["window"] = jnp.int32(jkw["window"])
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
    jgrads = jax.grad(lambda *a: jnp.sum(jax_attention(*a, **jkw) * ct),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = blocked_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    tgrads = torch.autograd.grad((out * torch.tensor(ct)).sum(), (tq, tk, tv))
    for name, got, ref in zip("qkv", tgrads, jgrads):
        _grads_close(got.numpy(), ref, f"{case} d{name}")


def test_chunked_xent_matches_reference():
    rng = np.random.default_rng(11)
    b, s, d, vocab = 2, 37, 16, 50
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (rng.standard_normal((d, vocab)) * 0.5).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1
    for chunk, cap in ((16, 3.0), (64, 0.0), (37, 30.0)):
        f = lambda x_, h_: jax_xent(x_, h_, jnp.asarray(labels), chunk=chunk,  # noqa: E731
                                    softcap=cap)
        want, jgrads = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                              jnp.asarray(head))
        tx, th = torch.tensor(x, requires_grad=True), torch.tensor(head, requires_grad=True)
        got = chunked_xent(tx, th, torch.tensor(labels), chunk=chunk, softcap=cap)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        for name, g, ref in zip(("x", "head"), torch.autograd.grad(got, (tx, th)), jgrads):
            _grads_close(g.numpy(), ref, f"chunk {chunk} d{name}")


def test_l2_norm_matches_reference():
    x = np.random.default_rng(12).standard_normal((3, 5, 16)).astype(np.float32) * 3
    np.testing.assert_allclose(l2_norm(torch.tensor(x)).numpy(),
                               np.asarray(jax_l2_norm(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
