"""The port's decode attention (plain version on CPU tensors) against the
JAX package: its Pallas kernel in interpret mode, its flat API and the
model's ``cache_decode_attention`` with a sliding window.

Inputs come from a seeded numpy generator and go to both.  Tolerance
rtol 1e-4 / atol 1e-5, the JAX package's own for this kernel
(``tests/test_kernels.py``).  The CUDA kernel itself runs only on the
card (``chip_smoke.py``); here its split over positions and its combine
are emulated in float64 from the wrapper's own ``split_plan``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.kernel import decode_attention_grouped as jax_grouped
from repro.kernels.decode_attn.ops import decode_attention as jax_flat
from repro.models.common import cache_decode_attention as jax_cache_attn

from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_grouped,
                                             decode_attention_ref)
from repro_torch.kernels.decode_attn.kernel import (BLOCKS_IN_FLIGHT, WARPS,
                                                    query_tile, split_plan)
from repro_torch.models.common import cache_decode_attention

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("B,Hkv,g,D,S,block_s", [
    (2, 2, 4, 32, 256, 64),
    (1, 4, 1, 64, 512, 128),
    (3, 1, 8, 16, 128, 128),
])
def test_grouped_matches_pallas(B, Hkv, g, D, S, block_s):
    rng = np.random.default_rng(B * 100 + S)
    q = rng.standard_normal((B, Hkv, g, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    scale = 1.0 / np.sqrt(D)
    got = decode_attention_grouped(_t(q), _t(k), _t(v), _t(lengths), scale=scale)
    want = jax_grouped(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(lengths), scale=scale, block_s=block_s,
                       interpret=True)
    assert got.dtype == torch.float32 and got.shape == (B, Hkv, g, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flat_api_and_softcap_match_pallas(softcap):
    rng = np.random.default_rng(7)
    B, H, Hkv, D, S = 2, 8, 2, 32, 200     # S not a block multiple
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lengths = np.array([150, 200], np.int32)
    got = decode_attention(q, kc, vc, lengths, softcap=softcap, device="cpu")
    want = jax_flat(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), softcap=softcap, block_s=64,
                    interpret=True)
    assert got.shape == (B, H, D) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_masked_tail_is_ignored():
    """Values beyond ``lengths`` must not leak into the output."""
    rng = np.random.default_rng(9)
    B, Hkv, g, D, S = 1, 1, 2, 16, 128
    q = rng.standard_normal((B, Hkv, g, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    lengths = _t(np.array([40], np.int32))
    out1 = decode_attention_grouped(_t(q), _t(k), _t(v), lengths, scale=0.25)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 40:] = 1e6
    v2[:, :, 40:] = -1e6
    out2 = decode_attention_grouped(_t(q), _t(k2), _t(v2), lengths, scale=0.25)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)
    want = jax_grouped(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2),
                       jnp.asarray([40], jnp.int32), scale=0.25, block_s=32,
                       interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [1, 5, 16, 64])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_window_matches_cache_decode_attention(window, softcap):
    """The model's contract: ``length`` counts the new token; the window
    keeps positions ``>= length - window``."""
    rng = np.random.default_rng(window)
    B, Hkv, G, Dh, S = 3, 2, 2, 16, 48
    q = rng.standard_normal((B, 1, Hkv, G, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    length = np.array([1, 20, S], np.int32)
    want = np.asarray(jax_cache_attn(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(length),
                                     softcap=softcap, window=jnp.int32(window)))
    got = cache_decode_attention(_t(q), _t(kc), _t(vc), _t(length),
                                 softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got_kernel_api = decode_attention_grouped(
        _t(q[:, 0]), _t(kc).transpose(1, 2), _t(vc).transpose(1, 2), _t(length),
        scale=1.0 / np.sqrt(Dh), softcap=softcap, window=window)
    np.testing.assert_allclose(got_kernel_api.numpy(), want[:, 0], **TOL)


def test_no_window_matches_cache_decode_attention():
    rng = np.random.default_rng(3)
    B, Hkv, G, Dh, S = 2, 1, 4, 8, 33
    q = rng.standard_normal((B, 1, Hkv, G, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    length = np.array([7, 33], np.int32)
    want = jax_cache_attn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(length), softcap=50.0)
    got = cache_decode_attention(_t(q), _t(kc), _t(vc), _t(length), softcap=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_inputs_accumulate_in_f32():
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in ((2, 2, 2, 16), (2, 2, 40, 16),
                                            (2, 2, 40, 16)))
    lengths = torch.tensor([13, 40], dtype=torch.int32)
    got = decode_attention_grouped(q, k, v, lengths, scale=0.25, softcap=50.0)
    want = decode_attention_grouped(q.float(), k.float(), v.float(), lengths,
                                    scale=0.25, softcap=50.0)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 2, 16)
    k = torch.zeros(1, 2, 8, 16)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_attention_grouped(q, k[:, :1], k, lengths, scale=1.0)
    with pytest.raises(ValueError):
        decode_attention_grouped(q, k, k, lengths.long(), scale=1.0)
    with pytest.raises(TypeError):
        decode_attention_grouped(q, k.double(), k.double(), lengths, scale=1.0)
    with pytest.raises(ValueError):
        decode_attention_grouped(q, k, k, lengths, scale=1.0, window=-1)


# ---------------------------------------------------------------------------
# the kernel's split over positions and its combine, emulated
# ---------------------------------------------------------------------------

def _emulate_kernel(q, k, v, lengths, scale, softcap, window, rows=4):
    """The CUDA kernel's algorithm in float64: warps of ``split_plan``
    over ``chunk`` positions of [lo, hi) each, an online softmax over tiles
    of ``rows`` positions, then the combine of the partial (m, l, acc)."""
    B, Hkv, g, D = q.shape
    S = k.shape[2]
    span = min(S, window) if window > 0 else S
    units, chunk = split_plan(B * Hkv * -(-g // query_tile(g)), span)
    out = np.zeros((B, Hkv, g, D))
    for b in range(B):
        hi = min(max(int(lengths[b]), 0), S)
        lo = max(hi - window, 0) if window > 0 else 0
        for h in range(Hkv):
            for j in range(g):
                parts = []
                for u in range(units):
                    begin = min(lo + u * chunk, hi)
                    end = min(lo + u * chunk + chunk, hi)
                    m, l, acc = -1e30, 0.0, np.zeros(D)
                    for s0 in range(begin, end, rows):
                        idx = np.arange(s0, min(s0 + rows, end))
                        sc = (k[b, h, idx] @ q[b, h, j]) * scale
                        if softcap > 0:
                            sc = softcap * np.tanh(sc / softcap)
                        m_new = max(m, sc.max())
                        p = np.exp(sc - m_new)
                        alpha = np.exp(m - m_new)
                        l, acc, m = l * alpha + p.sum(), acc * alpha + p @ v[b, h, idx], m_new
                    parts.append((m, l, acc))
                mx = max(p[0] for p in parts)
                lsum = sum(p[1] * np.exp(p[0] - mx) for p in parts)
                out[b, h, j] = sum(p[2] * np.exp(p[0] - mx) for p in parts) / max(lsum, 1e-30)
    return out


@pytest.mark.parametrize("window", [0, 7, 300])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_kernel_split_and_combine_emulated(window, g):
    rng = np.random.default_rng(g * 10 + window)
    B, Hkv, D, S = 3, 2, 8, 700
    q = rng.standard_normal((B, Hkv, g, D))
    k = rng.standard_normal((B, Hkv, S, D))
    v = rng.standard_normal((B, Hkv, S, D))
    lengths = np.array([0, 333, S], np.int32)
    got = _emulate_kernel(q, k, v, lengths, 0.3, 50.0, window)
    assert not got[0].any()                # length 0 gives zeros
    for b in (1, 2):                       # a direct float64 softmax
        lo = max(int(lengths[b]) - window, 0) if window else 0
        kk, vv = k[b][:, lo:lengths[b]], v[b][:, lo:lengths[b]]
        s = 50.0 * np.tanh(np.einsum("hgd,hsd->hgs", q[b], kk) * 0.3 / 50.0)
        p = np.exp(s - s.max(-1, keepdims=True))
        want = np.einsum("hgs,hsd->hgd", p / p.sum(-1, keepdims=True), vv)
        np.testing.assert_allclose(got[b], want, rtol=1e-12, atol=1e-12)
    plain = decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths), scale=0.3,
                                 softcap=50.0, window=window).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("n_tiles,span", [(32, 32768), (32, 4096), (16, 1024),
                                          (1, 1), (4, 0), (2000, 100_000),
                                          (1, 100_000)])
def test_split_plan_covers_every_position(n_tiles, span):
    """Every position has a warp, the last block has work, and the grid
    stays near BLOCKS_IN_FLIGHT."""
    units, chunk = split_plan(n_tiles, span)
    assert units % WARPS == 0 and units * chunk >= span
    assert units == WARPS or (units - WARPS) * chunk < span
    assert units // WARPS <= max(1, -(-BLOCKS_IN_FLIGHT // n_tiles))
