"""The port's decode attention (plain version on CPU tensors) against the
JAX package: its Pallas kernel in interpret mode, its flat API and the
model's ``cache_decode_attention`` with a sliding window.

Inputs come from a seeded numpy generator and go to both.  Tolerance
rtol 1e-4 / atol 1e-5, the JAX package's own for this kernel
(``tests/test_kernels.py``).  The CUDA kernel itself runs only on the
card (``chip_smoke.py``); here its algorithm (the wrapper's own
``split_blocks`` and ``split_units``, all g rows of a kv head in one
block, tiles of ``TILE`` positions, the bf16 split of P, the combine or
the one block's own normalization) is emulated in float64.
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
from repro_torch.kernels.decode_attn.kernel import (MAX_BLOCKS,
                                                    MIN_TILES, ONE_BLOCK_SPAN,
                                                    TILE, scratch_floats,
                                                    split_blocks, split_units)
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

def _bf16(x):
    """float32 -> bfloat16 (round to nearest even), back in float64."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


def _attend(q, k, v, lo, hi, scale, softcap, split_p):
    """One block's segment [lo, hi) of one pair, all g rows: the online
    softmax over tiles of TILE positions -> (m, l, acc)."""
    g, D = q.shape
    m, l, acc = np.full(g, -1e30), np.zeros(g), np.zeros((g, D))
    for s0 in range(lo, hi, TILE):
        idx = np.arange(s0, min(s0 + TILE, hi))
        sc = q @ k[idx].T * scale
        if softcap > 0:
            sc = softcap * np.tanh(sc / softcap)
        m_new = np.maximum(m, sc.max(1))
        p = np.exp(sc - m_new[:, None])
        if split_p:
            p = p.astype(np.float32).astype(np.float64)
            p_hi = _bf16(p)
            pv = p_hi + _bf16(p - p_hi)
        else:
            pv = p
        alpha = np.exp(m - m_new)
        l = l * alpha + p.sum(1)
        acc = acc * alpha[:, None] + pv @ v[idx]
        m = m_new
    return m, l, acc


def _emulate_kernel(q, k, v, lengths, scale, softcap, window, split_p=True, sms=4):
    """The CUDA kernel's algorithm in float64 on a card of ``sms`` SMs:
    one block a (b, kv head) that normalizes its own output, or the
    units of ``split_units`` (all g rows of a pair each), their partial
    (m, l, acc) combined pair by pair.  P V with P rounded to
    float32 and split into bf16 P_hi + P_lo (``split_p``; exact P
    otherwise)."""
    B, Hkv, g, D = q.shape
    S = k.shape[2]
    ranges = []
    for b in range(B):
        hi = min(max(int(lengths[b]), 0), S)
        ranges.append((max(hi - window, 0) if window > 0 else 0, hi))
    out = np.zeros((B, Hkv, g, D))
    n_blocks = split_blocks(min(S, window) if window > 0 else S, sms, 2)
    if n_blocks == 0:
        for b, (lo, hi) in enumerate(ranges):
            for h in range(Hkv):
                m, l, acc = _attend(q[b, h], k[b, h], v[b, h], lo, hi, scale, softcap,
                                    split_p)
                out[b, h] = acc / np.maximum(l, 1e-30)[:, None]
        return out
    tiles = [-(-(hi - lo) // TILE) for lo, hi in ranges]
    parts = {}
    for _, pair, first, n in split_units(tiles, Hkv, n_blocks):
        b, h = divmod(pair, Hkv)
        lo, hi = ranges[b]
        parts.setdefault(pair, []).append(_attend(
            q[b, h], k[b, h], v[b, h], lo + first * TILE, min(lo + (first + n) * TILE, hi),
            scale, softcap, split_p))
    for pair, ps in parts.items():
        mx = np.max([p[0] for p in ps], axis=0)
        w = [np.exp(p[0] - mx) for p in ps]
        lsum = sum(p[1] * wu for p, wu in zip(ps, w))
        out[divmod(pair, Hkv)] = sum(p[2] * wu[:, None] for p, wu in zip(ps, w)) \
            / np.maximum(lsum, 1e-30)[:, None]
    return out


def _direct_softmax(q, k, v, lengths, scale, softcap, window):
    """float64 softmax over each sequence's [lo, hi) in one pass."""
    out = np.zeros(q.shape)
    for b in range(q.shape[0]):
        hi = min(max(int(lengths[b]), 0), k.shape[2])
        lo = max(hi - window, 0) if window else 0
        if hi <= lo:
            continue
        kk, vv = k[b][:, lo:hi], v[b][:, lo:hi]
        s = np.einsum("hgd,hsd->hgs", q[b], kk) * scale
        if softcap > 0:
            s = softcap * np.tanh(s / softcap)
        p = np.exp(s - s.max(-1, keepdims=True))
        out[b] = np.einsum("hgs,hsd->hgd", p / p.sum(-1, keepdims=True), vv)
    return out


@pytest.mark.parametrize("window", [0, 7, 300])
@pytest.mark.parametrize("g", [1, 2, 3, 8, 16])
def test_kernel_split_and_combine_emulated(window, g):
    """S = 1300: window 0 splits the pairs over blocks and combines,
    windows 7 and 300 take one block a pair.  With exact P the emulation
    is the float64 softmax; with P split it stays within 2^-16 of the
    output, and within the JAX package's tolerance of the plain version."""
    rng = np.random.default_rng(g * 10 + window)
    B, Hkv, D, S = 3, 2, 8, 1300
    q = rng.standard_normal((B, Hkv, g, D))
    k = rng.standard_normal((B, Hkv, S, D))
    v = rng.standard_normal((B, Hkv, S, D))
    lengths = np.array([0, 333, S], np.int32)
    assert (split_blocks(min(S, window) if window else S, 4, 2) > 0) == (window == 0)
    want = _direct_softmax(q, k, v, lengths, 0.3, 50.0, window)
    exact = _emulate_kernel(q, k, v, lengths, 0.3, 50.0, window, split_p=False)
    np.testing.assert_allclose(exact, want, rtol=1e-12, atol=1e-12)
    got = _emulate_kernel(q, k, v, lengths, 0.3, 50.0, window)
    assert not got[0].any()                # length 0 gives zeros
    for b in (1, 2):
        assert np.abs(got[b] - want[b]).max() <= 2.0 ** -16 * np.abs(want[b]).max()
    plain = decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths), scale=0.3,
                                 softcap=50.0, window=window).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("g,D,softcap", [(1, 64, 30.0), (2, 256, 50.0),
                                         (8, 128, 0.0), (16, 128, 0.0)])
def test_p_split_keeps_precision_on_short_sequences(g, D, softcap):
    """Lengths 1-64, bf16 inputs: the emulated kernel (P_hi + P_lo) within
    2^-16 max|out| of a float64 softmax, sequence by sequence: the
    precision ``chip_smoke.attn_tolerance`` assumes of the kernel's P V
    (P in one bf16 would be off by ~2^-9 a weight)."""
    rng = np.random.default_rng(D + g)
    B, Hkv, S = 64, 1, 64
    q, k, v = (_bf16(rng.standard_normal(s)) for s in
               ((B, Hkv, g, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    lengths = np.arange(1, B + 1, dtype=np.int32)
    got = _emulate_kernel(q, k, v, lengths, D ** -0.5, softcap, 0)
    want = _direct_softmax(q, k, v, lengths, D ** -0.5, softcap, 0)
    err = np.abs(got - want).max(axis=(1, 2, 3))
    assert (err <= 2.0 ** -16 * np.abs(want).max(axis=(1, 2, 3))).all()


@pytest.mark.parametrize("n_pairs,span", [(32, 32768), (32, 4096), (16, 1024),
                                          (1, 1), (4, 0), (2000, 100_000),
                                          (1, 100_000), (64, 1025), (8, 32768)])
def test_split_plan_covers_every_position(n_pairs, span):
    """A span that fits one block is one block a (b, kv head) and no
    combine.  A longer one is split over every block slot of an H100 (132
    SMs, three blocks each): at full span and at ragged lengths (some
    sequences empty), the units cover every tile of every pair once, in
    order, in chunks of one size w >= MIN_TILES (a sequence's last chunk
    shorter), ordered (b, chunk, h); w is the fewest that fit the blocks
    when each head's sequences leave room, and the slots fit the scratch."""
    n_blocks = split_blocks(span, 132, 3)
    if span <= ONE_BLOCK_SPAN:
        assert n_blocks == 0 and scratch_floats(n_pairs, 16, 128, n_blocks) == 0
        return
    assert n_blocks == 3 * 132 <= MAX_BLOCKS
    hkv = 4 if n_pairs % 4 == 0 else 1
    ragged = np.random.default_rng(n_pairs + span).integers(0, span + 1, n_pairs // hkv)
    ragged[::3] = 0
    for lengths in ([span] * (n_pairs // hkv), ragged.tolist()):
        tiles = [-(-n // TILE) for n in lengths]
        units = split_units(tiles, hkv, n_blocks)
        assert [u[0] for u in units] == list(range(len(units)))
        w = max((u[3] for u in units), default=MIN_TILES)
        assert w >= MIN_TILES
        for pair in range(n_pairs):
            runs = [(f, n) for _, p, f, n in units if p == pair]
            assert sum(n for _, n in runs) == tiles[pair // hkv]
            assert [f for f, _ in runs] == [i * w for i in range(len(runs))]
            assert all(n == w for _, n in runs[:-1])
        order = [(p // hkv, f, p % hkv) for _, p, f, _ in units]
        assert order == sorted(order)
        seqs = sum(n > 0 for n in tiles)
        if n_blocks // hkv > seqs:
            assert len(units) <= n_blocks
            if w > max(MIN_TILES, -(-hkv * sum(tiles) // n_blocks)):
                assert hkv * sum(-(-n // (w - 1)) for n in tiles) > n_blocks
        assert len(units) <= n_blocks + n_pairs


@pytest.mark.parametrize("b,hkv,g,d,span", [
    (8, 4, 16, 128, 32768),    # qwen3-moe's heads at decode_32k
    (8, 8, 16, 128, 32768),    # llama3-405b's
    (8, 8, 8, 128, 32768),     # chameleon-34b's
    (8, 4, 2, 256, 32768),     # gemma2-2b's
    (4, 4, 16, 128, 128),      # qwen3-moe's served cache
    (4, 4, 2, 256, 1024),      # gemma2-2b's served cache
])
def test_partial_scratch_is_small(b, hkv, g, d, span):
    """The partials (g (D + 2) floats a slot) are at most 1/16 of the bf16
    k/v bytes of the span on an H100 (132 SMs, three blocks each); a span
    that fits one block has none."""
    n_blocks = split_blocks(span, 132, 3)
    part = 4 * scratch_floats(b * hkv, g, d, n_blocks)
    assert part <= b * hkv * span * d * 2 * 2 / 16
    assert (part == 0) == (span <= ONE_BLOCK_SPAN)
