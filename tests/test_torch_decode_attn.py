"""The port's decode attention (plain version on CPU tensors) against the
JAX package: its Pallas kernel in interpret mode, its flat API and the
model's ``cache_decode_attention`` with a sliding window.

Inputs come from a seeded numpy generator and go to both.  Tolerance
rtol 1e-4 / atol 1e-5, the JAX package's own for this kernel
(``tests/test_kernels.py``).  The CUDA kernel itself runs only on the
card (``chip_smoke.py``); here its algorithm (the wrapper's own
``split_blocks`` and ``split_units``, all g rows of a kv head in one
block, tiles of ``TILE`` positions, the bf16 split of P, the combine or
the one block's own normalization) is emulated in float64, and its g = 1
path (``g1_groups`` and ``g1_units``: units of a run of positions and a
group of kv heads, lane groups in phases, partials merged by the last
unit) in float32.
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
from repro_torch.kernels.decode_attn.kernel import (G1_LANE, G1_WARPS, MAX_BLOCKS,
                                                    MAX_D, MIN_TILES, ONE_BLOCK_SPAN,
                                                    TILE, g1_grid, g1_groups,
                                                    g1_scratch, g1_units,
                                                    scratch_floats, split_blocks,
                                                    split_units)
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


# ---------------------------------------------------------------------------
# the g = 1 path: its unit plan, emulated in float32, and its scratch
# ---------------------------------------------------------------------------

H100_SLOTS = 3 * 132          # the g = 1 kernel's block slots on an H100 (3 an SM)
ZAMBA2, WHISPER = (32, 80), (12, 64)   # (Hkv, D) of the two g = 1 models


def _ranges(lengths, S, window):
    """[lo, hi) of every sequence inside the masks (the kernel's seq_range)."""
    out = []
    for n in lengths:
        hi = min(max(int(n), 0), S)
        out.append((max(hi - window, 0) if window > 0 else 0, hi))
    return out


_G1_LENGTHS = {
    "zeros": [0, 0, 0], "ones": [1, 1, 1, 1], "1024": [1024] * 3, "1025": [1025, 1025],
    "ragged": np.random.default_rng(5).integers(0, 4097, 8).tolist(),
    "ragged_long": np.random.default_rng(6).integers(0, 40_000, 5).tolist(),
    "decode_32k": [1, 17, 4096, 4097, 9000, 20000, 30000, 32768],
}


@pytest.mark.parametrize("hkv,d", [ZAMBA2, WHISPER, (2, 64), (1, 256), (8, 40)])
@pytest.mark.parametrize("window", [0, 7, 300])
@pytest.mark.parametrize("which", sorted(_G1_LENGTHS))
@pytest.mark.parametrize("slots", [H100_SLOTS, 6])
def test_g1_plan_covers_every_position(hkv, d, window, which, slots):
    """The g = 1 plan's mirror covers every (sequence, head, position)
    inside the masks exactly once; its units fit the grid (one block
    each), ordered (b, chunk, head group); every chunk of a sequence but
    its last has the run's positions; an empty sequence has one empty unit
    a head group (it writes zeros)."""
    lengths = _G1_LENGTHS[which]
    S = max(max(lengths), 1)
    ranges = _ranges(lengths, S, window)
    n_pos = [hi - lo for lo, hi in ranges]
    hg, phases = g1_groups(hkv, d)
    assert hkv % hg == 0 and hg * phases <= G1_WARPS * (32 // (d // G1_LANE))
    grid = g1_grid(len(lengths), hkv, hg, slots)
    run, units = g1_units(n_pos, hkv, hg, grid)
    assert run >= 1 and len(units) <= grid
    assert [u[0] for u in units] == list(range(len(units)))
    seen = np.zeros((len(lengths), hkv, S), np.int64)
    order = []
    for u, b, h0, first, count, nu in units:
        assert h0 % hg == 0 and 0 <= count <= run
        lo, hi = ranges[b]
        seen[b, h0:h0 + hg, lo + first:lo + first + count] += 1
        order.append((b, first, h0))
        assert nu == (max(1, -(-n_pos[b] // run)))
    assert order == sorted(order)
    for b, (lo, hi) in enumerate(ranges):
        assert (seen[b][:, lo:hi] == 1).all() and not seen[b][:, :lo].any() \
            and not seen[b][:, hi:].any()
        chunks = sorted({(f, c) for _, bb, _, f, c, _ in units if bb == b})
        assert [f for f, _ in chunks] == [j * run for j in range(len(chunks))]
        assert all(c == run for _, c in chunks[:-1])
        if n_pos[b] == 0:
            assert chunks == [(0, 0)]


def test_g1_plan_balance_at_zamba2_lengths():
    """At phase 10's zamba2 case (Hkv 32, decode_32k's lengths, 396
    slots) the g = 1 plan's largest unit is within 10% of the even share
    of rows a slot; the g >= 2 split at g = 1 gave 469 tiles against 253,
    since it gave each kv head 12 of the 396 slots."""
    hkv, d = ZAMBA2
    n_pos = _G1_LENGTHS["decode_32k"]
    hg, _ = g1_groups(hkv, d)
    run, units = g1_units(n_pos, hkv, hg, g1_grid(len(n_pos), hkv, hg, H100_SLOTS))
    even = hkv * sum(n_pos) / H100_SLOTS
    assert max(u[4] for u in units) * hg <= 1.1 * even
    tiles = [-(-n // TILE) for n in n_pos]
    old = split_units(tiles, hkv, H100_SLOTS)
    assert max(u[3] for u in old) == 469 and round(hkv * sum(tiles) / H100_SLOTS) == 253


def test_g1_groups_fill_the_lane_groups():
    """(hg, phases) for every head count and D the kernel takes: hg divides
    Hkv, hg x phases fits the block's lane groups (the kernel raises past
    them), and as many are busy as any divisor allows; zamba2's and
    whisper's heads fill every lane group."""
    for d in range(8, MAX_D + 1, 8):
        groups = G1_WARPS * (32 // (d // G1_LANE))
        for hkv in range(1, 65):
            hg, phases = g1_groups(hkv, d)
            assert hkv % hg == 0 and 1 <= hg * phases <= groups
            assert hg * phases == max(h * (groups // h) for h in range(1, min(hkv, groups) + 1)
                                      if hkv % h == 0)
    assert g1_groups(*ZAMBA2) == (8, 3) and g1_groups(*WHISPER) == (4, 8)


def _g1_attend(q, k, v, positions, kpos, phases, scale, softcap):
    """One lane group of the g = 1 kernel in float32: its phase's tiles of
    ``kpos`` positions (``positions`` split among ``phases``), the online
    softmax a tile -> (m, l, acc)."""
    f32 = np.float32
    m, l, acc = f32(-1e30), f32(0), np.zeros(q.shape[-1], f32)
    for s0 in range(0, len(positions), kpos):
        idx = positions[s0:s0 + kpos]
        sc = (k[idx] @ q).astype(f32) * f32(scale)
        if softcap > 0:
            sc = (f32(softcap) * np.tanh(sc / f32(softcap))).astype(f32)
        mx = max(m, sc.max())
        alpha = np.exp(f32(m - mx))
        p = np.exp((sc - mx).astype(f32))
        l = l * alpha + p.sum(dtype=f32)
        acc = acc * alpha + (p[:, None] * v[idx]).sum(0, dtype=f32)
        m = mx
    return m, l, acc


def _g1_merge(parts):
    """(m, l, acc) partials merged: the kernel's phase and unit merges."""
    f32 = np.float32
    m = max([p[0] for p in parts], default=f32(-1e30))
    w = [np.exp(f32(p[0] - m)) for p in parts]
    return (m, sum((p[1] * wi for p, wi in zip(parts, w)), f32(0)),
            sum((p[2] * wi for p, wi in zip(parts, w)), np.zeros_like(parts[0][2])))


def _emulate_g1(q, k, v, lengths, scale, softcap, window, slots, kpos):
    """The g = 1 kernel's algorithm in float32: q [B, Hkv, 1, D], k / v
    [B, Hkv, S, D] views of either layout.  Each unit of ``g1_units``
    runs its hg heads in ``phases`` lane groups each (tile t of the unit
    in phase t mod phases), merges the phases, and writes its output (one
    unit a sequence) or a partial; the last unit of a (sequence, head
    group) merges the partials, lane group ph the units ph, ph + phases,
    ..., then the phases."""
    B, Hkv, _, D = q.shape
    ranges = _ranges(lengths, k.shape[2], window)
    hg, phases = g1_groups(Hkv, D)
    _, units = g1_units([hi - lo for lo, hi in ranges], Hkv, hg, g1_grid(B, Hkv, hg, slots))
    out = np.zeros((B, Hkv, 1, D), np.float32)
    partials = {}
    for u, b, h0, first, count, nu in units:
        lo = ranges[b][0] + first
        tiles = [list(range(lo + t * kpos, min(lo + (t + 1) * kpos, lo + count)))
                 for t in range(-(-count // kpos))]
        for h in range(h0, h0 + hg):
            res = _g1_merge([_g1_attend(q[b, h, 0], k[b, h], v[b, h],
                                        [s for t in tiles[ph::phases] for s in t], kpos,
                                        phases, scale, softcap) for ph in range(phases)])
            if nu == 1:
                out[b, h, 0] = res[2] / max(res[1], np.float32(1e-30))
            else:
                partials.setdefault((b, h), []).append(res)
    for (b, h), parts in partials.items():
        m, l, acc = _g1_merge([_g1_merge(parts[ph::phases]) for ph in range(phases)
                               if parts[ph::phases]])
        out[b, h, 0] = acc / max(l, np.float32(1e-30))
    return out


@pytest.mark.parametrize("hkv,d", [ZAMBA2, WHISPER])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_g1_kernel_emulated_matches_pallas(hkv, d, layout, softcap):
    """The g = 1 path emulated in float32 (bf16's two positions a ring
    slot) within
    the JAX package's tolerance of its Pallas kernel in interpret mode, on
    the model's [B, S, Hkv, D] cache and on a [B, Hkv, S, D] one.  Twelve
    block slots a head group: the long sequences split into several units
    and merge through partials, the short ones write their output."""
    rng = np.random.default_rng(d + hkv + int(softcap))
    B, S = 4, 512
    q = rng.standard_normal((B, hkv, 1, d)).astype(np.float32)
    if layout == "BSHD":
        k, v = (rng.standard_normal((B, S, hkv, d)).astype(np.float32).transpose(0, 2, 1, 3)
                for _ in range(2))
    else:
        k, v = (rng.standard_normal((B, hkv, S, d)).astype(np.float32) for _ in range(2))
    lengths = np.array([0, 1, 300, S], np.int32)
    scale = d ** -0.5
    hg, _ = g1_groups(hkv, d)
    slots = 12 * (hkv // hg)
    got = _emulate_g1(q, k, v, lengths, scale, softcap, 0, slots=slots, kpos=2)
    _, units = g1_units(lengths.tolist(), hkv, hg, g1_grid(B, hkv, hg, slots))
    assert min(u[5] for u in units if u[1] >= 2) > 1 and {u[5] for u in units if u[1] < 2} == {1}
    want = np.asarray(jax_grouped(jnp.asarray(q), jnp.asarray(np.ascontiguousarray(k)),
                                  jnp.asarray(np.ascontiguousarray(v)), jnp.asarray(lengths),
                                  scale=scale, softcap=softcap, block_s=128, interpret=True))
    assert not got[0].any()                # length 0 gives zeros
    np.testing.assert_allclose(got, want, **TOL)
    plain = decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths), scale=scale,
                                 softcap=softcap).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("window", [0, 7, 300])
def test_g1_kernel_emulated_with_window_and_f32_slots(window):
    """The float32 instantiation (one position a ring slot) with a sliding
    window, against the port's plain version at whisper's heads."""
    rng = np.random.default_rng(window + 1)
    B, S = 3, 700
    hkv, d = WHISPER
    q = rng.standard_normal((B, hkv, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, hkv, d)).astype(np.float32).transpose(0, 2, 1, 3)
            for _ in range(2))
    lengths = np.array([0, 350, S], np.int32)
    got = _emulate_g1(q, k, v, lengths, 0.125, 30.0, window, slots=9, kpos=1)
    plain = decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths), scale=0.125,
                                 softcap=30.0, window=window).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("b,s,hkv,d", [
    (8, 32768, *ZAMBA2),       # row 5e: zamba2's heads at decode_32k
    (8, 32768, *WHISPER),      # row 5f
    (4, 1500, *WHISPER),       # whisper's cross-attention as served
    (4, 128, *ZAMBA2),         # a served self-attention cache
    (1, 524288, *ZAMBA2),      # a shared-block application of long_500k
    (2000, 64, 2, 64),         # more (sequence, head group)s than slots
])
def test_g1_scratch_is_sized_by_shape(b, s, hkv, d):
    """The g = 1 scratch: (acc, m, l) of the hg heads of every block's
    unit and a counter a (sequence, head group), sized by the shape alone
    (one allocation kept for every call of it, whatever the lengths),
    every unit's slot and counter inside it; at the long caches at most
    1/16 of the bf16 k/v bytes read."""
    hg, _ = g1_groups(hkv, d)
    grid = g1_grid(b, hkv, hg, H100_SLOTS)
    floats, ints = g1_scratch(b, hkv, d, hg, grid)
    assert floats == grid * hg * (d + 2) and ints == b * (hkv // hg)
    assert grid >= max(H100_SLOTS, b * (hkv // hg))
    for lengths in ([s] * b, np.random.default_rng(b).integers(0, s + 1, b).tolist()):
        _, units = g1_units(lengths, hkv, hg, grid)
        assert (len(units) - 1) * hg * (d + 2) + hg * (d + 2) <= floats
        assert max(u[1] * (hkv // hg) + u[2] // hg for u in units) < ints
    if s >= 1500:
        assert 4 * floats <= b * s * hkv * d * 2 * 2 / 16
