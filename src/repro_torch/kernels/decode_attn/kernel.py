"""Single-token GQA decode attention: CUDA kernel wrapper.

The kernel (``csrc/decode_attn.cu``) replaces the Pallas kernel
``repro/kernels/decode_attn/kernel.py::decode_attention_grouped``:

    q:       [B, Hkv, g, D] float32 or bfloat16, contiguous
    k, v:    [B, Hkv, S, D] of q's dtype, any strides with unit stride
             along D: the transpose ``cache.transpose(1, 2)`` of the
             model's [B, S, Hkv, D] cache is read in place, with no copy
    lengths: [B] int32, positions ``>= lengths[b]`` masked
    returns  [B, Hkv, g, D] float32

``window > 0`` also masks positions ``< lengths[b] - window`` (the sliding
window of ``models.common.cache_decode_attention``); ``window = 0`` is
the TPU kernel's contract.  ``softcap > 0`` caps the scores as
``softcap * tanh(s / softcap)``.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors take the
kernel or raise; ``meta`` tensors an empty result of the output's shape.
g >= 2 takes the tile kernel (all g rows of a kv head in a block; its
split mirrored by :func:`split_units`); g = 1 its own kernel, one launch,
over units of (sequence, run of positions, group of kv heads) mirrored by
:func:`g1_units`, with a scratch sized once for each shape and kept.
While :mod:`repro_torch.core.op_analysis` counts, a call reports its
declared work (:func:`declared_work`): the k/v rows inside the masks,
read once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import op_analysis
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

NAME = "decode_attention_grouped"
MAX_D = 256               # D a multiple of 8 up to this
TILE = 32                 # positions of a staged k/v tile (kTile in the source)
MAX_ROWS = 32             # query rows a launch holds (kMaxRows): two M-tiles of 16
ONE_BLOCK_SPAN = 1024     # spans up to this take one block a (b, kv head), no combine
MIN_TILES = 16            # fewest tiles (512 positions) a unit of the split takes
MAX_BLOCKS = 65535        # blocks of the split (kMaxBlocks in the source)
G1_WARPS = 8              # warps of a g = 1 block (kG1Warps)
G1_LANE = 8               # elements of D a lane of the g = 1 kernel holds (kG1Lane)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def _fn():
    fn = _build.library("decode_attn").decode_attention_grouped
    if fn.argtypes is None:
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, ll, ll, ll, ll, ll, ll, p, p,
                       i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def _g1_fn():
    fn = _build.library("decode_attn").decode_attention_g1
    if fn.argtypes is None:
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, ll, ll, ll, ll, ll, ll, p, p, p,
                       i, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, dtype: int, d: int, rows: int) -> int:
    """Blocks of the tile kernel's instantiation an SM holds at once."""
    fn = _build.library("decode_attn").decode_attention_occupancy
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, i, i, p, p]
        fn.restype = ctypes.c_int
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        code = fn(dtype, d, rows, ctypes.byref(blocks), ctypes.byref(smem))
    _build.check_status(code, NAME)
    return blocks.value


def split_blocks(span: int, sms: int, per_sm: int) -> int:
    """Blocks of the split for a span of at most ``span`` valid positions
    on a card of ``sms`` SMs that hold ``per_sm`` blocks each: 0 (one block
    a (b, kv head), which writes the output itself: no combine) up to
    ONE_BLOCK_SPAN, else a block for every slot of the card, over which
    the kernel spreads the tiles the lengths hold (:func:`split_units`)."""
    return 0 if span <= ONE_BLOCK_SPAN else min(per_sm * sms, MAX_BLOCKS)


def launch_blocks(q: torch.Tensor, k: torch.Tensor, window: int = 0) -> int:
    """:func:`split_blocks` of a call on q's card (CUDA tensors)."""
    seq = k.shape[2]
    span = min(seq, window) if window > 0 else seq
    if span <= ONE_BLOCK_SPAN:
        return 0
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    per_sm = _blocks_per_sm(index, _DTYPES[q.dtype], q.shape[3], min(q.shape[2], MAX_ROWS))
    return split_blocks(span, _sms(index), per_sm)


def split_units(seq_tiles: Sequence[int], hkv: int,
                n_blocks: int) -> List[Tuple[int, int, int, int]]:
    """The kernel's split, as (unit, pair, first tile, tiles): every
    sequence's ``seq_tiles[b]`` tiles cut into chunks of ``w`` tiles, one
    unit a chunk and kv head in (b, chunk, h) order, pair = b Hkv + h.
    ``w`` is the fewest tiles, at least MIN_TILES and the even share,
    whose units fit the ``n_blocks`` blocks, when the sequences allow it
    (each adds at most one short chunk a head); unit u's partial goes to
    slot u."""
    tiles = sum(seq_tiles)
    seqs = sum(n > 0 for n in seq_tiles)
    per_head = n_blocks // hkv
    w = max(-(-hkv * tiles // n_blocks), MIN_TILES)
    if per_head > seqs:                   # bisect for the fewest that fit
        hi_w = max(-(-tiles // (per_head - seqs)), w)
        while w < hi_w:
            mid = (w + hi_w) // 2
            if sum(-(-n // mid) for n in seq_tiles) <= per_head:
                hi_w = mid
            else:
                w = mid + 1
    units = []
    for b, n in enumerate(seq_tiles):
        for j in range(-(-n // w)):
            for h in range(hkv):
                units.append((len(units), b * hkv + h, j * w, min(w, n - j * w)))
    return units


def g1_groups(hkv: int, d: int) -> Tuple[int, int]:
    """(hg, phases) of the g = 1 kernel: a block's lane groups (D / 8 lanes
    each, as many as a warp holds whole, G1_WARPS warps) take hg kv heads,
    hg dividing Hkv, times ``phases`` interleaved runs of positions; hg is
    the largest of those that keep the most lane groups busy (zamba2's 32
    heads of D 80: 8 x 3 of 24; whisper's 12 of D 64: 4 x 8 of 32)."""
    groups = G1_WARPS * (32 // (d // G1_LANE))
    _, hg = max((h * (groups // h), h) for h in range(1, min(hkv, groups) + 1)
                   if hkv % h == 0)
    return hg, groups // hg


def g1_grid(batch: int, hkv: int, hg: int, slots: int) -> int:
    """Blocks of a g = 1 launch: every block slot of the card, and at
    least one a (sequence, head group)."""
    return max(slots, batch * (hkv // hg))


def g1_units(n_pos: Sequence[int], hkv: int, hg: int, grid: int
             ) -> Tuple[int, List[Tuple[int, int, int, int, int, int]]]:
    """The g = 1 kernel's unit plan, as (run, units): sequence b's
    ``n_pos[b]`` positions inside the masks cut into chunks of ``run``
    (max(1, ceil(n / run)) chunks: an empty sequence's one unit writes its
    zeros), one unit a chunk and head group in (b, chunk, head group)
    order, as (unit, b, first head, first position, positions, chunks of
    b); positions count from the sequence's first inside the masks.  The
    run is the fewest positions whose units fit the grid, at most
    ``grid // (Hkv / hg)`` chunks a head group; unit u is block u."""
    nhg = hkv // hg
    slots = grid // nhg
    chunks = lambda run: sum(-(-n // run) if n > 0 else 1 for n in n_pos)  # noqa: E731
    total = sum(n_pos)
    lo, hi = max(1, -(-total // slots)), max(1, max(n_pos, default=0))
    if slots > len(n_pos):
        hi = min(hi, max(lo, -(-total // (slots - len(n_pos)))))
    while lo < hi:
        mid = (lo + hi) // 2
        if chunks(mid) <= slots:
            hi = mid
        else:
            lo = mid + 1
    units = []
    for b, n in enumerate(n_pos):
        c = -(-n // lo) if n > 0 else 1
        for j in range(c):
            for h in range(nhg):
                units.append((len(units), b, h * hg, j * lo, max(0, min(lo, n - j * lo)), c))
    return lo, units


def g1_scratch(batch: int, hkv: int, d: int, hg: int, grid: int) -> Tuple[int, int]:
    """(floats, ints) of the g = 1 kernel's scratch: (acc, m, l) of the hg
    heads of every block's unit, and a counter a (sequence, head group);
    sized by the shape alone, not the lengths."""
    return grid * hg * (d + 2), batch * (hkv // hg)


@functools.lru_cache(maxsize=None)
def _g1_slots(index: int, dtype: int) -> int:
    """Block slots of the g = 1 kernel on the card: blocks an SM holds x SMs."""
    fn = _build.library("decode_attn").decode_attention_g1_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    blocks = ctypes.c_int()
    with torch.cuda.device(index):
        code = fn(dtype, ctypes.byref(blocks))
    _build.check_status(code, NAME)
    return blocks.value * _sms(index)


@functools.lru_cache(maxsize=None)
def _g1_plan(index: int, dtype: int, batch: int, hkv: int, d: int):
    """(hg, phases, grid, scratch floats, scratch ints) of a g = 1 shape."""
    hg, phases = g1_groups(hkv, d)
    grid = g1_grid(batch, hkv, hg, _g1_slots(index, dtype))
    return (hg, phases, grid) + g1_scratch(batch, hkv, d, hg, grid)


def g1_launch(q: torch.Tensor) -> Tuple[int, int, int]:
    """(hg, phases, grid) of a g = 1 call on q's card (CUDA tensors)."""
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    return _g1_plan(index, _DTYPES[q.dtype], q.shape[0], q.shape[1], q.shape[3])[:3]


# the g = 1 scratch a (device, stream): partials (float32) and counters
# (int32, zero between launches: the kernel's last unit of a group resets
# its own), grown when a shape needs more
_G1_SCRATCH = {}


def _g1_buffers(device: torch.device, index: int, stream: int, floats: int, ints: int):
    part, counts = _G1_SCRATCH.get((index, stream), (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if counts is None or counts.numel() < ints:
        counts = torch.zeros(max(ints, 1), dtype=torch.int32, device=device)
    _G1_SCRATCH[(index, stream)] = (part, counts)
    return part, counts


def scratch_floats(n_pairs: int, g: int, d: int, n_blocks: int) -> int:
    """Floats of the split's scratch: (acc, m, l) of every unit's slot (at
    most n_blocks + pairs of them) for the rows one launch holds, and each
    pair's first slot and chunks; none with one block a pair."""
    if n_blocks == 0:
        return 0
    return (n_blocks + n_pairs) * min(g, MAX_ROWS) * (d + 2) + 2 * n_pairs


def _check(q, k, v, lengths) -> None:
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or v.shape != ks or ks[0] != qs[0] \
            or ks[1] != qs[1] or ks[3] != qs[3]:
        raise ValueError(f"q [B, Hkv, g, D] and k, v [B, Hkv, S, D] expected, got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (qs[0],):
        raise ValueError(f"lengths must be int32 [{qs[0]}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev or lengths.device != dev:
        raise ValueError("all operands must lie on one device")


def _check_kernel_layout(q, k, v, lengths) -> None:
    """What the kernel reads: rows in 16-byte copies, D a multiple of 8."""
    d = q.shape[3]
    if d % 8 or d > MAX_D:
        raise ValueError(f"head dim must be a multiple of 8 up to {MAX_D}, got {d}")
    if not q.is_contiguous() or not lengths.is_contiguous():
        raise ValueError("q and lengths must be contiguous")
    per16 = 16 // q.element_size()
    for name, st in (("k", k.stride()), ("v", v.stride())):
        if st[3] != 1 or st[0] % per16 or st[1] % per16 or st[2] % per16:
            raise ValueError(f"{name} needs a unit stride along D and 16-byte "
                             f"aligned rows, got strides {st}")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q, k, v must start on a 16-byte boundary")
    b, hkv, g, _ = q.shape
    if k.shape[2] > _INT32_MAX or b > 65535 or hkv > 65535 \
            or b * hkv * min(g, MAX_ROWS) > _INT32_MAX:
        raise ValueError(f"shape out of the kernel's range: {tuple(k.shape)}, g {g}")


def masked_rows(k: torch.Tensor, lengths: torch.Tensor, window: int = 0,
                span=None) -> int:
    """k/v rows inside the masks, summed over the batch: ``span`` (the
    host's count of every sequence's valid positions, decode steps being
    aligned) when given, else the lengths read from their device; on
    ``meta`` with no span, every row of the cache."""
    b, seq = k.shape[0], k.shape[2]
    if span is not None:
        per = min(int(span), seq)
        return b * (min(per, window) if window > 0 else per)
    if lengths.device.type == "meta":
        return b * (min(seq, window) if window > 0 else seq)
    n = lengths.to(torch.int64).clamp(0, seq)
    if window > 0:
        n = n.clamp(max=window)
    return int(n.sum())


def declared_work(q, k, lengths, window: int = 0, span=None):
    """``(flops, bytes read, bytes written)`` of a call: QK^T and PV over
    the rows inside the masks, q, those k/v rows and the lengths read
    once, the float32 output written once (``chip_smoke.py``'s bound)."""
    b, hkv, g, d = q.shape
    rows = masked_rows(k, lengths, window, span)
    read = (q.numel() * q.element_size() + 2 * rows * hkv * d * k.element_size()
            + lengths.numel() * lengths.element_size())
    return 4.0 * rows * hkv * g * d, read, b * hkv * g * d * 4


def decode_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lengths: torch.Tensor, *, scale: float,
                             softcap: float = 0.0, window: int = 0,
                             span=None) -> torch.Tensor:
    """One new token per sequence over its cache; see the module docstring.
    ``span``: the host's count of valid positions, when every sequence
    holds the same (it only sizes the declared work)."""
    _check(q, k, v, lengths)
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = none), got {window}")
    with op_analysis.kernel(NAME, lambda: declared_work(q, k, lengths, window, span)):
        return _dispatch(q, k, v, lengths, scale, softcap, window)


def _dispatch(q, k, v, lengths, scale, softcap, window) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, scale=scale,
                                    softcap=softcap, window=window)
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=torch.float32, device="meta")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_layout(q, k, v, lengths)
    b, hkv, g, d = q.shape
    if g == 1:
        return _dispatch_g1(q, k, v, lengths, scale, softcap, window)
    seq = k.shape[2]
    n_blocks = launch_blocks(q, k, window)
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    part = torch.empty(scratch_floats(b * hkv, g, d, n_blocks), dtype=torch.float32,
                       device=q.device) if n_blocks else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 _DTYPES[q.dtype], *k.stride()[:3], *v.stride()[:3],
                 out.data_ptr(), part.data_ptr() if n_blocks else None, b, hkv, g, seq, d,
                 window, n_blocks, float(scale), float(softcap), stream)
    _build.check_status(code, NAME)
    _build.launches[NAME] += 1
    return out


def _dispatch_g1(q, k, v, lengths, scale, softcap, window) -> torch.Tensor:
    b, hkv, _, d = q.shape
    dev = q.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    dtype = _DTYPES[q.dtype]
    hg, phases, grid, floats, ints = _g1_plan(index, dtype, b, hkv, d)
    # the current stream's handle, without the Stream object that
    # torch.cuda.current_stream builds (~4.5 us of a ~35 us call on the card)
    stream = torch._C._cuda_getCurrentRawStream(index)
    part, counts = _g1_buffers(dev, index, stream, floats, ints)
    out = torch.empty((b, hkv, 1, d), dtype=torch.float32, device=dev)
    code = _g1_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), dtype,
                    *k.stride()[:3], *v.stride()[:3], out.data_ptr(), part.data_ptr(),
                    counts.data_ptr(), b, hkv, k.shape[2], d, window, hg, phases, grid,
                    float(scale), float(softcap), stream)
    _build.check_status(code, NAME)
    _build.launches[NAME] += 1
    return out
