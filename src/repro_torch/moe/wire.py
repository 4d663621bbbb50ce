"""Quantized wire codecs of the MoE dispatch.

The node-aware exchange cuts inter-node traffic by sending each value
once per destination node; this module cuts the bytes of the value
itself.  A dispatch payload is encoded to a narrow wire dtype at the
pack boundary (the gateway that builds the per-destination buffer),
ships through every hop in that form, and is decoded on the receive
side before any accumulation.

Wire dtypes::

    f32       4 B/value  identity codec: nothing is cast
    bf16      2 B/value  round-to-nearest-even bfloat16
    fp8_e4m3  1 B/value  float8 e4m3fn, clipped to +-FP8_MAX before the
                         cast (e4m3fn has no inf; out of range is NaN)

Two codecs compute the same words:

* :func:`encode_np` / :func:`decode_np`, numpy on the host (the float64
  simulators, :class:`QuantSimWire`, the oracles).  They round with
  integer arithmetic on the float32 bit pattern, as the reference's
  ml_dtypes casts do (a float64 input rounds to float32 first), and
  return the wire WORDS: ``uint16`` for bf16, ``uint8`` for fp8.
* :func:`encode_torch` / :func:`decode_torch`, the casts of the
  device island (``torch.bfloat16``, ``torch.float8_e4m3fn``), with the
  fp8 clip made explicit rather than left to the cast.

For every non-NaN input both give the same word; a NaN input gives a
NaN word in both, but its bits are the implementation's (the numpy
codec gives the canonical quiet NaN with the input's sign, as the
reference's ml_dtypes casts do).

Error model: one encode/decode roundtrip perturbs ``x`` by at most
``u * |x| + d`` with ``u`` the wire dtype's unit roundoff and ``d`` half
its smallest subnormal step; a dispatch-sum whose payloads crossed the
wire ``hops`` times is off by at most ``hops * (u * (|W| @ |x|) + d *
(|W| @ 1))`` (:func:`dispatch_error_budget`).  Encoding is idempotent,
so relaying wire words adds nothing; only re-accumulation points (the
nap combine's gather-back at the pod gateway) count as extra hops.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.integrity import (Mismatch, MessageFault, SimWire,
                                        checksum_np, corrupt_payload_np,
                                        scope_for)

__all__ = [
    "WIRE_DTYPES", "FP8_MAX", "check_wire_dtype", "wire_bytes", "wire_eps",
    "encode_np", "decode_np", "quantize_np", "codec_sweep", "torch_wire_dtype",
    "encode_torch", "decode_torch", "wire_error_bound",
    "dispatch_error_budget", "corrupt_wire_np", "QuantSimWire", "make_wire",
]

#: Supported wire encodings, widest first.
WIRE_DTYPES: Tuple[str, ...] = ("f32", "bf16", "fp8_e4m3")

#: Largest finite float8_e4m3fn magnitude; encode clips to it.
FP8_MAX = 448.0

_WIRE_BYTES: Dict[str, int] = {"f32": 4, "bf16": 2, "fp8_e4m3": 1}

#: (unit roundoff u, half min-subnormal d) per wire dtype; f32 adds none.
_WIRE_EPS: Dict[str, Tuple[float, float]] = {
    "f32": (0.0, 0.0),
    "bf16": (2.0 ** -8, 0.0),
    "fp8_e4m3": (2.0 ** -4, 2.0 ** -10),
}


def check_wire_dtype(wire_dtype: str) -> str:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be one of {'|'.join(WIRE_DTYPES)}, "
            f"got {wire_dtype!r}")
    return wire_dtype


def wire_bytes(wire_dtype: str) -> int:
    """Bytes per value on the wire (what planned_traffic charges)."""
    return _WIRE_BYTES[check_wire_dtype(wire_dtype)]


def wire_eps(wire_dtype: str) -> Tuple[float, float]:
    """(unit roundoff, half min-subnormal) of one encode/decode roundtrip."""
    return _WIRE_EPS[check_wire_dtype(wire_dtype)]


# ---------------------------------------------------------------------------
# numpy codecs (simulators, oracles)
# ---------------------------------------------------------------------------

def _bf16_words(x32: np.ndarray) -> np.ndarray:
    bits = x32.view(np.uint32).astype(np.uint64)
    nan = np.isnan(x32)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    quiet = ((bits >> 16) & 0x8000) | 0x7FC0
    return np.where(nan, quiet, rounded).astype(np.uint16)


def _fp8_words(x32: np.ndarray) -> np.ndarray:
    """float32 (already clipped to +-FP8_MAX) -> e4m3fn words, RNE."""
    a = np.abs(x32.astype(np.float64))
    sign = np.signbit(x32).astype(np.uint8) << 7
    nan = np.isnan(a)
    a = np.where(nan, 0.0, a)
    _, e2 = np.frexp(a)                      # a = f * 2**e2, f in [0.5, 1)
    e = np.maximum(e2 - 1, -6)               # binade; subnormals share -6
    step = np.ldexp(1.0, e - 3)              # 3 mantissa bits
    q = np.rint(a / step) * step             # exact: division by 2**k
    _, qe2 = np.frexp(q)
    normal = q >= 2.0 ** -6
    qe = np.where(normal, qe2 - 1, -6)
    mant = np.where(normal, q / np.ldexp(1.0, qe - 3) - 8, q / 2.0 ** -9)
    field = np.where(normal, qe + 7, 0)
    words = (field.astype(np.uint8) << 3) | mant.astype(np.uint8)
    return np.where(nan, 0x7F, words).astype(np.uint8) | sign


def _fp8_table() -> np.ndarray:
    w = np.arange(256)
    field, mant = (w >> 3) & 0xF, w & 0x7
    mag = np.where(field == 0, mant * 2.0 ** -9,
                   (1.0 + mant / 8.0) * np.ldexp(1.0, field - 7))
    mag = np.where((field == 0xF) & (mant == 0x7), np.nan, mag)
    return np.where(w & 0x80, -mag, mag)


_FP8_VALUES = _fp8_table()


def encode_np(values: np.ndarray, wire_dtype: str) -> np.ndarray:
    """Encode a float payload into its wire words (``uint16`` for bf16,
    ``uint8`` for fp8).  ``f32`` returns the input untouched."""
    check_wire_dtype(wire_dtype)
    if wire_dtype == "f32":
        return values
    v = np.asarray(values)
    with np.errstate(over="ignore", invalid="ignore"):
        if wire_dtype == "fp8_e4m3":
            return _fp8_words(np.clip(v, -FP8_MAX, FP8_MAX).astype(np.float32))
        return _bf16_words(v.astype(np.float32))


def decode_np(wire_values: np.ndarray, wire_dtype: str,
              out_dtype=np.float64) -> np.ndarray:
    """Decode wire words to an accumulation dtype (float64 by default:
    the simulators accumulate at full width)."""
    check_wire_dtype(wire_dtype)
    if wire_dtype == "f32":
        return wire_values
    w = np.asarray(wire_values)
    if wire_dtype == "bf16":
        x = (w.astype(np.uint32) << 16).view(np.float32)
    else:
        x = _FP8_VALUES[w]
    return x.astype(out_dtype)


def quantize_np(values: np.ndarray, wire_dtype: str) -> np.ndarray:
    """One encode/decode roundtrip in the input's own dtype: what a
    receiver accumulates after the payload crossed the wire once."""
    if wire_dtype == "f32":
        return values
    v = np.asarray(values)
    return decode_np(encode_np(v, wire_dtype), wire_dtype, out_dtype=v.dtype)


def codec_sweep(seed: int = 0) -> Dict[str, np.ndarray]:
    """The inputs the codecs are held over, by name: every bfloat16 value
    and the midpoints between neighbours, every finite fp8 value, the
    midpoints between neighbours and the subnormal steps, the specials
    (+-inf, NaN, signed zeros, the edges of both ranges), +-449 to
    +-1e30, and seeded float32 and float64 draws over 2**-43 .. 2**43."""
    bf16 = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    mids = ((np.arange((1 << 16) - 1, dtype=np.uint32) << 16)
            + 0x8000).view(np.float32)
    fp8 = np.sort(_FP8_VALUES[np.isfinite(_FP8_VALUES)])
    fp8_mid = (fp8[1:] + fp8[:-1]) / 2
    sub = np.arange(-16, 17) * 2.0 ** -10
    specials = np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0,
                         FP8_MAX, -FP8_MAX, 464.0, -464.0, 2.0 ** -6,
                         2.0 ** -9, 2.0 ** -10, 3.3895e38, 3.4e38, -3.4e38,
                         1e39, -1e39, 1e-40, -1e-45])
    big = np.geomspace(449.0, 1e30, 256)
    rng = np.random.default_rng(seed)
    draw = rng.standard_normal(1 << 16) * np.exp2(rng.uniform(-43, 43, 1 << 16))
    return {"bf16_values": bf16, "bf16_midpoints": mids,
            "fp8_values": fp8.astype(np.float32),
            "fp8_midpoints": np.concatenate([fp8_mid, -fp8_mid]).astype(np.float32),
            "fp8_subnormals": sub.astype(np.float32), "specials": specials,
            "out_of_range": np.concatenate([big, -big]).astype(np.float32),
            "random_f32": draw.astype(np.float32), "random_f64": draw}


# ---------------------------------------------------------------------------
# torch codecs (the device island)
# ---------------------------------------------------------------------------

def torch_wire_dtype(wire_dtype: str) -> Optional[torch.dtype]:
    """The torch dtype a wire encoding ships as (None for the f32
    identity)."""
    check_wire_dtype(wire_dtype)
    return {"f32": None, "bf16": torch.bfloat16,
            "fp8_e4m3": torch.float8_e4m3fn}[wire_dtype]


def encode_torch(x: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """Encode at the pack boundary.  ``f32`` inserts nothing; fp8 clips
    to +-FP8_MAX before the cast, whatever the cast does out of range."""
    wd = torch_wire_dtype(wire_dtype)
    if wd is None:
        return x
    if wire_dtype == "fp8_e4m3":
        x = x.clamp(-FP8_MAX, FP8_MAX)
    return x.to(wd)


def decode_torch(q: torch.Tensor, wire_dtype: str,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode and promote to the accumulation dtype (float32 by default)."""
    if wire_dtype == "f32":
        return q
    return q.to(out_dtype)


# ---------------------------------------------------------------------------
# error-budget oracles
# ---------------------------------------------------------------------------

def wire_error_bound(cfg=None, *, wire_dtype: Optional[str] = None,
                     hops: Optional[int] = None) -> float:
    """Scalar relative budget of a quantized dispatch against its f32-wire
    result, relative to the dispatched mass: ``hops * (u + d)``.

    Reads ``cfg.wire_dtype`` and derives hops from ``cfg.moe_dispatch``
    (the nap combine re-accumulates at the pod gateway: 2 hops; flat 1),
    unless ``wire_dtype=`` / ``hops=`` are given."""
    if wire_dtype is None:
        wire_dtype = cfg.wire_dtype
    if hops is None:
        hops = 2 if (cfg is not None
                     and cfg.moe_dispatch in ("nap", "auto")) else 1
    u, d = wire_eps(wire_dtype)
    return float(hops) * (u + d)


def dispatch_error_budget(r, x: np.ndarray, wire_dtype: str,
                          hops: int = 1) -> np.ndarray:
    """Elementwise budget of a dispatch-sum ``y = R @ x`` whose payloads
    crossed the wire ``hops`` times: ``hops * (u * (|R| @ |x|) + d *
    (|R| @ 1)) + 1e-12``, shaped like ``R @ x`` (``x`` is ``[T]`` or
    ``[T, nv]``; ``r`` the CSR routing matrix)."""
    u, d = wire_eps(wire_dtype)
    r_abs = dataclasses.replace(r, data=np.abs(r.data))
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        m = r_abs.matvec(np.abs(x))
    else:
        m = np.stack([r_abs.matvec(np.abs(x[:, i])) for i in range(x.shape[1])],
                     axis=1)
    ones = r_abs.matvec(np.ones(r.shape[1]))
    wmass = ones if x.ndim == 1 else ones[:, None]
    return float(hops) * (u * m + d * wmass) + 1e-12


# ---------------------------------------------------------------------------
# integrity over quantized words
# ---------------------------------------------------------------------------

def corrupt_wire_np(wire_values: np.ndarray, kind: str, element: int = 0,
                    bit: int = 0,
                    other: Optional[np.ndarray] = None) -> np.ndarray:
    """A scripted fault applied to the wire words (what travels).  A
    ``bitflip`` flips a bit of the element's own word: 16 bits wide for
    bf16, 8 for fp8, the float's width for the f32 identity."""
    v = np.array(wire_values, copy=True)
    if kind != "bitflip":
        return corrupt_payload_np(v, kind, element, bit, other=other)
    flat = v.reshape(-1)
    e = int(element) % max(flat.size, 1)
    width = flat.dtype.itemsize * 8
    word = flat[e: e + 1].view({8: np.uint8, 16: np.uint16,
                                32: np.uint32, 64: np.uint64}[width])
    word ^= word.dtype.type(1) << word.dtype.type(int(bit) % width)
    return v


class QuantSimWire(SimWire):
    """Quantizing wire of the numpy message simulators.

    ``send`` encodes the payload, checksums the wire WORDS, applies a
    matching scripted fault to them and hands the decoded values to the
    mailbox; ``recv`` re-encodes what arrived (idempotent: the same
    words, corrupted ones included) and compares checksums.  So detect
    and recover attribute and retry quantized messages as they do f32
    ones, with one u32 per message."""

    def __init__(self, topo, wire_dtype: str,
                 faults: Sequence[MessageFault] = ()) -> None:
        super().__init__(topo, faults)
        self.wire_dtype = check_wire_dtype(wire_dtype)

    def send(self, phase: str, msg, values: np.ndarray) -> np.ndarray:
        q = encode_np(values, self.wire_dtype)
        self.sent[(phase, msg.src, msg.dst)] = checksum_np(q)
        fault = self._match(phase, msg.src, msg.dst)
        prev = self.last_payload.get((phase, msg.src))
        self.last_payload[(phase, msg.src)] = np.array(q, copy=True)
        if fault is not None:
            self.injected += 1
            q = corrupt_wire_np(q, fault.kind, fault.element, fault.bit,
                                other=prev)
        return decode_np(q, self.wire_dtype,
                         out_dtype=np.asarray(values).dtype)

    def recv(self, phase: str, msg, values: np.ndarray) -> None:
        self.checks += 1
        q = encode_np(values, self.wire_dtype)
        if checksum_np(q) == self.sent[(phase, msg.src, msg.dst)]:
            return
        topo = self.topo
        slot = (topo.node_of(msg.src) if phase == "inter"
                else msg.src if phase in ("pair", "direct")
                else topo.local_of(msg.src))
        self.mismatches.append(Mismatch(
            check="wire", phase=phase,
            scope=scope_for(phase, topo.node_of(msg.dst),
                            topo.local_of(msg.dst), slot, topo.ppn),
            node=topo.node_of(msg.dst), proc=topo.local_of(msg.dst),
            slot=slot, direction="forward"))


def make_wire(topo, wire_dtype: str, faults: Sequence[MessageFault] = (),
              force: bool = False) -> Optional[SimWire]:
    """The wire a simulate apply threads through its mailboxes: None for
    f32 without faults or integrity (the uninstrumented simulators), the
    plain :class:`SimWire` for f32 with either, and the quantizing wire
    for a narrow dtype always."""
    check_wire_dtype(wire_dtype)
    if wire_dtype == "f32":
        return SimWire(topo, faults) if (faults or force) else None
    return QuantSimWire(topo, wire_dtype, faults)
