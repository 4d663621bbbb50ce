"""The benchmark's fixed arithmetic: the chip's published peaks, the work
of an SpMV apply, its byte floor, and the statistics of a window.

The peaks are copied here so that later changes to the program do not
move the yardstick: ``HBM_BYTES_PER_S`` and ``F32_FLOPS`` from
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F32_FLOPS``), ``BF16_FLOPS``
from ``src/repro_torch/core/roofline.py`` (``H100_SXM``).  All three are
NVIDIA's H100 SXM data sheet figures at the 700 W power limit.
"""
from __future__ import annotations

import math
from typing import Sequence

#: HBM3 bandwidth of one H100 SXM, bytes a second
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores (the SpMV runs f32 FMAs there)
F32_FLOPS = 67e12
#: dense bf16 tensor-core rate
BF16_FLOPS = 989e12

#: float32 operands: 4 bytes a value, a column index and a row offset
F32_BYTES = 4
INDEX_BYTES = 4


def apply_flops(nnz: int, nv: int) -> int:
    """One multiply and one add per nonzero and right-hand side."""
    return 2 * int(nnz) * int(nv)


def apply_floor_bytes(n_rows: int, n_cols: int, nnz: int, nv: int) -> int:
    """The least an apply of the CSR matrix (either direction) moves:
    each nonzero's value and column index once, each row offset once,
    the operand read once and the result written once.  Counted from the
    CSR that the benchmark made, not from the program's padded layout,
    so it reads the same whatever implements the product."""
    return (int(nnz) * (F32_BYTES + INDEX_BYTES) + (int(n_rows) + 1) * INDEX_BYTES
            + F32_BYTES * (int(n_rows) + int(n_cols)) * int(nv))


def floor_seconds(nbytes: float, flops: float = 0.0) -> float:
    """The roofline's least time: bytes at the HBM rate or operations at
    the f32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over all values: the smallest value with at
    least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]
