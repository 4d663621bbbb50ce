"""The assigned input-shape grid (4 shapes x 10 archs = 40 cells).

``decode_*`` / ``long_*`` are one token against a KV cache of ``seq_len``;
``train_4k`` is a training step; ``prefill_32k`` a prefill.  ``long_500k``
requires sub-quadratic attention: it runs for the SSM / hybrid archs
(rwkv6-3b, zamba2-2.7b) and is a documented skip for the pure
full-attention archs.  The JAX package's grid, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# archs whose sequence mixer is sub-quadratic in context (state-space):
SUBQUADRATIC = {"rwkv6-3b", "zamba2-2.7b"}


def cell_runnable(arch: str, shape: str) -> Tuple[bool, Optional[str]]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{arch} is full-attention (documented skip)")
    return True, None


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) of the grid, over the port's registry's ids."""
    from repro_torch.configs import all_arch_ids
    return [(a, s) for a in all_arch_ids() for s in SHAPES]
