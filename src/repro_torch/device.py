"""Where the port runs: on the GPU unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` and ``"cuda"`` mean the current CUDA device; ``"cpu"`` is
    the only way off the card (``"meta"``, shapes without memory, is the
    dry run's counting device).  Raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {dev}")
    return dev
