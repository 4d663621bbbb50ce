"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``).

``launches`` counts launches per wrapper; ``build_all`` compiles every
source at once (otherwise the first launch does).
"""
from repro_torch.kernels._build import build_all, launches, reset_launches

__all__ = ["build_all", "launches", "reset_launches"]
