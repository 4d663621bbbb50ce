"""Three-term roofline from an operator count: the port's counterpart of
``repro/core/roofline.py``.

    compute term    = FLOPs per chip / peak FLOP/s
    memory term     = bytes per chip / HBM bandwidth
    collective term = collective bytes per chip / one link's bandwidth

The per-chip numbers come from :mod:`repro_torch.core.op_analysis`.  The
dominant term is the bottleneck and its value the modeled step time;
MODEL_FLOPS / (chips * peak * step time) is the modeled MFU.  The
``wire`` refinement scales ring collectives by 2(g-1)/g (all-reduce) or
(g-1)/g (gather, scatter, all-to-all) over a chip's links together.

The chip's constants come in a :class:`Chip` record: :data:`H100_SXM`,
the default, and :data:`TPU_V5E`, the reference's constants, so that the
port's arithmetic can be held to the reference's field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float       # dense bf16 FLOP/s
    hbm_bw: float           # bytes / s
    link_bw: float          # bytes / s / link, one direction
    links: int              # links a chip drives at once


#: NVIDIA H100 SXM5 80 GB: 989 TFLOP/s dense bf16 and 3.35 TB/s of HBM3
#: (NVIDIA H100 datasheet; PERF.md section 2 and the hopper-kernels
#: guide use them); NVLink 4: 18 links of 25 GB/s each way, 450 GB/s a
#: direction in all (the same datasheet and guide)
H100_SXM = Chip("H100 SXM", 989e12, 3.35e12, 25e9, 18)

#: TPU v5e: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s an ICI link, 4 links
#: usable at once on a 2D torus (``repro/core/roofline.py:26-29``)
TPU_V5E = Chip("TPU v5e", 197e12, 819e9, 50e9, 4)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw per-chip quantities
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_by_kind: Dict[str, float]
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    t_collective_wire: float
    model_flops: float          # 6 * N(_active) * D tokens, GLOBAL
    useful_ratio: float         # MODEL_FLOPS / (flops * chips)
    chip: Chip = H100_SXM

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """The roofline: the largest term (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Modeled model-FLOPs utilisation at the roofline step time."""
        t = self.step_time
        if t == 0:
            return 0.0
        return self.model_flops / (self.chips * self.chip.peak_flops * t)

    @property
    def hardware_util(self) -> float:
        """Share of the step the compute term fills."""
        t = self.step_time
        return self.t_compute / t if t else 0.0

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.t_compute*1e3:9.2f} | {self.t_memory*1e3:9.2f} | "
                f"{self.t_collective*1e3:9.2f} | {self.dominant:10s} | "
                f"{self.model_flops:.3e} | {self.useful_ratio:5.2f} | "
                f"{self.mfu*100:5.1f}% |")


HEADER = ("| arch | shape | mesh | compute ms | memory ms | collective ms | "
          "dominant | MODEL_FLOPS | useful | MFU |\n"
          "|---|---|---|---|---|---|---|---|---|---|")


def _wire_factor(kind: str, group: float) -> float:
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (group - 1) / group
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (group - 1) / group
    return 1.0  # collective-permute


def build_roofline(arch: str, shape: str, mesh_name: str, chips: int, cost,
                   model_flops: float, chip: Chip = H100_SXM) -> Roofline:
    """``cost``: per-chip figures with ``OpCost``'s (or ``HLOCost``'s)
    fields."""
    coll = cost.total_collective_bytes
    wire = 0.0
    for kind, b in cost.collective_bytes.items():
        sizes = cost.group_sizes.get(kind, [])
        g = (sum(sizes) / len(sizes)) if sizes else chips
        wire += b * _wire_factor(kind, g)
    flops = cost.dot_flops
    global_flops = flops * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops=flops, hbm_bytes=cost.hbm_bytes, collective_bytes=coll,
        collective_by_kind=dict(cost.collective_bytes),
        t_compute=flops / chip.peak_flops,
        t_memory=cost.hbm_bytes / chip.hbm_bw,
        t_collective=coll / chip.link_bw,
        t_collective_wire=wire / (chip.link_bw * chip.links),
        model_flops=model_flops,
        useful_ratio=(model_flops / global_flops) if global_flops else 0.0,
        chip=chip,
    )


def model_flops_for(kind: str, n_active_params: int, tokens: int) -> float:
    """MODEL_FLOPS: 6*N*D for training; 2*N*D for inference (fwd only)."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_active_params * tokens
