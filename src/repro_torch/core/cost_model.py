"""Local-compute format autotuner (BSR vs ELL vs COO).

No single sparse format wins across structures.  Each candidate for the
rank-local compute is scored with a two-term roofline

    t = max(padded_flops / unit_rate, bytes_moved / hbm_bw)

where "padded" counts the work the static layout issues (dense (bm, bn)
tiles for BSR, kmax-padded rows for ELL, nnz-padded triples for COO) and
the unit rate is that of the hardware path executing it.  The program is
bulk-synchronous over ranks, so the decision uses stats maxed over ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class LocalComputeParams:
    """Effective unit rates for the local-compute roofline (f32).

    ``mxu_flops`` rates the dense-block (BSR) product, ``vpu_flops`` the
    gather + FMA (ELL) path, ``scatter_flops`` the scatter-add (COO)
    path.  ``vmem_x_budget`` bounds one rank's packed x operand (bytes,
    times ``min(nv, 128)``); above it ELL is refused.
    """

    name: str = "h100_sxm_local"
    mxu_flops: float = 6.7e13
    vpu_flops: float = 6.7e13
    scatter_flops: float = 1.0e12
    hbm_bw: float = 3.35e12
    vmem_x_budget: int = 50 * 10**6

    def signature(self) -> tuple:
        return dataclasses.astuple(self)


#: NVIDIA H100 SXM (80 GB HBM3 at 3.35 TB/s, 50 MB L2, 67 TFLOP/s f32 on
#: the CUDA cores; NVIDIA's data sheet).  The port's BSR and ELL kernels
#: both run f32 FMAs on the CUDA cores (no tensor cores), so both rate at
#: the f32 peak.  The COO path is ``index_add_`` with atomics, rated far
#: lower.  ``vmem_x_budget`` is set to the 50 MB L2: the ELL kernel
#: gathers x through L2 from device memory (no resident tile as on the
#: TPU), and a rank whose packed x alone overflows L2 would miss on every
#: gather.
H100_LOCAL = LocalComputeParams()

LOCAL_FORMATS = ("bsr", "ell", "coo")


def local_format_times(stats: Dict[str, float],
                       params: LocalComputeParams = H100_LOCAL,
                       nv: int = 1) -> Dict[str, float]:
    """Per-format modeled seconds for one local SpMV application.

    ``stats`` (padded to the max over ranks, per-rank element counts):
      rows_pad   output rows
      n_x        packed x length (v_loc + on-node + off-node buffers)
      nnz_pad    COO triples incl. cross-rank padding
      bsr_blocks padded (bm, bn) tiles incl. cross-rank kmax alignment
      bm, bn     block shape
      ell_kmax   padded ELL slots per row (cross-rank max)
    """
    bm, bn = int(stats["bm"]), int(stats["bn"])
    rows, n_x = stats["rows_pad"], stats["n_x"]
    out_b = 4 * rows * nv

    blocks = stats["bsr_blocks"]
    bsr_flops = 2.0 * blocks * bm * bn * nv
    bsr_bytes = blocks * (bm * bn * 4 + bn * 4 * nv) + out_b
    times = {"bsr": max(bsr_flops / params.mxu_flops,
                        bsr_bytes / params.hbm_bw)}

    kmax = stats["ell_kmax"]
    ell_flops = 2.0 * rows * kmax * nv
    ell_bytes = rows * kmax * 8 + n_x * 4 * nv + out_b
    if n_x * 4 * min(nv, 128) > params.vmem_x_budget:
        times["ell"] = float("inf")
    else:
        times["ell"] = max(ell_flops / params.vpu_flops,
                           ell_bytes / params.hbm_bw)

    nnz = stats["nnz_pad"]
    coo_flops = 2.0 * nnz * nv
    coo_bytes = nnz * 12 + nnz * 4 * nv + out_b
    times["coo"] = max(coo_flops / params.scatter_flops,
                       coo_bytes / params.hbm_bw)
    return times


def choose_local_format(stats: Dict[str, float],
                        params: LocalComputeParams = H100_LOCAL,
                        nv: int = 1) -> str:
    """argmin-time format for the given layout stats."""
    times = local_format_times(stats, params, nv=nv)
    return min(LOCAL_FORMATS, key=lambda f: times[f])
