"""Communication models (paper Sec. 3) and the local-compute format
autotuner.

**Message models**, costing a plan's messages on a two-level machine:

* Eq. (10): max-rate model for inter-node messages
      T = alpha + ppn*s / min(B_N, B_max + (ppn-1) * B_inj)
* Eq. (11): postal model (the ppn = 1 case)
* Eq. (12): intra-node model  T_l = alpha_l + s_l / B_max_l
* :func:`multistep_cost` adds the multi-step plan's direct exchange;
  :func:`postal_comm_time` is the comm chooser's alpha-beta tie-break
  over padded slots (:data:`BLUE_WATERS_POSTAL`)

with short / eager / rendezvous protocols chosen by message size (512 B
and 8 KiB cutoffs, MPICH-on-Gemini's conventional values; the paper does
not state Blue Waters').  :data:`BLUE_WATERS` holds the paper's Tables 3
and 4: a Cray XE6 / Gemini machine, so its outputs are modeled times of
that machine, not of the GPU the port runs on.

**Format autotuner** (BSR vs ELL vs COO).  No single sparse format wins
across structures.  Each candidate for the rank-local compute is scored
with a two-term roofline

    t = max(padded_flops / unit_rate, bytes_moved / hbm_bw)

where "padded" counts the work the static layout issues (dense (bm, bn)
tiles for BSR, kmax-padded rows for ELL, nnz-padded triples for COO) and
the unit rate is that of the hardware path executing it.  The program is
bulk-synchronous over ranks, so the decision uses stats maxed over ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.comm_graph import Message, NAPPlan, StandardPlan

SHORT_CUTOFF = 512        # bytes
EAGER_CUTOFF = 8 * 1024   # bytes


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    alpha: float   # start-up latency (s)
    b_inj: float   # per-node injection rate (B/s)
    b_max: float   # per-process achievable rate (B/s)
    b_n: float     # NIC peak (B/s)


@dataclasses.dataclass(frozen=True)
class LocalParams:
    alpha: float
    b_max: float


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Two-level machine: inter-node (max-rate) + intra-node (postal)."""

    name: str
    inter: Dict[str, ProtocolParams]  # keyed by protocol
    intra: Dict[str, LocalParams]
    short_cutoff: int = SHORT_CUTOFF
    eager_cutoff: int = EAGER_CUTOFF

    def protocol(self, nbytes: int) -> str:
        if nbytes <= self.short_cutoff:
            return "short"
        if nbytes <= self.eager_cutoff:
            return "eager"
        return "rend"


#: Paper Table 3 (inter) and Table 4 (intra): Blue Waters, Cray XE / Gemini.
BLUE_WATERS = MachineParams(
    name="blue_waters",
    inter={
        "short": ProtocolParams(alpha=4.0e-6, b_inj=6.3e8, b_max=1.8e7, b_n=float("inf")),
        "eager": ProtocolParams(alpha=1.1e-5, b_inj=1.7e9, b_max=6.2e7, b_n=float("inf")),
        "rend": ProtocolParams(alpha=2.0e-5, b_inj=3.6e9, b_max=6.1e8, b_n=5.5e9),
    },
    intra={
        "short": LocalParams(alpha=1.3e-6, b_max=4.2e8),
        "eager": LocalParams(alpha=1.6e-6, b_max=7.4e8),
        "rend": LocalParams(alpha=4.2e-6, b_max=3.1e9),
    },
)


def inter_node_time(nbytes: int, ppn: int, machine: MachineParams) -> float:
    """Eq. (10) max-rate model for one inter-node message of ``nbytes``."""
    p = machine.inter[machine.protocol(nbytes)]
    if ppn == 1:
        return p.alpha + nbytes / p.b_max  # Eq. (11), postal model
    rate = min(p.b_n, p.b_max + (ppn - 1) * p.b_inj)
    return p.alpha + (ppn * nbytes) / rate


def intra_node_time(nbytes: int, machine: MachineParams) -> float:
    """Eq. (12) intra-node postal model."""
    p = machine.intra[machine.protocol(nbytes)]
    return p.alpha + nbytes / p.b_max


def _rank_phase_time(msgs: List[Message], machine: MachineParams, ppn: int,
                     inter: bool, bytes_per_val: int = 8) -> float:
    """One rank's messages of one phase: each pays its start-up plus its
    bytes at the phase's rate, one after another."""
    t = 0.0
    for m in msgs:
        nbytes = m.size * bytes_per_val
        t += inter_node_time(nbytes, ppn, machine) if inter else intra_node_time(nbytes, machine)
    return t


def standard_cost(plan: StandardPlan, machine: MachineParams,
                  bytes_per_val: int = 8) -> Dict[str, float]:
    """Algorithm 1: every rank sends all its messages at once, so its
    inter- and intra-node times add and the slowest rank sets the total."""
    topo = plan.topology
    inter_t, intra_t = [], []
    for r in range(topo.n_procs):
        inter_msgs = [m for m in plan.sends[r] if not topo.same_node(m.src, m.dst)]
        intra_msgs = [m for m in plan.sends[r] if topo.same_node(m.src, m.dst)]
        inter_t.append(_rank_phase_time(inter_msgs, machine, topo.ppn, True, bytes_per_val))
        intra_t.append(_rank_phase_time(intra_msgs, machine, topo.ppn, False, bytes_per_val))
    return {
        "inter": max(inter_t, default=0.0),
        "intra": max(intra_t, default=0.0),
        "total": max((a + b) for a, b in zip(inter_t, intra_t)) if inter_t else 0.0,
    }


def nap_cost(plan: NAPPlan, machine: MachineParams,
             bytes_per_val: int = 8) -> Dict[str, float]:
    """Algorithm 3: init -> inter -> final run in sequence, the fully
    local exchange overlaps the inter-node phase; each phase is charged
    at its slowest rank."""
    topo = plan.topology
    phases = {
        "intra_init": (plan.local_init_sends, False),
        "inter": (plan.inter_sends, True),
        "intra_final": (plan.local_final_sends, False),
        "intra_full": (plan.local_full_sends, False),
    }
    out: Dict[str, float] = {}
    for name, (sends, is_inter) in phases.items():
        per_rank = [_rank_phase_time(sends[r], machine, topo.ppn, is_inter, bytes_per_val)
                    for r in range(topo.n_procs)]
        out[name] = max(per_rank, default=0.0)
    out["intra"] = out["intra_init"] + out["intra_final"] + out["intra_full"]
    out["total"] = (out["intra_init"] + max(out["inter"], out["intra_full"])
                    + out["intra_final"])
    return out


def multistep_cost(plan, machine: MachineParams,
                   bytes_per_val: int = 8) -> Dict[str, float]:
    """Cost of a :class:`repro_torch.comm.multistep.MultistepPlan`: the
    NAP sub-plan's phase chain plus the direct exchange, which shares
    the network with (and so serialises against) the aggregated inter
    phase; the fully local exchange still overlaps both."""
    out = nap_cost(plan.nap, machine, bytes_per_val)
    direct = standard_cost(plan.direct, machine, bytes_per_val)
    # every direct message crosses nodes
    out["direct"] = direct["inter"]
    out["inter"] = out["inter"] + direct["inter"]
    out["total"] = (out["intra_init"] + max(out["inter"], out["intra_full"])
                    + out["intra_final"])
    return out


def compute_time(nnz: int, flop_rate: float = 2.0e9) -> float:
    """Local SpMV compute estimate of the paper's CPU ranks: 2 flops per
    nonzero at an effective memory-bound rate (~2 GF/s per core)."""
    return 2.0 * nnz / flop_rate


# ---------------------------------------------------------------------------
# Postal term of the comm-strategy chooser (repro_torch.comm)
# ---------------------------------------------------------------------------
#
# The message models above cost each message at its EFFECTIVE size.  The
# rank-batched programs ship PADDED slots (every message of a phase
# stretches to the phase's largest), so the chooser also needs an
# alpha-beta term over the slot-granular padded bytes of
# ``repro_torch.comm.cost.planned_traffic``.  It only breaks ties: the
# verdict is decided first by injected inter-node bytes.

@dataclasses.dataclass(frozen=True)
class PostalParams:
    """Flat two-level postal model: a start-up alpha per message plus the
    padded bytes at rate beta, for network (inter-node) and intra-node
    hops.  The defaults are the rendezvous rows of :data:`BLUE_WATERS`
    (paper Tables 3-4): start-up and per-process rate of a large message
    between nodes and on a node, a model of that Cray machine, not of the
    GPU; :meth:`calibrated` fits the four constants to measured walls."""

    name: str = "blue_waters_postal"
    alpha_inter: float = BLUE_WATERS.inter["rend"].alpha
    beta_inter: float = BLUE_WATERS.inter["rend"].b_max
    alpha_intra: float = BLUE_WATERS.intra["rend"].alpha
    beta_intra: float = BLUE_WATERS.intra["rend"].b_max

    @classmethod
    def calibrated(cls, walls: List[Dict], name: str = "calibrated"
                   ) -> "PostalParams":
        """Fit the postal constants from MEASURED per-phase exchange walls.

        ``walls`` are records with ``n_msgs`` (bottleneck-rank messages),
        ``nbytes`` (bottleneck-rank padded bytes), ``inter`` (the level)
        and ``seconds``, as :func:`repro_torch.mesh.scaling.
        measure_phase_walls` emits them.  Each level solves the
        least-squares system ``seconds ~ alpha * n_msgs + nbytes / beta``
        over its records.  A level with fewer than two usable records, or
        a fit with a non-positive coefficient (noise at micro-benchmark
        scale), keeps that constant from ``PostalParams()``, so a partial
        calibration degrades to the defaults instead of producing a
        nonsense machine model.
        """
        d = cls()
        fitted = {"inter": (d.alpha_inter, d.beta_inter),
                  "intra": (d.alpha_intra, d.beta_intra)}
        for level in ("inter", "intra"):
            recs = [w for w in walls
                    if bool(w["inter"]) == (level == "inter")
                    and w["n_msgs"] > 0 and w["seconds"] > 0]
            if len(recs) < 2:
                continue
            design = np.array([[r["n_msgs"], r["nbytes"]] for r in recs],
                              dtype=np.float64)
            t = np.array([r["seconds"] for r in recs], dtype=np.float64)
            coef, *_ = np.linalg.lstsq(design, t, rcond=None)
            alpha, inv_beta = float(coef[0]), float(coef[1])
            da, db = fitted[level]
            fitted[level] = (alpha if alpha > 0 else da,
                             1.0 / inv_beta if inv_beta > 0 else db)
        return cls(name=name,
                   alpha_inter=fitted["inter"][0],
                   beta_inter=fitted["inter"][1],
                   alpha_intra=fitted["intra"][0],
                   beta_intra=fitted["intra"][1])


#: :class:`PostalParams` at its defaults: the comm chooser's constants.
BLUE_WATERS_POSTAL = PostalParams()


def postal_phase_time(n_msgs: int, nbytes: float, inter: bool,
                      params: PostalParams = BLUE_WATERS_POSTAL) -> float:
    """alpha-beta time of one exchange phase at one rank: ``n_msgs``
    start-ups plus ``nbytes`` (padded) at the level's rate."""
    if n_msgs == 0:
        return 0.0
    alpha, beta = (params.alpha_inter, params.beta_inter) if inter \
        else (params.alpha_intra, params.beta_intra)
    return n_msgs * alpha + nbytes / beta


def postal_comm_time(traffic: Dict, params: PostalParams = BLUE_WATERS_POSTAL
                     ) -> Dict[str, float]:
    """Modeled seconds of one exchange schedule (a ``planned_traffic``
    payload): phases run one after another, each charged at its
    bottleneck rank's padded bytes plus the integrity side channel when
    armed."""
    out: Dict[str, float] = {}
    total = 0.0
    for name, ph in traffic["phases"].items():
        t = postal_phase_time(ph["max_rank_msgs"],
                              ph["max_rank_padded_bytes"] + ph["checksum_bytes"],
                              ph["inter"], params)
        out[name] = t
        total += t
    out["total"] = total
    return out


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
