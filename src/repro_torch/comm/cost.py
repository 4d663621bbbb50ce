"""Slot-granular planned traffic for the comm-strategy chooser.

The rank-batched programs pad every message of an exchange phase to the
phase's largest message, so the bytes a strategy *injects* differ from
the bytes it *needs* to move.  :func:`planned_traffic` costs a plan the
way the program runs it: per phase, each existing (src, dst) message is
charged the phase pad; absent slots cost nothing (the full-buffer view
is ``padded_traffic`` on the compiled plan).  With integrity on, each
phase also ships one u32 checksum per message slot and rank.  Its
payload feeds :func:`repro_torch.core.cost_model.postal_comm_time`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.comm.multistep import MultistepPlan
from repro_torch.core.comm_graph import NAPPlan, StandardPlan

#: bytes of the checksum side channel per message slot (one u32).
_CHECKSUM_BYTES_PER_SLOT = 4


def _phase_entry(send_lists: Sequence[List], recv_lists: Sequence[List],
                 pad: int, inter: bool, bytes_per_val: int, nv: int,
                 direction: str, n_slots: int, integrity: str) -> Dict:
    """One exchange phase.  ``pad`` is the phase's slot size in values;
    ``direction`` picks whose buffers set the per-rank maxima (the
    transpose reverses every message, so the forward receiver becomes the
    bottleneck sender).  Totals are direction-independent.  With
    ``integrity`` on, a phase that carries messages also ships ``n_slots``
    checksum words, whether or not a slot carries data."""
    rank_lists = send_lists if direction == "forward" else recv_lists
    bpv = bytes_per_val * nv
    n_msgs = sum(len(msgs) for msgs in send_lists)
    effective = sum(m.size for msgs in send_lists for m in msgs) * bpv
    return {
        "n_msgs": int(n_msgs),
        "pad": int(pad),
        "effective_bytes": int(effective),
        "padded_bytes": int(n_msgs * pad * bpv),
        "max_rank_msgs": int(max((len(msgs) for msgs in rank_lists), default=0)),
        "max_rank_padded_bytes": int(max(
            (len(msgs) * pad * bpv for msgs in rank_lists), default=0)),
        "checksum_bytes": int(n_slots * _CHECKSUM_BYTES_PER_SLOT
                              if integrity != "off" and n_msgs > 0 else 0),
        "inter": bool(inter),
    }


def _pad_of(send_lists: Sequence[List]) -> int:
    return max((m.size for msgs in send_lists for m in msgs), default=1) or 1


def _split_pair(plan: StandardPlan):
    """The flat pair exchange's messages split into inter- and intra-node
    lists (sends and recvs); both keep the pad the program shares."""
    topo = plan.topology
    n = topo.n_procs
    s_inter: List[List] = [[] for _ in range(n)]
    s_intra: List[List] = [[] for _ in range(n)]
    r_inter: List[List] = [[] for _ in range(n)]
    r_intra: List[List] = [[] for _ in range(n)]
    for r in range(n):
        for m in plan.sends[r]:
            (s_intra if topo.same_node(m.src, m.dst) else s_inter)[r].append(m)
        for m in plan.recvs[r]:
            (r_intra if topo.same_node(m.src, m.dst) else r_inter)[r].append(m)
    return s_inter, s_intra, r_inter, r_intra


def planned_traffic(plan, bytes_per_val: int = 4, nv: int = 1,
                    direction: str = "forward",
                    integrity: str = "off", wire_dtype: str = "f32") -> Dict:
    """Phase-by-phase injected traffic of a Standard / NAP / Multistep plan.

    ``wire_dtype`` (``"f32"``, ``"bf16"`` or ``"fp8_e4m3"``) charges the
    quantized payload width of :mod:`repro_torch.moe.wire` in place of
    ``bytes_per_val``; the checksum side channel stays one u32 per slot,
    since checksums are taken over the quantized words.

    Returns ``{"strategy", "direction", "wire_dtype", "bytes_per_val", "phases":
    {name: entry}, "injected_inter_bytes", "effective_inter_bytes",
    "injected_intra_bytes", "effective_intra_bytes"}``; each phase entry
    carries padded and effective totals, per-rank maxima for the
    direction, the integrity side channel's bytes (``checksum_bytes``,
    counted into the injected totals) and an ``inter`` flag.
    """
    if direction not in ("forward", "transpose"):
        raise ValueError(f"unknown direction {direction!r}")
    if wire_dtype != "f32":
        from repro_torch.moe.wire import wire_bytes
        bytes_per_val = wire_bytes(wire_dtype)
    phases: Dict[str, Dict] = {}

    topo = plan.topology

    def entry(sends, recvs, pad, inter, n_slots):
        return _phase_entry(sends, recvs, pad, inter, bytes_per_val, nv,
                            direction, n_slots, integrity)

    def nap_phases(nap: NAPPlan) -> None:
        for name, sends, recvs, inter, n_slots in (
                ("full", nap.local_full_sends, nap.local_full_recvs, False, topo.ppn),
                ("init", nap.local_init_sends, nap.local_init_recvs, False, topo.ppn),
                ("inter", nap.inter_sends, nap.inter_recvs, True, topo.n_nodes),
                ("final", nap.local_final_sends, nap.local_final_recvs, False,
                 topo.ppn)):
            phases[name] = entry(sends, recvs, _pad_of(sends), inter, n_slots)

    if isinstance(plan, MultistepPlan):
        strategy = "multistep"
        nap_phases(plan.nap)
        phases["direct"] = entry(plan.direct.sends, plan.direct.recvs,
                                 _pad_of(plan.direct.sends), True, topo.n_procs)
    elif isinstance(plan, NAPPlan):
        strategy = "nap"
        nap_phases(plan)
    elif isinstance(plan, StandardPlan):
        strategy = "standard"
        s_inter, s_intra, r_inter, r_intra = _split_pair(plan)
        pad = _pad_of(plan.sends)  # shared across the flat exchange
        phases["pair_inter"] = entry(s_inter, r_inter, pad, True, topo.n_procs)
        phases["pair_intra"] = entry(s_intra, r_intra, pad, False, topo.n_procs)
    else:
        raise TypeError(f"unsupported plan type {type(plan).__name__}")

    def total(key: str, inter: bool) -> int:
        return sum(ph[key] for ph in phases.values() if ph["inter"] is inter)

    return {
        "strategy": strategy,
        "direction": direction,
        "wire_dtype": wire_dtype,
        "bytes_per_val": int(bytes_per_val),
        "phases": phases,
        "injected_inter_bytes": total("padded_bytes", True)
        + total("checksum_bytes", True),
        "effective_inter_bytes": total("effective_bytes", True),
        "injected_intra_bytes": total("padded_bytes", False)
        + total("checksum_bytes", False),
        "effective_intra_bytes": total("effective_bytes", False),
    }
