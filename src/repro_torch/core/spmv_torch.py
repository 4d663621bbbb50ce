"""Node-aware and standard SpMV on one device: host layout + rank-batched
programs.

**Host layout.**  :func:`compile_nap` turns the node-aware plan of
:mod:`comm_graph` into static index arrays stacked over ranks
(``[n_procs, ...]``), exactly as the plan compiler of the JAX package
does: send/gather maps for the four exchange phases, the three COO
blocks of Algorithm 3, and lazily the ELL (forward and transposed) and
fused BSR formats over the packed x ``[v_loc | b_on_node | b_off_node]``.
Every per-rank buffer is padded to the max over ranks, and the segment
lengths of the packed x are rounded up to the block width bn, so the
segments are bn-aligned views of one packed domain.
:func:`compile_standard` does the same for Algorithm 1: one flat
``[n_procs, n_procs, pair_pad]`` send table and the two-segment packed
x ``[v_loc | recv buffer]``.  :func:`compile_multistep` builds the
node-aware arrays from the multi-step plan's high-duplication share and
adds its direct exchange, which the programs run from its live slots.

**Device program.**  The ``(n_nodes, ppn)`` rank grid is the leading
batch axis of every tensor on ONE device.  A tiled all-to-all is then an
exact axis permutation of the send buffer:

* over ``proc``: send ``[nn, ppn_src, ppn_dst, pad, nv]`` ->
  ``recv[n, j, p] = send[n, p, j]`` (swap axes 1 and 2);
* over ``node``: send ``[nn_src, ppn, nn_dst, pad, nv]`` ->
  ``recv[m, p, n] = send[n, p, m]`` (swap axes 0 and 2);
* over ``("node", "proc")`` (standard): send ``[P_src, P_dst, pad, nv]``
  -> ``recv[r, s] = send[s, r]`` (swap axes 0 and 1), since the ranks
  are ordered node-major.

All are involutions, so the transpose programs re-apply them; they live
in :mod:`repro_torch.mesh.comm`.  In a multi-process job a process owns a
block of whole nodes (``CompiledNAP.mesh``): every process compiles the
whole host layout but stages and runs only its block's ranks, the
``proc`` exchanges stay in the process, and the ``node`` and ``("node",
"proc")`` exchanges cross processes through the communicator.  Gathers
are rank-batched over flat indices (``idx + rank * len``) and the
transpose's scatters are ``index_add_``.  Local compute goes through the
CUDA ELL / fused BSR kernels (their plain versions on CPU tensors) or
the COO ``index_add_`` path.

``local_compute="auto"`` resolves through the format autotuner
(:mod:`cost_model`), whose verdict is recorded on the plan for both
directions.  There is no transposed BSR kernel: a ``"bsr"`` transpose
request defers to the ell/coo verdict.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.multistep import build_multistep_plan, resolve_threshold
from repro_torch.core.comm_graph import (Message, NAPPlan, StandardPlan,
                                         build_nap_plan, build_standard_plan,
                                         lookup_slots)
from repro_torch.core.integrity import (MULTISTEP_MESSAGE_PHASES,
                                        NAP_MESSAGE_PHASES, phase_index)
from repro_torch.core.cost_model import (H100_LOCAL, LOCAL_FORMATS,
                                         LocalComputeParams,
                                         choose_local_format,
                                         local_format_times)
from repro_torch.core.partition import RowPartition
from repro_torch.core.spmv import LocalBlocks, split_all_blocks
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bsr_spmv.fused import fused_bsr_spmm, fused_bsr_spmm_packed
from repro_torch.kernels.ell_spmv.kernel import ell_spmm_packed
from repro_torch.mesh.buffers import ProcessMesh, default_registry, plan_mesh
from repro_torch.mesh.comm import (live_all_to_all, node_all_to_all,
                                   proc_all_to_all, rank_all_to_all)
from repro_torch.sparse.bsr import BSR
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.ell import ELL, stack_ell


def _pad_to(arrs: List[np.ndarray], pad: int, fill: float = 0) -> np.ndarray:
    out = np.full((len(arrs), pad), fill, dtype=arrs[0].dtype if arrs else np.int64)
    for i, a in enumerate(arrs):
        out[i, : a.size] = a
    return out


def _ceil_to(x: int, b: int) -> int:
    return -(-x // b) * b


def _resolve_local_compute(requested: str, compile_requested: str,
                           chosen: str) -> str:
    """Request -> concrete format: an explicit request wins; ``"auto"``
    defers to a format requested at compile time, then to the verdict."""
    if requested == "auto":
        if compile_requested != "auto":
            return compile_requested
        return chosen
    if requested not in LOCAL_FORMATS:
        raise ValueError(requested)
    return requested


def _resolve_transpose_local_compute(requested: str, compile_requested: str,
                                     autotune: Dict[str, object]) -> str:
    """Transpose-direction format: an explicit ``ell``/``coo`` wins;
    ``auto`` and ``bsr`` (no transposed BSR kernel) defer to the
    transpose verdict under ``autotune["transpose"]``."""
    if requested not in ("auto",) + LOCAL_FORMATS:
        raise ValueError(requested)
    for cand in (requested, compile_requested):
        if cand in ("ell", "coo"):
            return cand
    t = autotune.get("transpose", {})
    return str(t.get("chosen", "coo")) if isinstance(t, dict) else "coo"


#: Value tensors of the compiled plans: they derive from the matrix
#: values, so a hot swap (:meth:`CompiledNAP.swap_values`) writes the new
#: values into them in place.  Every other staged tensor is structure.
VALUE_ARRAY_NAMES = frozenset({
    "on_proc_vals", "on_node_vals", "off_node_vals",
    "ell_vals", "ell_t_vals", "fused_blocks", "A_vals",
    "abft_col", "abft_col_abs", "abft_row", "abft_row_abs"})


def _plan_namespace():
    """A fresh buffer namespace for one compiled plan's staged tensors."""
    return default_registry().namespace("spmv-plan")


#: Host arrays that are not stacked over ranks (flat positions over the
#: whole rank-batched domain): a plan that owns a rank block never stages
#: them (its programs use the block forms, :func:`_live_direct_block`).
_FLAT_ARRAY_NAMES = frozenset({"direct_live_src", "direct_live_dst",
                               "direct_live_slot", "direct_live_msg"})


class _Staged:
    """Device staging shared by the compiled plans: ``arrays`` (host
    numpy) become tensors on ``device`` once per name, in ``_tensors``
    (a :class:`repro_torch.mesh.buffers.BufferNamespace` for the SpMV
    plans).  ``builds`` counts the stagings of structure (index)
    tensors: the port's analogue of a program trace, which a hot value
    swap must not add to.

    ``mesh`` (a :class:`repro_torch.mesh.buffers.ProcessMesh`) is set
    when this process owns a block of the ranks of a multi-process job:
    the host arrays stay whole (every process compiles the whole layout)
    and only the block's rows of each ``[n_procs, ...]`` array are staged
    and indexed.  None: the whole layout, one process."""

    arrays: Dict[str, np.ndarray]
    device: torch.device
    _tensors: Dict[object, torch.Tensor]
    builds = 0
    mesh: Optional[ProcessMesh] = None

    @property
    def n_local_procs(self) -> int:
        """Ranks this process batches: the mesh's block, else all."""
        return self.topo.n_procs if self.mesh is None else self.mesh.n_local_procs

    def owned(self, name: str) -> np.ndarray:
        """The host array ``name``, cut to the owned rank block."""
        arr = self.arrays[name]
        if self.mesh is None:
            return arr
        if name in _FLAT_ARRAY_NAMES:
            raise ValueError(f"{name} indexes the whole rank-batched domain; "
                             f"a plan that owns a rank block cannot stage it")
        r0, r1 = self.mesh.ranks
        return arr[r0:r1]

    def _stage(self, key, value):
        if key not in VALUE_ARRAY_NAMES:
            self.builds += 1
        self._tensors[key] = value
        return value

    def tensors(self, names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Device copies of the named host arrays (the owned block's rows),
        staged once per name."""
        for k in names:
            if k not in self._tensors:
                self._stage(k, torch.from_numpy(self.owned(k)).to(self.device))
        return {k: self._tensors[k] for k in names}

    def flat_index(self, name: str, seg_len: int, nv: int = 1) -> torch.Tensor:
        """``arrays[name] + rank * seg_len`` as flat int64: the rank-batched
        row index into a ``[n_procs * seg_len, nv]`` tensor (ranks counted
        from the start of the owned block).  With ``nv > 1`` it is the
        element index ``row * nv + column`` into the flattened tensor
        instead.  Built once per (name, length, nv)."""
        key = (name, seg_len, nv)
        if key not in self._tensors:
            idx = torch.from_numpy(self.owned(name)).to(self.device)
            base = torch.arange(idx.shape[0], device=idx.device,
                                dtype=torch.int64) * seg_len
            flat = (idx.long().reshape(idx.shape[0], -1) + base[:, None]).reshape(-1)
            del idx
            self._stage(key, _elements(flat, nv))
        return self._tensors[key]


@dataclasses.dataclass
class CompiledNAP(_Staged):
    """Static arrays of the node-aware SpMV, stacked over ranks.

    ``part`` is the ROW partition (``rows_pad`` output rows per rank),
    ``col_part`` the COLUMN partition (``cols_pad`` x entries per rank).
    ``arrays`` hold the host (numpy) layout; :meth:`tensors` stages them
    on ``device`` once per name.
    """

    topo: Topology
    part: Optional[RowPartition]
    rows_pad: int
    pads: Dict[str, int]          # full/init/inter/final/bnode/boff/nnz pads
    arrays: Dict[str, np.ndarray]  # stacked [n_procs, ...] index/value arrays
    device: torch.device
    col_part: Optional[RowPartition] = None
    cols_pad: int = 0
    plan: Optional[NAPPlan] = None
    block_shape: Tuple[int, int] = (8, 128)
    # element offsets of the packed BSR x operand, all multiples of bn
    bsr_layout: Dict[str, int] = dataclasses.field(default_factory=dict)
    # rank-local blocks retained for lazy format emission
    local_blocks: Optional[List[LocalBlocks]] = None
    # format autotuner verdict (forward at the top, transpose under
    # "transpose"), its stats and modeled times
    autotune: Dict[str, object] = dataclasses.field(default_factory=dict)
    requested_local_compute: str = "auto"
    ell_kmax: int = 0
    ell_t_kmax: int = 0
    # "multistep": the plan adds the direct exchange (``direct_send``,
    # ``pads["direct"]``) and ``ms_plan`` holds the MultistepPlan, whose
    # NAP sub-plan is ``plan``
    comm: str = "nap"
    ms_plan: Optional[object] = None
    _tensors: Dict[object, torch.Tensor] = dataclasses.field(
        default_factory=_plan_namespace, repr=False, compare=False)
    # the matrix whose VALUES the plan carries (the swap_values target)
    a_ref: Optional[CSR] = dataclasses.field(default=None, repr=False,
                                             compare=False)
    # compile-cache key to retire on a value swap (the cache keys on the
    # original values, which a swapped plan no longer carries)
    _cache_token: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                      compare=False)
    # the owned rank block of a multi-process job (None: every rank)
    mesh: Optional[ProcessMesh] = dataclasses.field(default=None, repr=False,
                                                    compare=False)

    def __post_init__(self) -> None:
        if self.col_part is None:
            self.col_part = self.part
        if not self.cols_pad:
            self.cols_pad = self.rows_pad

    @property
    def chosen_local_compute(self) -> str:
        return str(self.autotune.get("chosen", "coo"))

    @property
    def direct_offset(self) -> int:
        """Where the direct recv slots start in the off-node gather's
        domain ``[inter | final | direct]``."""
        return (self.topo.n_nodes * self.pads["inter"]
                + self.topo.ppn * self.pads["final"])

    def ensure_live_direct(self) -> None:
        """Emit the live-slot form of the direct exchange (lazily, once).

        The literal exchange moves ``[P, P, direct_pad]`` slots, nearly
        all padding.  Composing ``direct_send`` with the recv slots that
        ``boff_gather`` reads gives, for every live value, its source in
        the rank-batched v_loc (``direct_live_src``, flat ``s * cols_pad
        + row``) and its place in the rank-batched off-node buffer
        (``direct_live_dst``, flat ``r * boff_pad + k``), ordered by the
        literal exchange's slots so that the transpose's sums keep its
        order.  ``boff_live_gather`` is ``boff_gather`` with the direct
        entries pointed at one dump slot just past ``[inter | final]``.
        """
        if "boff_live_gather" in self.arrays:
            return
        p, dpad = self.topo.n_procs, self.pads["direct"]
        off = self.direct_offset
        bg = self.arrays["boff_gather"]
        r, k = np.nonzero(bg >= off)
        q = bg[r, k].astype(np.int64) - off
        s = q // dpad
        slot = (s * p + r) * dpad + q % dpad
        order = np.argsort(slot, kind="stable")
        r, k, s, slot = r[order], k[order], s[order], slot[order]
        rows = self.arrays["direct_send"].reshape(-1)[slot].astype(np.int64)
        self.arrays["direct_live_src"] = s * self.cols_pad + rows
        self.arrays["direct_live_dst"] = r * bg.shape[1] + k
        # the same slots in the padded send table [P_src, P_dst, direct_pad]
        # and in the transpose's message table [P_dst, P_src, direct_pad]
        self.arrays["direct_live_slot"] = slot
        self.arrays["direct_live_msg"] = (r * p + s) * dpad + slot % dpad
        self.arrays["boff_live_gather"] = np.where(bg >= off, off, bg).astype(np.int32)

    def resolve_local_compute(self, requested: str) -> str:
        return _resolve_local_compute(requested, self.requested_local_compute,
                                      self.chosen_local_compute)

    def resolve_transpose_local_compute(self, requested: str) -> str:
        return _resolve_transpose_local_compute(
            requested, self.requested_local_compute, self.autotune)

    @property
    def packed_x_len(self) -> int:
        """Element length of the packed [v_loc | b_on_node | b_off_node] x."""
        return self.cols_pad + self.pads["bnode"] + self.pads["boff"]

    def _blocks(self) -> List[LocalBlocks]:
        if self.local_blocks is None:
            raise ValueError("this plan holds no local blocks to emit a format "
                             "from; build it with the format arrays included")
        return self.local_blocks

    def ensure_ell(self) -> None:
        """Emit the packed ELL arrays (lazily, once)."""
        if "ell_cols" in self.arrays:
            return
        cols, vals, kmax = _fused_ell_arrays(
            self._blocks(), self.rows_pad, self.cols_pad,
            self.pads["bnode"], self.pads["boff"])
        self.arrays["ell_cols"] = cols
        self.arrays["ell_vals"] = vals
        self.ell_kmax = kmax

    def ensure_ell_t(self) -> None:
        """Emit the TRANSPOSED packed ELL arrays (lazily, once): A_r^T over
        the packed contribution domain ``[z(cols_pad) | c_on_node |
        c_off_node]`` with x = u_loc."""
        if "ell_t_cols" in self.arrays:
            return
        cols_pad, bnode_pad = self.cols_pad, self.pads["bnode"]
        out_len = self.packed_x_len
        per_rank: List[ELL] = []
        for blk in self._blocks():
            op_r, op_c, op_v = blk.on_proc.to_coo()
            on_r, on_c, on_v = blk.on_node.to_coo()
            off_r, off_c, off_v = blk.off_node.to_coo()
            rows_t = np.concatenate([op_c, cols_pad + on_c,
                                     cols_pad + bnode_pad + off_c])
            cols_t = np.concatenate([op_r, on_r, off_r])
            vals = np.concatenate([op_v, on_v, off_v])
            per_rank.append(ELL.from_coo(rows_t, cols_t, vals,
                                         (out_len, self.rows_pad),
                                         n_rows_pad=out_len))
        cols, vals, kmax = stack_ell(per_rank)
        self.arrays["ell_t_cols"] = cols
        self.arrays["ell_t_vals"] = vals
        self.ell_t_kmax = kmax

    def ensure_abft(self) -> None:
        """Emit the ABFT checksum vectors (lazily, once): per rank the
        COLUMN sums ``c_p = 1^T A_p`` over the packed x domain (forward
        check: ``sum(y_p) == c_p . x_packed``) and the ROW sums ``A_p 1``
        over the output rows (transpose check), with their absolute-value
        twins for the tolerance scale.  Accumulated in float64, in the
        reference's order, from the f32-rounded values the kernels
        multiply, then stored f32.  The hot value swap refreshes them
        with the values."""
        if "abft_col" in self.arrays:
            return
        offs = (0, self.cols_pad, self.cols_pad + self.pads["bnode"])
        _emit_abft(self.arrays, [_packed_coo(blk, offs) for blk in self._blocks()],
                   self.packed_x_len, self.rows_pad)

    def ensure_fused(self) -> None:
        """Emit the fused BSR arrays (lazily, once)."""
        if "fused_cols" in self.arrays:
            return
        bm, bn = self.block_shape
        fc, fb, layout = _fused_bsr_arrays(
            self._blocks(), self.rows_pad, self.cols_pad,
            self.pads["bnode"], self.pads["boff"], bm, bn)
        self.arrays["fused_cols"] = fc
        self.arrays["fused_blocks"] = fb
        self.bsr_layout.update(layout)

    def swap_values(self, a_new: CSR) -> List[str]:
        """Hot-swap the matrix VALUES in place; the sparsity must be
        identical.

        Rebuilds every value array (the COO blocks and each materialised
        lazy format and ABFT vector) against the SAME pads and index
        maps, writes each one that is already staged into its device
        tensor with ``copy_`` (same shape, dtype and ``data_ptr()``;
        index tensors are not touched, so :attr:`builds` stays flat) and
        retires the plan from the compile cache, which keys on the old
        values.  The multi-step plan swaps the same way: its direct
        exchange is structure.  Returns the changed array names.
        """
        check_same_structure(self.a_ref, a_new)
        blocks = split_all_blocks(a_new, self.part, self.topo,
                                  col_part=self.col_part)
        self.local_blocks = blocks
        changed = []
        for key_c in _COO_KEYS:
            self.arrays[f"{key_c}_vals"] = _pad_to(
                [getattr(b, key_c).to_coo()[2].astype(np.float32)
                 for b in blocks],
                self.pads[f"nnz_{key_c}"], fill=0.0)
            changed.append(f"{key_c}_vals")
        changed += _swap_refresh_lazy(self, [
            ("ell_cols", "ell_vals", self.ensure_ell),
            ("ell_t_cols", "ell_t_vals", self.ensure_ell_t),
            ("fused_cols", "fused_blocks", self.ensure_fused)])
        changed += _swap_refresh_abft(self)
        _swap_finish(self, a_new, changed)
        return changed


def check_same_structure(old: Optional[CSR], a_new: CSR) -> None:
    """Raise unless ``a_new`` has ``old``'s sparsity structure (the
    contract of every ``swap_values``)."""
    if old is None:
        raise ValueError("compiled plan lost its matrix reference; "
                         "recompile instead of swapping values")
    if (tuple(a_new.shape) != tuple(old.shape)
            or not np.array_equal(a_new.indptr, old.indptr)
            or not np.array_equal(a_new.indices, old.indices)):
        raise ValueError(
            "swap_values requires an identical sparsity structure (same "
            "shape, indptr, indices); a structural change needs a recompile")


def _swap_refresh_lazy(compiled, formats) -> List[str]:
    """Re-emit each MATERIALISED lazy format from the refreshed values.
    The structural companions (cols) regenerate equal, so their staged
    tensors stay; only the value names report changed."""
    changed = []
    for cols_name, vals_name, ensure in formats:
        if cols_name in compiled.arrays:
            del compiled.arrays[cols_name], compiled.arrays[vals_name]
            ensure()
            changed.append(vals_name)
    return changed


#: The ABFT vectors: value arrays, refreshed by a swap like the formats'.
_ABFT_NAMES = ("abft_col", "abft_col_abs", "abft_row", "abft_row_abs")


def _swap_refresh_abft(compiled) -> List[str]:
    """Re-emit the ABFT checksum vectors if they were materialised."""
    if "abft_col" not in compiled.arrays:
        return []
    for k in _ABFT_NAMES:
        del compiled.arrays[k]
    compiled.ensure_abft()
    return list(_ABFT_NAMES)


def _swap_finish(compiled, a_new: CSR, changed: List[str]) -> None:
    """Write the changed value arrays into their staged tensors in place
    (the torch form of the reference's zero-retrace swap: programs keep
    reading the same tensors) and retire the compile-cache entry."""
    for name in changed:
        if name not in compiled._tensors:
            continue                    # staged at its first use
        staged = compiled._tensors[name]
        new = torch.from_numpy(compiled.owned(name))
        if staged.shape != new.shape or staged.dtype != new.dtype:
            raise RuntimeError(f"swap_values: {name} changed from "
                               f"{tuple(staged.shape)} {staged.dtype} to "
                               f"{tuple(new.shape)} {new.dtype}")
        staged.copy_(new)
    compiled.a_ref = a_new
    if compiled._cache_token is not None:
        _COMPILE_CACHE.pop(compiled._cache_token, None)
        compiled._cache_token = None


# ---------------------------------------------------------------------------
# Format emission and the format autotuner
# ---------------------------------------------------------------------------

def _emit_abft(arrays: Dict[str, np.ndarray],
               per_rank_coo: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
               n_x: int, rows_pad: int) -> None:
    """The four ABFT vectors from each rank's COO over the packed domain:
    ``abft_col`` / ``abft_col_abs`` ``[P, n_x]``, ``abft_row`` /
    ``abft_row_abs`` ``[P, rows_pad]``, summed in float64 in COO order."""
    n = len(per_rank_coo)
    col = np.zeros((n, n_x), np.float64)
    cola = np.zeros((n, n_x), np.float64)
    row = np.zeros((n, rows_pad), np.float64)
    rowa = np.zeros((n, rows_pad), np.float64)
    for r, (rr, cc, vv) in enumerate(per_rank_coo):
        v32 = vv.astype(np.float32).astype(np.float64)
        col[r] = np.bincount(cc, weights=v32, minlength=n_x)
        cola[r] = np.bincount(cc, weights=np.abs(v32), minlength=n_x)
        row[r] = np.bincount(rr, weights=v32, minlength=rows_pad)
        rowa[r] = np.bincount(rr, weights=np.abs(v32), minlength=rows_pad)
    arrays["abft_col"] = col.astype(np.float32)
    arrays["abft_col_abs"] = cola.astype(np.float32)
    arrays["abft_row"] = row.astype(np.float32)
    arrays["abft_row_abs"] = rowa.astype(np.float32)


def _packed_coo(blk: LocalBlocks, offs: Tuple[int, int, int]):
    """A rank's three blocks as one COO over the packed column domain."""
    parts = [blk.on_proc.to_coo(), blk.on_node.to_coo(), blk.off_node.to_coo()]
    rows = np.concatenate([p[0] for p in parts])
    cols = np.concatenate([p[1] + o for p, o in zip(parts, offs)])
    vals = np.concatenate([p[2] for p in parts])
    return rows, cols, vals


def _fused_bsr_arrays(blocks: List[LocalBlocks], rows_pad: int, cols_pad: int,
                      bnode_pad: int, boff_pad: int,
                      bm: int, bn: int) -> Tuple[np.ndarray, np.ndarray, Dict[str, int]]:
    """Fuse each rank's three column blocks into one padded-uniform BSR over
    ``[v_loc | b_on_node | b_off_node]``, every segment a multiple of bn,
    so a block column never straddles two buffers.  Block columns sort
    ascending within a block row: on-process, then on-node, then off-node."""
    vblk = _ceil_to(max(cols_pad, 1), bn)
    nblk = _ceil_to(max(bnode_pad, 1), bn)
    oblk = _ceil_to(max(boff_pad, 1), bn)
    n_cols = vblk + nblk + oblk
    per_rank = [BSR.from_coo(*_packed_coo(blk, (0, vblk, vblk + nblk)),
                             (rows_pad, n_cols), bm=bm, bn=bn)
                for blk in blocks]
    cols, data, kmax = _stack_padded_bsr(per_rank)
    layout = dict(vblk=vblk, nblk=nblk, oblk=oblk,
                  n_brows=per_rank[0].n_brows, kmax=kmax)
    return cols, data, layout


def _fused_ell_arrays(blocks: List[LocalBlocks], rows_pad: int, cols_pad: int,
                      bnode_pad: int, boff_pad: int
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Each rank's three blocks as one ELL over the packed x domain
    (offsets cols_pad and cols_pad + bnode_pad), stacked to a shared kmax."""
    n_x = cols_pad + bnode_pad + boff_pad
    per_rank = [ELL.from_coo(*_packed_coo(blk, (0, cols_pad, cols_pad + bnode_pad)),
                             (rows_pad, n_x), n_rows_pad=rows_pad)
                for blk in blocks]
    return stack_ell(per_rank)


def _stack_padded_bsr(per_rank: List[BSR]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Align every rank's padded-uniform layout to one shared kmax and stack
    into ``[n_procs, n_brows, kmax(, bm, bn)]``."""
    kmax = max(1, max((int(np.diff(b.indptr).max(initial=0)) for b in per_rank),
                      default=1))
    cols_s, blocks_s = [], []
    for b in per_rank:
        c, d, _ = b.padded_uniform(kmax=kmax)
        cols_s.append(c)
        blocks_s.append(d)
    return np.stack(cols_s), np.stack(blocks_s), kmax


def _format_stats_from_coo(per_rank_rc: List[Tuple[np.ndarray, np.ndarray]],
                           rows_pad: int, n_x: int, nnz_pad_total: int,
                           block_shape: Tuple[int, int],
                           tuner: LocalComputeParams) -> Dict[str, object]:
    """Layout stats + format verdict from per-rank packed-domain COOs,
    without emitting any format: BSR tiles from unique (block row, block
    col) keys, ELL kmax from per-row counts, maxed over ranks."""
    bm, bn = block_shape
    nbc = n_x // bn
    n_brows = -(-rows_pad // bm)
    per_rank = []
    kb_global = 1
    ke_global = 1
    for rank, (rows, cols) in enumerate(per_rank_rc):
        keys = np.unique((rows // bm) * nbc + cols // bn)
        kb = int(np.bincount((keys // nbc).astype(np.int64),
                             minlength=n_brows).max(initial=0))
        ke = max(1, int(np.bincount(rows.astype(np.int64),
                                    minlength=rows_pad).max(initial=0)))
        nnz = int(rows.size)
        per_rank.append({
            "rank": rank, "nnz": nnz, "bsr_tiles": int(keys.size),
            "bsr_fill": nnz / max(int(keys.size) * bm * bn, 1),
            "ell_kmax": ke,
        })
        kb_global = max(kb_global, kb)
        ke_global = max(ke_global, ke)
    stats = {
        "rows_pad": rows_pad, "n_x": n_x, "nnz_pad": nnz_pad_total,
        "bsr_blocks": n_brows * kb_global, "bm": bm, "bn": bn,
        "ell_kmax": ke_global,
    }
    times = local_format_times(stats, tuner)
    for entry in per_rank:
        rank_stats = dict(stats, bsr_blocks=entry["bsr_tiles"],
                          ell_kmax=entry["ell_kmax"], nnz_pad=entry["nnz"])
        entry["choice"] = choose_local_format(rank_stats, tuner)
    return {
        "chosen": min(LOCAL_FORMATS, key=lambda f: times[f]),
        "times": times,
        "stats": stats,
        "per_rank": per_rank,
        "tuner": tuner.name,
    }


def _autotune_stats(blocks: List[LocalBlocks], rows_pad: int, cols_pad: int,
                    bnode_pad: int, boff_pad: int, nnz_pad_total: int,
                    block_shape: Tuple[int, int],
                    tuner: LocalComputeParams) -> Dict[str, object]:
    """Format stats + verdict for BOTH directions: forward at the top
    level, the transpose (over the reversed domain) under "transpose"."""
    offs = (0, cols_pad, cols_pad + bnode_pad)
    per_rank_rc = [_packed_coo(blk, offs)[:2] for blk in blocks]
    n_x = cols_pad + bnode_pad + boff_pad
    out = _format_stats_from_coo(per_rank_rc, rows_pad, n_x,
                                 nnz_pad_total, block_shape, tuner)
    out["transpose"] = _transpose_format_stats(
        [(c, r) for r, c in per_rank_rc], n_x, rows_pad, nnz_pad_total,
        block_shape, tuner)
    return out


def _transpose_format_stats(per_rank_rc_t: List[Tuple[np.ndarray, np.ndarray]],
                            out_len: int, n_x: int, nnz_pad_total: int,
                            block_shape: Tuple[int, int],
                            tuner: LocalComputeParams) -> Dict[str, object]:
    """Verdict for the TRANSPOSED local compute: output rows = the packed
    domain, x = the row-partition shard; only ``ell`` and ``coo``
    compete (there is no transposed BSR kernel)."""
    at = _format_stats_from_coo(per_rank_rc_t, out_len, n_x, nnz_pad_total,
                                block_shape, tuner)
    times = {f: at["times"][f] for f in ("ell", "coo")}
    return {"chosen": min(times, key=lambda f: times[f]), "times": times,
            "stats": at["stats"], "per_rank": at["per_rank"],
            "tuner": tuner.name}


# ---------------------------------------------------------------------------
# Plan compilation (cached)
# ---------------------------------------------------------------------------

_COMPILE_CACHE: Dict[tuple, _Staged] = {}
_COMPILE_CACHE_MAX = 16  # LRU bound: an entry holds its plan's staged tensors


def clear_compile_cache() -> None:
    _COMPILE_CACHE.clear()


def _cache_put(key: tuple, compiled: _Staged) -> None:
    """Insert, evicting the least recently used entries first; an evicted
    plan releases its staged tensors (a live operator that still holds it
    stages them again at its next apply)."""
    while len(_COMPILE_CACHE) >= _COMPILE_CACHE_MAX:
        _COMPILE_CACHE.pop(next(iter(_COMPILE_CACHE)))._tensors.release()
    _COMPILE_CACHE[key] = compiled
    compiled._cache_token = key


def _cache_get(key: tuple) -> Optional[_Staged]:
    hit = _COMPILE_CACHE.pop(key, None)
    if hit is not None:
        _COMPILE_CACHE[key] = hit  # re-insert: dict order is the LRU order
    return hit


def _cache_key(a: CSR, part: RowPartition, topo: Topology,
               block_shape: Tuple[int, int], local_compute: str,
               tuner: LocalComputeParams, tag: str,
               col_part: Optional[RowPartition],
               device: torch.device, mesh: Optional[ProcessMesh]) -> tuple:
    """The reference's key (structure, VALUES, partitions, topology,
    block shape, local compute, tuner, plan family) plus the device the
    plan stages on and, in a multi-process job, the owned block and the
    process group (a block plan is never a whole plan)."""
    h = hashlib.sha1()
    arrs = [a.indptr, a.indices, a.data, part.owner]
    if col_part is not None:
        arrs.append(col_part.owner)
    for arr in arrs:
        h.update(np.ascontiguousarray(arr).tobytes())
    return (tag, h.hexdigest(), a.shape, topo.n_nodes, topo.ppn,
            tuple(block_shape), str(local_compute), tuner.signature(),
            str(device), None if mesh is None else mesh.key)


def compile_nap(a: CSR, part: RowPartition, topo: Topology,
                plan: Optional[NAPPlan] = None,
                block_shape: Tuple[int, int] = (8, 128),
                cache: bool = True, local_compute: str = "auto",
                tuner: LocalComputeParams = H100_LOCAL,
                col_part: Optional[RowPartition] = None,
                device: DeviceLike = None) -> CompiledNAP:
    """Compile the node-aware plan to static rank-stacked arrays.

    ``part`` is the ROW partition, ``col_part`` the COLUMN/x partition
    (defaults to ``part``); ``plan`` a prebuilt :class:`NAPPlan` of the
    same layout.  ``device`` is where :meth:`CompiledNAP.tensors` stages
    the arrays: CUDA unless ``"cpu"`` is asked for.  With ``cache`` (and
    no ``plan``) an equal matrix, layout and configuration on the same
    device returns the cached plan (:func:`clear_compile_cache`).
    """
    device = resolve_device(device)
    _check_layout(a, part, col_part, local_compute)
    mesh = plan_mesh(topo)
    key = None
    if plan is None and cache:
        key = _cache_key(a, part, topo, block_shape, local_compute, tuner,
                         "nap", col_part, device, mesh)
        hit = _cache_get(key)
        if hit is not None:
            return hit
    if plan is None:
        plan = build_nap_plan(a.indptr, a.indices, part, topo, col_part=col_part)
    compiled = _compile_node_aware(a, part, topo, plan, None, block_shape,
                                   local_compute, tuner, col_part, device)
    compiled.mesh = mesh
    if key is not None:
        _cache_put(key, compiled)
    return compiled


def compile_multistep(a: CSR, part: RowPartition, topo: Topology,
                      plan=None, block_shape: Tuple[int, int] = (8, 128),
                      cache: bool = True, local_compute: str = "auto",
                      tuner: LocalComputeParams = H100_LOCAL,
                      col_part: Optional[RowPartition] = None,
                      threshold="auto", device: DeviceLike = None) -> CompiledNAP:
    """Compile the multi-step plan (:mod:`repro_torch.comm.multistep`).

    A :class:`CompiledNAP` with ``comm="multistep"``: the four NAP arrays
    built from the high-duplication sub-plan exactly as
    :func:`compile_nap` builds them, a ``direct_send [n_procs, n_procs,
    direct_pad]`` gather for the flat fifth exchange, and ``boff_gather``
    resolving off-node columns against ``[inter | final | direct]``.
    ``plan`` supplies a prebuilt :class:`MultistepPlan`; ``cache`` as in
    :func:`compile_nap`, the resolved threshold part of the key.
    """
    device = resolve_device(device)
    _check_layout(a, part, col_part, local_compute)
    thr = resolve_threshold(threshold, topo)
    mesh = plan_mesh(topo)
    key = None
    if plan is None and cache:
        key = _cache_key(a, part, topo, block_shape, local_compute, tuner,
                         f"multistep:{thr}", col_part, device, mesh)
        hit = _cache_get(key)
        if hit is not None:
            return hit
    if plan is None:
        plan = build_multistep_plan(a.indptr, a.indices, part, topo,
                                    col_part=col_part, threshold=thr)
    compiled = _compile_node_aware(a, part, topo, plan.nap, plan.direct,
                                   block_shape, local_compute, tuner, col_part,
                                   device, ms_plan=plan)
    compiled.mesh = mesh
    if key is not None:
        _cache_put(key, compiled)
    return compiled


def _check_layout(a: CSR, part: RowPartition, col_part: Optional[RowPartition],
                  local_compute: str) -> None:
    if local_compute not in ("auto",) + LOCAL_FORMATS:
        raise ValueError(local_compute)
    cpart = part if col_part is None else col_part
    if part.n_rows != a.shape[0] or cpart.n_rows != a.shape[1]:
        raise ValueError(
            f"partition/matrix mismatch: a is {a.shape}, row partition has "
            f"{part.n_rows} rows, column partition {cpart.n_rows}")


def _compile_node_aware(a: CSR, part: RowPartition, topo: Topology,
                        plan: NAPPlan, direct: Optional[StandardPlan],
                        block_shape: Tuple[int, int], local_compute: str,
                        tuner: LocalComputeParams,
                        col_part: Optional[RowPartition],
                        device: torch.device, ms_plan=None) -> CompiledNAP:
    """The arrays of :func:`compile_nap` from a NAP plan and, for the
    multi-step plan, its direct sub-plan."""
    cpart = part if col_part is None else col_part
    n_procs, ppn, n_nodes = topo.n_procs, topo.ppn, topo.n_nodes
    blocks = split_all_blocks(a, part, topo, col_part=cpart)
    local_index = cpart.local_index()
    bn = block_shape[1]
    if bn % 8 != 0:
        raise ValueError(f"bn must be a multiple of 8, got {bn}")
    # segment lengths of the packed x are rounded up to bn, so v_loc /
    # b_on_node / b_off_node are bn-aligned views of one packed domain;
    # the extra slots are never referenced by a nonzero.
    rows_pad = _ceil_to(max(1, int(part.counts().max())), bn)
    cols_pad = _ceil_to(max(1, int(cpart.counts().max())), bn)
    bnode_pad = _ceil_to(max(1, max(b.on_node_cols.size for b in blocks)), bn)
    boff_pad = _ceil_to(max(1, max(b.off_node_cols.size for b in blocks)), bn)

    def msg_pad(phase: List[List[Message]]) -> int:
        return max(1, max((m.size for msgs in phase for m in msgs), default=1))

    full_pad = msg_pad(plan.local_full_sends)
    init_pad = msg_pad(plan.local_init_sends)
    inter_pad = msg_pad(plan.inter_sends)
    final_pad = msg_pad(plan.local_final_sends)
    direct_pad = msg_pad(direct.sends) if direct is not None else 0
    nnz_pads = {
        "on_proc": max(1, max(b.on_proc.nnz for b in blocks)),
        "on_node": max(1, max(b.on_node.nnz for b in blocks)),
        "off_node": max(1, max(b.off_node.nnz for b in blocks)),
    }

    arrays: Dict[str, np.ndarray] = {
        "full_send": np.zeros((n_procs, ppn, full_pad), np.int32),
        "init_send": np.zeros((n_procs, ppn, init_pad), np.int32),
        "final_send": np.zeros((n_procs, ppn, final_pad), np.int32),
        "inter_gather": np.zeros((n_procs, n_nodes, inter_pad), np.int32),
        "bnode_gather": np.zeros((n_procs, bnode_pad), np.int32),
        "boff_gather": np.zeros((n_procs, boff_pad), np.int32),
    }
    if direct is not None:
        # source local-row positions, one slot per destination rank of
        # the flat direct exchange
        arrays["direct_send"] = np.zeros((n_procs, n_procs, direct_pad), np.int32)
    coo = {k: {"rows": [], "cols": [], "vals": []} for k in nnz_pads}

    for r in range(n_procs):
        blk = blocks[r]
        # full-local and init sends: [ppn, pad] source local-row positions
        for m in plan.local_full_sends[r]:
            arrays["full_send"][r, topo.local_of(m.dst), : m.size] = local_index[m.idx]
        for m in plan.local_init_sends[r]:
            arrays["init_send"][r, topo.local_of(m.dst), : m.size] = local_index[m.idx]

        # inter gather: positions into concat(v_loc, init_recv_flat)
        init_map = plan.recv_slot_map(r, "init", init_pad)
        for m in plan.inter_sends[r]:
            own = cpart.owner[m.idx] == r
            pos = np.empty(m.size, dtype=np.int64)
            pos[own] = local_index[m.idx[own]]
            if not own.all():
                pos[~own] = cols_pad + lookup_slots(init_map, m.idx[~own])
            arrays["inter_gather"][r, topo.node_of(m.dst), : m.size] = pos

        # final sends: positions into inter_recv_flat
        inter_map = plan.recv_slot_map(r, "inter", inter_pad)
        for m in plan.local_final_sends[r]:
            arrays["final_send"][r, topo.local_of(m.dst), : m.size] = \
                lookup_slots(inter_map, m.idx)

        # on-node buffer gather: positions into full_recv_flat
        full_map = plan.recv_slot_map(r, "full", full_pad)
        arrays["bnode_gather"][r, : blk.on_node_cols.size] = \
            lookup_slots(full_map, blk.on_node_cols)

        # off-node buffer gather: positions into
        # concat(inter_recv, final_recv[, direct_recv])
        final_map = plan.recv_slot_map(r, "final", final_pad)
        maps = [inter_map, final_map]
        offsets = [0, n_nodes * inter_pad]
        if direct is not None:
            for m in direct.sends[r]:
                arrays["direct_send"][r, m.dst, : m.size] = local_index[m.idx]
            maps.append(direct.recv_slot_map(r, direct_pad))
            offsets.append(n_nodes * inter_pad + ppn * final_pad)
        comb_idx = np.concatenate([m[0] for m in maps])
        comb_pos = np.concatenate([o + m[1] for o, m in zip(offsets, maps)])
        order = np.argsort(comb_idx, kind="stable")
        arrays["boff_gather"][r, : blk.off_node_cols.size] = lookup_slots(
            (comb_idx[order], comb_pos[order]), blk.off_node_cols)

        for key_c, block in (("on_proc", blk.on_proc), ("on_node", blk.on_node),
                             ("off_node", blk.off_node)):
            rows_i, cols_i, vals_i = block.to_coo()
            coo[key_c]["rows"].append(rows_i.astype(np.int32))
            coo[key_c]["cols"].append(cols_i.astype(np.int32))
            coo[key_c]["vals"].append(vals_i.astype(np.float32))

    for key_c, pad in nnz_pads.items():
        arrays[f"{key_c}_rows"] = _pad_to(coo[key_c]["rows"], pad)
        arrays[f"{key_c}_cols"] = _pad_to(coo[key_c]["cols"], pad)
        arrays[f"{key_c}_vals"] = _pad_to(coo[key_c]["vals"], pad, fill=0.0)

    pads = dict(full=full_pad, init=init_pad, inter=inter_pad, final=final_pad,
                bnode=bnode_pad, boff=boff_pad,
                **{f"nnz_{k}": v for k, v in nnz_pads.items()})
    if direct is not None:
        pads["direct"] = direct_pad
    autotune = _autotune_stats(blocks, rows_pad, cols_pad, bnode_pad, boff_pad,
                               sum(nnz_pads.values()), tuple(block_shape), tuner)
    return CompiledNAP(topo=topo, part=part, col_part=cpart, rows_pad=rows_pad,
                       cols_pad=cols_pad, pads=pads, arrays=arrays, device=device,
                       plan=plan, block_shape=tuple(block_shape),
                       local_blocks=blocks, autotune=autotune,
                       requested_local_compute=local_compute,
                       comm="nap" if direct is None else "multistep",
                       ms_plan=ms_plan, a_ref=a)


def compiled_from_reference(arrays: Dict[str, np.ndarray], pads: Dict[str, int],
                            rows_pad: int, cols_pad: int,
                            block_shape: Tuple[int, int],
                            autotune: Dict[str, object],
                            topo_shape: Tuple[int, int],
                            device: DeviceLike = None) -> CompiledNAP:
    """A compiled plan from host arrays made elsewhere (the JAX package's
    ``CompiledNAP.arrays`` and metadata, as numpy), staged as tensors on
    ``device``.  Only the formats present in ``arrays`` can run."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    compiled = CompiledNAP(
        topo=Topology(*topo_shape), part=None, rows_pad=rows_pad,
        pads=dict(pads), arrays=arrays, device=resolve_device(device),
        cols_pad=cols_pad, block_shape=tuple(block_shape),
        autotune=dict(autotune),
        ell_kmax=arrays["ell_cols"].shape[-1] if "ell_cols" in arrays else 0,
        ell_t_kmax=arrays["ell_t_cols"].shape[-1] if "ell_t_cols" in arrays else 0)
    compiled.tensors(list(arrays))
    return compiled


# ---------------------------------------------------------------------------
# Standard (Algorithm 1) plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledStandard(_Staged):
    """Static arrays of the standard SpMV (Algorithm 1), stacked over ranks.

    The packed x domain has two bn-aligned segments: ``[0, cols_pad)`` is
    v_loc (the COLUMN-partition shard), ``[cols_pad, cols_pad + buf_pad)``
    the one recv buffer of off-process values; the output is ``rows_pad``
    ROW-partition rows.  ``send_idx [P, P, pair_pad]`` holds the local x
    rows rank s sends to rank r, ``buf_gather [P, buf_pad]`` the recv
    slots the buffer reads; both pad with 0.  ``send_counts [P, P]`` are
    the true message sizes (the live prefix of each ``send_idx`` row).
    Formats (COO / ELL / transposed ELL / fused BSR over the packed
    domain) emit lazily from ``per_rank_coo``.
    """

    topo: Topology
    part: Optional[RowPartition]
    rows_pad: int
    buf_pad: int
    pair_pad: int
    nnz_pad: int
    block_shape: Tuple[int, int]
    arrays: Dict[str, np.ndarray]
    device: torch.device
    send_counts: np.ndarray
    per_rank_coo: Optional[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = None
    col_part: Optional[RowPartition] = None
    cols_pad: int = 0
    plan: Optional[StandardPlan] = None
    autotune: Dict[str, object] = dataclasses.field(default_factory=dict)
    requested_local_compute: str = "auto"
    ell_t_kmax: int = 0
    _tensors: Dict[object, torch.Tensor] = dataclasses.field(
        default_factory=_plan_namespace, repr=False, compare=False)
    a_ref: Optional[CSR] = dataclasses.field(default=None, repr=False,
                                             compare=False)
    _cache_token: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                      compare=False)
    mesh: Optional[ProcessMesh] = dataclasses.field(default=None, repr=False,
                                                    compare=False)

    def __post_init__(self) -> None:
        if self.col_part is None:
            self.col_part = self.part
        if not self.cols_pad:
            self.cols_pad = self.rows_pad

    @property
    def n_x(self) -> int:
        """Length of the packed x ``[v_loc | buf]``."""
        return self.cols_pad + self.buf_pad

    @property
    def packed_x_len(self) -> int:
        return self.n_x

    @property
    def chosen_local_compute(self) -> str:
        return str(self.autotune.get("chosen", "coo"))

    def resolve_local_compute(self, requested: str) -> str:
        return _resolve_local_compute(requested, self.requested_local_compute,
                                      self.chosen_local_compute)

    def resolve_transpose_local_compute(self, requested: str) -> str:
        return _resolve_transpose_local_compute(
            requested, self.requested_local_compute, self.autotune)

    def _coo(self) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        if self.per_rank_coo is None:
            raise ValueError("this plan holds no per-rank COO to emit a format "
                             "from; build it with the format arrays included")
        return self.per_rank_coo

    def ensure_coo(self) -> None:
        if "A_rows" in self.arrays:
            return
        coo = self._coo()
        self.arrays["A_rows"] = _pad_to([rr.astype(np.int32) for rr, _, _ in coo],
                                        self.nnz_pad)
        self.arrays["A_cols"] = _pad_to([cc.astype(np.int32) for _, cc, _ in coo],
                                        self.nnz_pad)
        self.arrays["A_vals"] = _pad_to([vv.astype(np.float32) for _, _, vv in coo],
                                        self.nnz_pad, fill=0.0)

    def ensure_ell(self) -> None:
        if "ell_cols" in self.arrays:
            return
        cols, vals, _ = stack_ell([
            ELL.from_coo(rr, cc, vv, (self.rows_pad, self.n_x),
                         n_rows_pad=self.rows_pad)
            for rr, cc, vv in self._coo()])
        self.arrays["ell_cols"] = cols
        self.arrays["ell_vals"] = vals

    def ensure_ell_t(self) -> None:
        """Transposed ELL over the packed contribution domain
        ``[z(cols_pad) | buf]`` with x = u_loc (rows_pad)."""
        if "ell_t_cols" in self.arrays:
            return
        cols, vals, kmax = stack_ell([
            ELL.from_coo(cc, rr, vv, (self.n_x, self.rows_pad), n_rows_pad=self.n_x)
            for rr, cc, vv in self._coo()])
        self.arrays["ell_t_cols"] = cols
        self.arrays["ell_t_vals"] = vals
        self.ell_t_kmax = kmax

    def ensure_abft(self) -> None:
        """The ABFT vectors over the two-segment packed domain, as
        :meth:`CompiledNAP.ensure_abft`."""
        if "abft_col" in self.arrays:
            return
        _emit_abft(self.arrays, self._coo(), self.n_x, self.rows_pad)

    def ensure_fused(self) -> None:
        if "fused_cols" in self.arrays:
            return
        bm, bn = self.block_shape
        cols, blocks, _ = _stack_padded_bsr([
            BSR.from_coo(rr, cc, vv, (self.rows_pad, self.n_x), bm=bm, bn=bn)
            for rr, cc, vv in self._coo()])
        self.arrays["fused_cols"] = cols
        self.arrays["fused_blocks"] = blocks

    def live_send_slots(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The live slots of the send table, built once from
        ``send_counts``: their flat positions in ``[P, P, pair_pad]`` and
        the flat ``[P * cols_pad]`` rows they carry (the owned block's
        senders only, both counted from the block's first rank)."""
        if "live_send" not in self._tensors:
            p, pad = self.topo.n_procs, self.pair_pad
            k = self.send_counts.reshape(-1).astype(np.int64)
            ends = np.cumsum(k)
            pos = (np.repeat(np.arange(p * p, dtype=np.int64) * pad, k)
                   + np.arange(ends[-1]) - np.repeat(ends - k, k))
            rows = (self.arrays["send_idx"].reshape(-1)[pos].astype(np.int64)
                    + pos // (p * pad) * self.cols_pad)
            if self.mesh is not None:
                # the live slots are sender-major: the block's are one run
                r0, r1 = self.mesh.ranks
                mine = (pos >= r0 * p * pad) & (pos < r1 * p * pad)
                pos = pos[mine] - r0 * p * pad
                rows = rows[mine] - r0 * self.cols_pad
            self._stage("live_send", (torch.from_numpy(pos).to(self.device),
                                      torch.from_numpy(rows).to(self.device)))
        return self._tensors["live_send"]

    def swap_values(self, a_new: CSR) -> List[str]:
        """Hot-swap the matrix VALUES in place; the sparsity must be
        identical.  As :meth:`CompiledNAP.swap_values`, over the
        two-segment domain: ``per_rank_coo`` refreshes and every
        materialised format re-emits against the same pads."""
        check_same_structure(self.a_ref, a_new)
        blocks = split_all_blocks(a_new, self.part, self.topo,
                                  col_part=self.col_part)
        self.per_rank_coo = [_standard_coo(blk, self.cols_pad) for blk in blocks]
        changed = _swap_refresh_lazy(self, [
            ("A_rows", "A_vals", self.ensure_coo),
            ("ell_cols", "ell_vals", self.ensure_ell),
            ("ell_t_cols", "ell_t_vals", self.ensure_ell_t),
            ("fused_cols", "fused_blocks", self.ensure_fused)])
        changed += _swap_refresh_abft(self)
        _swap_finish(self, a_new, changed)
        return changed


def _standard_coo(blk: LocalBlocks, cols_pad: int):
    """A rank's three blocks as one COO over ``[v_loc | buf]``."""
    rr0, cc0, vv0 = blk.on_proc.to_coo()
    rr1, cc1, vv1 = blk.on_node.to_coo()
    rr2, cc2, vv2 = blk.off_node.to_coo()
    return (np.concatenate([rr0, rr1, rr2]),
            np.concatenate([cc0, cols_pad + cc1,
                            cols_pad + blk.on_node_cols.size + cc2]),
            np.concatenate([vv0, vv1, vv2]))


def compile_standard(a: CSR, part: RowPartition, topo: Topology,
                     plan: Optional[StandardPlan] = None,
                     block_shape: Tuple[int, int] = (8, 128),
                     cache: bool = True, local_compute: str = "auto",
                     tuner: LocalComputeParams = H100_LOCAL,
                     col_part: Optional[RowPartition] = None,
                     device: DeviceLike = None) -> CompiledStandard:
    """Compile Algorithm 1's flat plan to static rank-stacked arrays.

    ``part`` is the ROW partition, ``col_part`` the COLUMN/x partition
    (defaults to ``part``); ``plan``, ``cache`` and ``device`` as in
    :func:`compile_nap`.
    """
    device = resolve_device(device)
    _check_layout(a, part, col_part, local_compute)
    mesh = plan_mesh(topo)
    key = None
    if plan is None and cache:
        key = _cache_key(a, part, topo, block_shape, local_compute, tuner,
                         "standard", col_part, device, mesh)
        hit = _cache_get(key)
        if hit is not None:
            return hit
    cpart = part if col_part is None else col_part
    if plan is None:
        plan = build_standard_plan(a.indptr, a.indices, part, topo,
                                   col_part=col_part)
    n_procs = topo.n_procs
    blocks = split_all_blocks(a, part, topo, col_part=cpart)
    local_index = cpart.local_index()
    bm, bn = block_shape
    if bn % 8 != 0:
        raise ValueError(f"bn must be a multiple of 8, got {bn}")
    rows_pad = _ceil_to(max(1, int(part.counts().max())), bn)
    cols_pad = _ceil_to(max(1, int(cpart.counts().max())), bn)
    buf_pad = _ceil_to(
        max(1, max(b.on_node_cols.size + b.off_node_cols.size for b in blocks)), bn)
    pair_pad = max(1, max((m.size for msgs in plan.sends for m in msgs), default=1))

    send_idx = np.zeros((n_procs, n_procs, pair_pad), dtype=np.int32)
    send_counts = np.zeros((n_procs, n_procs), dtype=np.int64)
    for r in range(n_procs):
        for m in plan.sends[r]:
            send_idx[r, m.dst, : m.size] = local_index[m.idx]
            send_counts[r, m.dst] = m.size
    nnz_pad = max(1, max(b.on_node.nnz + b.off_node.nnz + b.on_proc.nnz
                         for b in blocks))

    n_x = cols_pad + buf_pad
    per_rank_coo = []
    buf_gather = np.zeros((n_procs, buf_pad), dtype=np.int32)
    for r in range(n_procs):
        blk = blocks[r]
        cols_all = np.concatenate([blk.on_node_cols, blk.off_node_cols])
        buf_gather[r, : cols_all.size] = lookup_slots(
            plan.recv_slot_map(r, pair_pad), cols_all)
        per_rank_coo.append(_standard_coo(blk, cols_pad))
    autotune = _format_stats_from_coo(
        [(rr, cc) for rr, cc, _ in per_rank_coo], rows_pad, n_x,
        nnz_pad, (bm, bn), tuner)
    autotune["transpose"] = _transpose_format_stats(
        [(cc, rr) for rr, cc, _ in per_rank_coo], n_x, rows_pad,
        nnz_pad, (bm, bn), tuner)
    compiled = CompiledStandard(
        topo=topo, part=part, col_part=cpart, rows_pad=rows_pad,
        cols_pad=cols_pad, buf_pad=buf_pad, pair_pad=pair_pad, nnz_pad=nnz_pad,
        block_shape=tuple(block_shape),
        arrays=dict(send_idx=send_idx, buf_gather=buf_gather), device=device,
        send_counts=send_counts, per_rank_coo=per_rank_coo, plan=plan,
        autotune=autotune, requested_local_compute=local_compute, a_ref=a,
        mesh=mesh)
    if key is not None:
        _cache_put(key, compiled)
    return compiled


def compiled_standard_from_reference(
        arrays: Dict[str, np.ndarray], send_counts: np.ndarray, rows_pad: int,
        cols_pad: int, buf_pad: int, pair_pad: int, nnz_pad: int,
        block_shape: Tuple[int, int], autotune: Dict[str, object],
        topo_shape: Tuple[int, int], device: DeviceLike = None) -> CompiledStandard:
    """A compiled standard plan from host arrays made elsewhere (the JAX
    package's ``CompiledStandard.arrays`` and pads, as numpy, with the
    message sizes of its plan as ``send_counts [P, P]``), staged as
    tensors on ``device``.  Only the formats present in ``arrays`` run."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    compiled = CompiledStandard(
        topo=Topology(*topo_shape), part=None, rows_pad=rows_pad,
        buf_pad=buf_pad, pair_pad=pair_pad, nnz_pad=nnz_pad,
        block_shape=tuple(block_shape), arrays=arrays,
        device=resolve_device(device), send_counts=np.asarray(send_counts),
        cols_pad=cols_pad, autotune=dict(autotune),
        ell_t_kmax=arrays["ell_t_cols"].shape[-1] if "ell_t_cols" in arrays else 0)
    compiled.tensors(list(arrays))
    return compiled


# ---------------------------------------------------------------------------
# Vector packing (host)
# ---------------------------------------------------------------------------

def pack_vector(v: np.ndarray, part: RowPartition, topo: Topology, rows_pad: int) -> np.ndarray:
    """Global vector/multivector -> ``[n_nodes, ppn, rows_pad(, nv)]`` f32
    shards laid out by ``part`` (empty ranks give all-zero shards)."""
    v = np.asarray(v)
    out = np.zeros((topo.n_procs, rows_pad) + v.shape[1:], dtype=np.float32)
    for r in range(topo.n_procs):
        rows = part.rows_of(r)
        out[r, : rows.size] = v[rows]
    return out.reshape((topo.n_nodes, topo.ppn, rows_pad) + v.shape[1:])


def unpack_vector(w: np.ndarray, part: RowPartition, topo: Topology) -> np.ndarray:
    """``[n_nodes, ppn, pad(, nv)]`` -> global vector/multivector; exact
    inverse of :func:`pack_vector` under the same partition."""
    w = np.asarray(w)
    w = w.reshape((topo.n_procs, -1) + w.shape[3:] if w.ndim == 4
                  else (topo.n_procs, -1))
    out = np.zeros((part.n_rows,) + w.shape[2:], dtype=w.dtype)
    for r in range(topo.n_procs):
        rows = part.rows_of(r)
        out[rows] = w[r, : rows.size]
    return out


# ---------------------------------------------------------------------------
# Rank-batched device program
# ---------------------------------------------------------------------------

def _gather(c: CompiledNAP, x: torch.Tensor, name: str) -> torch.Tensor:
    """``x[r][arrays[name][r]]`` for every rank r (of the owned block):
    ``x`` is ``[P, L, nv]``, the result ``[P] + arrays[name].shape[1:] +
    (nv,)``.

    Gathers single elements of the flattened ``x``: a gather of whole
    rows of nv > 1 floats takes PyTorch's vectorized row-gather kernel,
    which ran the exchange ~10x slower on the H100 (PERF.md, PR 11).
    """
    nv = x.shape[-1]
    idx = c.flat_index(name, x.shape[1], nv)
    shape = (x.shape[0],) + tuple(c.arrays[name].shape[1:]) + (nv,)
    return x.reshape(-1).index_select(0, idx).reshape(shape)


def _gather_columns(c: CompiledNAP, x: torch.Tensor, name: str) -> torch.Tensor:
    """:func:`_gather`, one rhs column at a time through the nv = 1 row
    index: for the instrumented literal direct exchange, whose
    ``[P, P, direct_pad]`` slots at nv = 8 would need a 34 GB element
    index at the paper's size."""
    p, seg, nv = x.shape
    idx = c.flat_index(name, seg)
    out = torch.empty((p,) + tuple(c.arrays[name].shape[1:]) + (nv,),
                      dtype=x.dtype, device=x.device)
    flat_out, flat_x = out.view(-1, nv), x.reshape(-1, nv)
    for j in range(nv):
        flat_out[:, j] = flat_x[:, j].index_select(0, idx)
    return out


def _scatter(c: CompiledNAP, src: torch.Tensor, name: str,
             out_len: int) -> torch.Tensor:
    """Adjoint of :func:`_gather`: sum ``src`` (``arrays[name].shape +
    (nv,)``) into a zero ``[P, out_len, nv]`` at the named positions."""
    p, nv = src.shape[0], src.shape[-1]
    out = torch.zeros((p * out_len, nv), dtype=src.dtype, device=src.device)
    out.index_add_(0, c.flat_index(name, out_len), src.reshape(-1, nv))
    return out.reshape(p, out_len, nv)


def _rank_batch(c: CompiledNAP, shards, pad: int) -> Tuple[torch.Tensor, bool]:
    """``[nn, ppn, pad(, nv)]`` shards -> f32 ``[P, pad, nv]`` on the plan's
    device, and whether the caller passed a single vector.  A plan that
    owns a rank block takes the block's shards ``[n_local_nodes, ...]``."""
    t = torch.as_tensor(shards)
    single = t.dim() == 3
    t = t.to(device=c.device, dtype=torch.float32)
    return t.reshape(c.n_local_procs, pad, -1).contiguous(), single


def _unbatch(c: CompiledNAP, w: torch.Tensor, single: bool) -> torch.Tensor:
    out = w.reshape(-1, c.topo.ppn, w.shape[1], w.shape[2])
    return out[..., 0] if single else out


_COO_KEYS = ("on_proc", "on_node", "off_node")


def _elements(idx: torch.Tensor, nv: int) -> torch.Tensor:
    """Row indices into a flat ``[L, nv]`` tensor as element indices
    (``row * nv + column``) when nv > 1, the faster gather (:func:`_gather`)."""
    if nv == 1:
        return idx
    return (idx[:, None] * nv + torch.arange(nv, device=idx.device)).reshape(-1)


def _live_direct(c: CompiledNAP, nv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The live direct slots as (source, destination) element indices
    into the flattened v_loc and off-node buffer (see
    :meth:`CompiledNAP.ensure_live_direct`), staged once per nv."""
    key = ("live_direct", nv)
    if key not in c._tensors:
        t = c.tensors(["direct_live_src", "direct_live_dst"])
        c._stage(key, (_elements(t["direct_live_src"], nv),
                       _elements(t["direct_live_dst"], nv)))
    return c._tensors[key]


def _live_direct_block(c: CompiledNAP, nv: int):
    """The live direct slots of the owned rank block, for the exchange
    across processes: ``(src, dst, send_counts, recv_counts)``.

    ``src`` holds, grouped by destination process, the block's v_loc
    element indices of the values it sends (``send_counts`` per
    process), ``dst`` the block's off-node buffer element indices of the
    values it receives, grouped by source process (``recv_counts``).
    Both keep the literal exchange's slot order within each group, so the
    transpose's sums run in the one-process order.  Staged once per nv."""
    key = ("live_direct_block", nv)
    if key not in c._tensors:
        c.ensure_live_direct()
        mesh, boff_pad = c.mesh, c.arrays["boff_gather"].shape[1]
        src, dst = c.arrays["direct_live_src"], c.arrays["direct_live_dst"]
        s, r = src // c.cols_pad, dst // boff_pad
        r0, r1 = mesh.ranks
        per = mesh.n_local_procs
        send = (s >= r0) & (s < r1)
        order = np.argsort(r[send] // per, kind="stable")
        recv = (r >= r0) & (r < r1)
        src_b = (src[send] - r0 * c.cols_pad)[order]
        dst_b = dst[recv] - r0 * boff_pad
        counts = (np.bincount(r[send] // per, minlength=mesh.world) * nv,
                  np.bincount(s[recv] // per, minlength=mesh.world) * nv)
        c._stage(key, (_elements(torch.from_numpy(src_b).to(c.device), nv),
                       _elements(torch.from_numpy(dst_b).to(c.device), nv),
                       [int(k) for k in counts[0]], [int(k) for k in counts[1]]))
    return c._tensors[key]


def _live_direct_messages(c: CompiledNAP):
    """The instrumented multi-step transpose's live direct slots, row
    indices ``(src, dst, slot, msg)``: ``msg`` places each live value of
    the off-node contributions (``dst``) in the padded message table
    ``[P_loc, P, direct_pad]`` its receiver sends back, ``slot`` reads it
    from the exchanged table ``[P_loc, P, direct_pad]`` of its owner, and
    ``src`` is the owner's v_loc row it sums into.  One process: the flat
    ``direct_live_*`` arrays.  A rank block: the entries whose receiver
    (``msg``, ``dst``) or owner (``slot``, ``src``) the block holds,
    counted from the block's first rank, in the same order, so every row
    sums in the one-process order.  Staged once."""
    names = ["direct_live_src", "direct_live_dst", "direct_live_slot",
             "direct_live_msg"]
    c.ensure_live_direct()
    if c.mesh is None:
        return tuple(c.tensors(names).values())
    key = "live_direct_messages"
    if key not in c._tensors:
        src, dst, slot, msg = (c.arrays[k] for k in names)
        boff_pad = c.arrays["boff_gather"].shape[1]
        (r0, r1), table = c.mesh.ranks, c.topo.n_procs * c.pads["direct"]
        own = (src // c.cols_pad >= r0) & (src // c.cols_pad < r1)
        recv = (dst // boff_pad >= r0) & (dst // boff_pad < r1)
        block = (src[own] - r0 * c.cols_pad, dst[recv] - r0 * boff_pad,
                 slot[own] - r0 * table, msg[recv] - r0 * table)
        c._stage(key, tuple(torch.from_numpy(x).to(c.device) for x in block))
    return c._tensors[key]


# ---------------------------------------------------------------------------
# Integrity: device twins of repro_torch.core.integrity
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
#: words per chunk of the checksum fold: its int64 temporaries stay at
#: 1 GiB each on the largest buffers (the standard pair exchange)
_FOLD_CHUNK_WORDS = 1 << 27


def _fold(words: torch.Tensor, pos: torch.Tensor, dims) -> torch.Tensor:
    """``s1 ^ rotl32(s2, 7)`` over ``dims`` of int32 ``words`` at 1-based
    word positions ``pos`` (broadcast against ``words``).

    PyTorch has no wrapping uint32 reduction, so the words stay signed:
    a signed word is its unsigned value minus a multiple of 2^32, which
    leaves both sums unchanged mod 2^32.  ``s1`` sums the words in int64;
    each product ``word * pos`` (|.| < 2^62) is reduced mod 2^32 before
    ``s2`` sums it, so no int64 sum can overflow."""
    s1 = words.sum(dims, dtype=torch.int64) & _MASK32
    s2 = ((words.long() * pos) & _MASK32).sum(dims) & _MASK32
    return s1 ^ (((s2 << 7) & _MASK32) | (s2 >> 25))


def _msg_checksums(buf: torch.Tensor, lead: int = 1) -> torch.Tensor:
    """The position-weighted Fletcher fold of
    :func:`repro_torch.core.integrity.checksum_np`, bit for bit, for every
    message of ``buf``: its first ``lead`` dims index the messages, the
    rest is each message's payload in row-major order (``[pad, nv]``),
    read as 32-bit words (a float64 element is two, low word first).
    Returns int64 ``buf.shape[:lead]`` holding uint32 values."""
    shape = tuple(buf.shape[:lead])
    n = int(np.prod(shape, dtype=np.int64))
    words = buf.reshape(n, -1).view(torch.int32)
    pos = torch.arange(1, words.shape[1] + 1, dtype=torch.int64,
                       device=buf.device)
    step = max(1, _FOLD_CHUNK_WORDS // max(words.shape[1], 1))
    out = [_fold(words[i: i + step], pos, 1) for i in range(0, n, step)]
    return torch.cat(out).reshape(shape)


def _pair_checksums(x: torch.Tensor) -> torch.Tensor:
    """:func:`_msg_checksums` of the standard exchange's column-major
    buffer ``x [nv, S, R, pad]``: message ``(s, r)``'s element ``(k, c)``
    is word ``k * nv + c`` of its row-major ``[pad, nv]`` payload.
    Returns int64 ``[S, R]``."""
    words = x.view(torch.int32)
    nv, n_s, n_r, pad = words.shape
    dev = x.device
    pos = (torch.arange(pad, dtype=torch.int64, device=dev) * nv)[None, None, None, :] \
        + torch.arange(1, nv + 1, dtype=torch.int64, device=dev)[:, None, None, None]
    step = max(1, _FOLD_CHUNK_WORDS // max(nv * n_r * pad, 1))
    return torch.cat([_fold(words[:, i: i + step], pos, (0, 3))
                      for i in range(0, n_s, step)])


def _fault_rows(row: torch.Tensor, nxt: torch.Tensor,
                spec: torch.Tensor) -> torch.Tensor:
    """The scripted fault on one message per rank: ``row`` is the
    targeted message's payload ``[P, L]`` (row-major), ``nxt`` the next
    slot's, ``spec`` the ranks' ``(kind, slot, element, bit)`` rows
    ``[P, 4]``.  Every variant is computed and ``kind`` selects one, so a
    fault is data and kind 0 returns ``row`` unchanged: bitflip XORs bit
    ``bit`` of 32-bit word ``element``; zero and drop blank the payload;
    stale shifts it by one element; duplicate delivers the next slot's."""
    kind, elem, bit = spec[:, 0:1], spec[:, 2:3], spec[:, 3:4]
    words = row.view(torch.int32)
    width = words.shape[1]
    hit = torch.arange(width, device=row.device)[None, :] == torch.remainder(elem, width)
    mask = torch.where(hit, torch.bitwise_left_shift(torch.ones_like(bit),
                                                     bit.clamp(0, 31)), 0)
    mask = (mask - ((mask >> 31) << 32)).to(torch.int32)   # 2^31 -> -2^31
    flipped = (words ^ mask).view(row.dtype)
    zeroed = torch.zeros_like(row)
    out = row
    for code, variant in ((1, flipped), (2, zeroed), (3, torch.roll(row, 1, 1)),
                          (4, zeroed), (5, nxt)):
        out = torch.where(kind == code, variant, out)
    return out


def _apply_fault(buf: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """The fault transform at the pack boundary of one exchange:
    ``buf [P, n_slots, *payload]`` holds every rank's outgoing messages,
    ``spec [P, 4]`` one fault row per rank.  Only the targeted slot of
    each rank is read and rewritten (kind 0 rewrites it unchanged), the
    reference's ``_apply_fault`` applied to every rank; returns ``buf``,
    made contiguous."""
    buf = buf.contiguous()
    p, n = buf.shape[:2]
    flat = buf.view(p, n, -1)
    ranks = torch.arange(p, device=buf.device)
    slot = torch.remainder(spec[:, 1], n)
    row, nxt = flat[ranks, slot], flat[ranks, torch.remainder(slot + 1, n)]
    flat[ranks, slot] = _fault_rows(row, nxt, spec)
    return buf


def _stack_chk(pairs: List[Tuple[torch.Tensor, torch.Tensor]],
               max_slots: int) -> torch.Tensor:
    """Per-phase (expected, actual) checksums ``[P, n_slots]`` stacked
    into ``[P, n_phases, 2, max_slots]``, padded slots zero on both rows
    (padding never reads as a mismatch)."""
    rows = [torch.stack([torch.nn.functional.pad(t, (0, max_slots - t.shape[1]))
                         for t in pair], dim=1) for pair in pairs]
    return torch.stack(rows, dim=1)


class _Wire:
    """The instrumented exchanges of one program run: each message buffer
    is checksummed by its sender, the armed fault applied, the buffer and
    its checksum words exchanged, and the checksums recomputed by the
    receiver.  ``spec`` is the ``[P, n_phases, 4]`` fault spec."""

    def __init__(self, spec: torch.Tensor, method: str):
        self.spec = spec.reshape(-1, spec.shape[-2], 4).long()
        self.ph = phase_index(method)
        self.chks: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def fault(self, phase: str, buf: torch.Tensor) -> torch.Tensor:
        return _apply_fault(buf, self.spec[:, self.ph[phase]])

    def exchange(self, phase: str, buf: torch.Tensor, fn) -> torch.Tensor:
        sent = _msg_checksums(buf, 2)
        recv = fn(self.fault(phase, buf))
        expect = fn(sent[:, :, None, None])[:, :, 0, 0]
        self.chks[phase] = (expect, _msg_checksums(recv, 2))
        return recv

    def chk(self, c, phases: Sequence[str], max_slots: int) -> torch.Tensor:
        """``[n_local_nodes, ppn, n_phases, 2, max_slots]``: the owned
        ranks' rows (a rank block's under a mesh)."""
        out = _stack_chk([self.chks[p] for p in phases], max_slots)
        return out.reshape((-1, c.topo.ppn) + out.shape[1:])


def _exchanged(wire: Optional[_Wire], phase: str, buf: torch.Tensor, fn):
    """``fn(buf)``, instrumented through ``wire`` when there is one."""
    return fn(buf) if wire is None else wire.exchange(phase, buf, fn)


def _abft(c, y: torch.Tensor, vecs: Tuple[torch.Tensor, torch.Tensor],
          segs: Sequence[torch.Tensor]) -> torch.Tensor:
    """ABFT triple ``(sum(y_p), c_p . x, |c_p| . |x|)`` per owned rank and
    rhs, ``[n_local_nodes, ppn, 3, nv]``: ``vecs`` are the checksum vector
    and its absolute twin over the concatenated ``segs`` (the buffers the
    local compute read)."""
    vec, vec_abs = vecs
    d = s = 0
    off = 0
    for x in segs:
        n = x.shape[1]
        d = d + torch.bmm(vec[:, None, off: off + n], x)[:, 0]
        s = s + torch.bmm(vec_abs[:, None, off: off + n], x.abs())[:, 0]
        off += n
    out = torch.stack([y.sum(1), d, s], dim=1)
    return out.reshape((-1, c.topo.ppn) + out.shape[1:])


def nap_forward(c: CompiledNAP, v_shards, local_compute: str = "auto",
                materialize_x: bool = False, live_direct: bool = True,
                fault_spec: Optional[torch.Tensor] = None):
    """w = A @ v on packed shards: ``v_shards`` is COLUMN-partition packed
    ``[n_nodes, ppn, cols_pad(, nv)]``, the result ROW-partition packed
    ``[n_nodes, ppn, rows_pad(, nv)]`` on the plan's device.

    ``materialize_x=True`` concatenates the packed x before the local
    compute (the one-segment kernels) instead of passing the three
    segments; the two are bit-equal on the BSR path (an A/B switch).

    A multi-step plan (``c.comm == "multistep"``) adds phase E, the
    direct exchange of its low-duplication columns.  By default only its
    live slots move: each value is gathered from v_loc straight into its
    place in the off-node buffer (across processes, through one
    all-to-all of the live values).  ``live_direct=False`` runs the
    literal padded exchange (``[P, P, direct_pad]`` slots); the two are
    bit-equal.

    A plan that owns a rank block of a multi-process job (``c.mesh``)
    takes and returns the block's shards; the ``node`` exchange and the
    direct phase cross processes through :mod:`repro_torch.mesh.comm`.

    ``fault_spec`` (int32 ``[n_nodes, ppn, n_phases, 4]``, see
    :func:`repro_torch.core.integrity.build_fault_spec`; a rank-block plan
    takes the block's rows) runs the INSTRUMENTED program: every message
    is checksummed by its sender, the armed fault applied at the pack
    boundary, the checksum words (int64) exchanged with the payload
    through the same exchange, across processes too, and recomputed by
    the receiver; the compute fault hits the local result, and the ABFT
    triple is taken over the buffers the local compute read.  It returns
    ``(w, chk, abft)``: ``chk`` int64 ``[n_nodes, ppn, n_msg_phases, 2,
    max_slots]`` of uint32 values (sender row 0, receiver row 1), ``abft``
    f32 ``[n_nodes, ppn, 3, nv]``, both the block's rows for a rank-block
    plan (the receivers' rows: every fault is seen by the process that
    owns its receiver).  The direct phase then runs its literal padded
    exchange, whose messages are the reference's.  Without a spec the
    program is the bare one, launch for launch.
    """
    fmt = c.resolve_local_compute(local_compute)
    if fmt == "bsr":
        c.ensure_fused()
    elif fmt == "ell":
        c.ensure_ell()
    topo, rows_pad = c.topo, c.rows_pad
    v, single = _rank_batch(c, v_shards, c.cols_pad)
    p, _, nv = v.shape
    ms = c.comm == "multistep"
    wire = None
    if fault_spec is not None:
        c.ensure_abft()
        wire = _Wire(fault_spec, c.comm)
        live_direct = False
    proc = functools.partial(proc_all_to_all, ppn=topo.ppn)
    node = functools.partial(node_all_to_all, topo=topo, mesh=c.mesh)

    # Phase A+B: intra-node exchanges over "proc".
    full_recv = _exchanged(wire, "full", _gather(c, v, "full_send"), proc)
    init_recv = _exchanged(wire, "init", _gather(c, v, "init_send"), proc)
    # Phase C: ONE aggregated inter-node exchange over "node".
    staged = torch.cat([v, init_recv.reshape(p, -1, nv)], dim=1)
    inter_recv = _exchanged(wire, "inter", _gather(c, staged, "inter_gather"), node)
    # Phase D: intra-node scatter of the received off-node data.
    inter_flat = inter_recv.reshape(p, -1, nv)
    final_recv = _exchanged(wire, "final", _gather(c, inter_flat, "final_send"), proc)
    # Buffers of Algorithm 3's three local_spmv calls.
    bnode = _gather(c, full_recv.reshape(p, -1, nv), "bnode_gather")
    comb = [inter_flat, final_recv.reshape(p, -1, nv)]
    if not ms:
        boff = _gather(c, torch.cat(comb, dim=1), "boff_gather")
    elif live_direct:
        # Phase E, live slots: [inter | final | dump] first, then every
        # direct value from v_loc into its place in the buffer.
        c.ensure_live_direct()
        comb.append(torch.zeros((p, 1, nv), dtype=v.dtype, device=v.device))
        boff = _gather(c, torch.cat(comb, dim=1), "boff_live_gather")
        if c.mesh is None:
            src, dst = _live_direct(c, nv)
            vals = v.reshape(-1).index_select(0, src)
        else:
            src, dst, n_send, n_recv = _live_direct_block(c, nv)
            vals = live_all_to_all(v.reshape(-1).index_select(0, src),
                                   n_send, n_recv, c.mesh)
        boff.view(-1).index_copy_(0, dst, vals)
    else:
        # Phase E, literal: the flat exchange of the padded direct slots.
        send = _gather(c, v, "direct_send") if wire is None or nv == 1 \
            else _gather_columns(c, v, "direct_send")
        direct_recv = _exchanged(wire, "direct", send,
                                 functools.partial(rank_all_to_all, mesh=c.mesh))
        del send
        comb.append(direct_recv.reshape(p, -1, nv))
        boff = _gather(c, torch.cat(comb, dim=1), "boff_gather")
    segs = (v, bnode, boff)

    if fmt == "bsr":
        t = c.tensors(["fused_cols", "fused_blocks"])
        bn = c.block_shape[1]
        if materialize_x:
            x = torch.cat(segs, dim=1)
            w = fused_bsr_spmm(t["fused_cols"], t["fused_blocks"],
                               x.reshape(p, -1, bn, nv))
        else:
            w = fused_bsr_spmm_packed(t["fused_cols"], t["fused_blocks"],
                                      tuple(s.reshape(p, -1, bn, nv) for s in segs))
        w = w.reshape(p, -1, nv)[:, :rows_pad]
    elif fmt == "ell":
        t = c.tensors(["ell_cols", "ell_vals"])
        xs = (torch.cat(segs, dim=1),) if materialize_x else segs
        w = ell_spmm_packed(t["ell_cols"], t["ell_vals"], xs)
    else:
        w = torch.zeros((p, rows_pad, nv), dtype=torch.float32, device=v.device)
        for key, x in zip(_COO_KEYS, segs):
            vals = c.tensors([f"{key}_vals"])[f"{key}_vals"]
            contrib = vals[..., None] * _gather(c, x, f"{key}_cols")
            w += _scatter(c, contrib, f"{key}_rows", rows_pad)
    if wire is None:
        return _unbatch(c, w.contiguous(), single)
    # the compute fault hits the local result, after the wire and before
    # the check, which runs over the buffers the local compute read
    w = wire.fault("compute", w[:, None])[:, 0]
    abft = _abft(c, w, tuple(c.tensors(["abft_col", "abft_col_abs"]).values()), segs)
    phases = MULTISTEP_MESSAGE_PHASES if ms else NAP_MESSAGE_PHASES
    max_slots = topo.n_procs if ms else max(topo.ppn, topo.n_nodes)
    return _unbatch(c, w, single), wire.chk(c, phases, max_slots), abft


def nap_transpose(c: CompiledNAP, u_shards, local_compute: str = "auto",
                  live_direct: bool = True,
                  fault_spec: Optional[torch.Tensor] = None):
    """z = A.T @ u, the exact adjoint of :func:`nap_forward`: ``u_shards``
    is ROW-partition packed ``[.., rows_pad(, nv)]``, the result
    COLUMN-partition packed ``[.., cols_pad(, nv)]``.

    The transposed local compute runs first (one ELL SpMM over the packed
    contribution domain ``[z | c_on_node | c_off_node]``, or COO
    scatters), then every phase backwards: each forward gather becomes an
    ``index_add_`` scatter and each exchange is re-applied.  A multi-step
    plan's direct contributions go straight back to their owners' rows:
    by default from the live slots only, ``live_direct=False`` through
    the literal padded exchange (the same sums in the same order).

    ``fault_spec`` runs the instrumented program as in
    :func:`nap_forward`, phases in reverse order (direct, final, inter,
    init, full), each reversed message checksummed before the exchange
    and after it (the direct messages padded, as the literal exchange
    moves them); the compute fault and the transpose ABFT (``sum`` of
    the packed contributions against ``(A_p 1) . u_loc``) come before
    any exchange.  Returns ``(z, chk, abft)``.

    A rank-block plan (``c.mesh``) runs as :func:`nap_forward` does.
    """
    fmt = c.resolve_transpose_local_compute(local_compute)
    if fmt == "ell":
        c.ensure_ell_t()
    topo, pads = c.topo, c.pads
    nn, ppn, n_procs = topo.n_nodes, topo.ppn, topo.n_procs
    cols_pad, rows_pad, bnode_pad = c.cols_pad, c.rows_pad, pads["bnode"]
    inter_len = nn * pads["inter"]
    u, single = _rank_batch(c, u_shards, rows_pad)
    p, _, nv = u.shape
    ms = c.comm == "multistep"
    wire = None
    if fault_spec is not None:
        c.ensure_abft()
        wire = _Wire(fault_spec, c.comm)
    proc = functools.partial(proc_all_to_all, ppn=ppn)
    node = functools.partial(node_all_to_all, topo=topo, mesh=c.mesh)

    if fmt == "ell":
        t = c.tensors(["ell_t_cols", "ell_t_vals"])
        contrib = ell_spmm_packed(t["ell_t_cols"], t["ell_t_vals"], (u,))
        z = contrib[:, :cols_pad]
        c_node = contrib[:, cols_pad: cols_pad + bnode_pad]
        c_off = contrib[:, cols_pad + bnode_pad:]
    else:
        outs = []
        for key, out_len in zip(_COO_KEYS, (cols_pad, bnode_pad, pads["boff"])):
            vals = c.tensors([f"{key}_vals"])[f"{key}_vals"]
            prod = vals[..., None] * _gather(c, u, f"{key}_rows")
            outs.append(_scatter(c, prod, f"{key}_cols", out_len))
        z, c_node, c_off = outs

    abft = None
    if wire is not None:
        # compute fault and transpose ABFT over the packed contributions,
        # before any exchange
        packed_c = torch.cat([z, c_node, c_off], dim=1) if fmt != "ell" else contrib
        packed_c = wire.fault("compute", packed_c[:, None])[:, 0]
        abft = _abft(c, packed_c, tuple(c.tensors(["abft_row", "abft_row_abs"]).values()),
                     (u,))
        z = packed_c[:, :cols_pad]
        c_node = packed_c[:, cols_pad: cols_pad + bnode_pad]
        c_off = packed_c[:, cols_pad + bnode_pad:]

    # reverse of boff = concat(inter | final [| direct])[boff_gather]
    comb_len = inter_len + ppn * pads["final"]
    z_direct = None
    if not ms:
        comb = _scatter(c, c_off, "boff_gather", comb_len)
    elif wire is not None:
        # instrumented: the padded direct messages are exchanged and
        # checksummed whole, but built from and read back at their live
        # slots, so the sums are the live form's (the literal adjoint's
        # padding adds zeros to row 0, and its 530M-entry scatter is more
        # than PyTorch's deterministic index_add_ holds at the paper's size)
        src, dst, slot, msg_idx = _live_direct_messages(c)
        dpad = pads["direct"]
        comb = _scatter(c, c_off, "boff_live_gather", comb_len + 1)
        msg = torch.zeros((p * n_procs * dpad, nv), dtype=u.dtype, device=u.device)
        msg.index_add_(0, msg_idx, c_off.reshape(-1, nv).index_select(0, dst))
        direct_out_c = wire.exchange("direct", msg.view(p, n_procs, dpad, nv),
                                     functools.partial(rank_all_to_all, mesh=c.mesh))
        del msg
        z_direct = torch.zeros((p * cols_pad, nv), dtype=u.dtype, device=u.device)
        z_direct.index_add_(0, src, direct_out_c.reshape(-1, nv).index_select(0, slot))
        z_direct = z_direct.reshape(p, cols_pad, nv)
    elif live_direct:
        c.ensure_live_direct()
        comb = _scatter(c, c_off, "boff_live_gather", comb_len + 1)
        z_direct = torch.zeros((p * cols_pad, nv), dtype=u.dtype, device=u.device)
        if c.mesh is None:
            src, dst = _live_direct(c, 1)
            vals = c_off.reshape(-1, nv).index_select(0, dst)
        else:
            # back along the forward's live slots: receivers send, owners sum
            src, dst, n_send, n_recv = _live_direct_block(c, 1)
            vals = live_all_to_all(c_off.reshape(-1, nv).index_select(0, dst),
                                   n_recv, n_send, c.mesh)
        z_direct.index_add_(0, src, vals)
        z_direct = z_direct.reshape(p, cols_pad, nv)
    else:
        dpad = pads["direct"]
        comb = _scatter(c, c_off, "boff_gather", comb_len + n_procs * dpad)
        # reverse phase E: the flat exchange is its own adjoint
        direct_out_c = rank_all_to_all(
            comb[:, comb_len:].reshape(p, n_procs, dpad, nv), c.mesh)
        z_direct = _scatter(c, direct_out_c, "direct_send", cols_pad)
    inter_c = comb[:, :inter_len]
    final_recv_c = comb[:, inter_len:comb_len].reshape(p, ppn, pads["final"], nv)
    # reverse phase D
    final_out_c = _exchanged(wire, "final", final_recv_c, proc)
    inter_c = inter_c + _scatter(c, final_out_c, "final_send", inter_len)
    # reverse phase C: into the staged domain concat(v_loc, init_recv)
    inter_out_c = _exchanged(wire, "inter", inter_c.reshape(p, nn, pads["inter"], nv),
                             node)
    staged_c = _scatter(c, inter_out_c, "inter_gather",
                        cols_pad + ppn * pads["init"])
    z = z + staged_c[:, :cols_pad]
    # reverse phase B: init redistribution back to the owners
    init_out_c = _exchanged(
        wire, "init", staged_c[:, cols_pad:].reshape(p, ppn, pads["init"], nv), proc)
    z = z + _scatter(c, init_out_c, "init_send", cols_pad)
    # reverse phase A: on-node buffer contributions back to the owners
    full_recv_c = _scatter(c, c_node, "bnode_gather", ppn * pads["full"])
    full_out_c = _exchanged(wire, "full",
                            full_recv_c.reshape(p, ppn, pads["full"], nv), proc)
    z = z + _scatter(c, full_out_c, "full_send", cols_pad)
    if z_direct is not None:
        z = z + z_direct
    if wire is None:
        return _unbatch(c, z.contiguous(), single)
    phases = MULTISTEP_MESSAGE_PHASES if ms else NAP_MESSAGE_PHASES
    max_slots = topo.n_procs if ms else max(nn, ppn)
    return _unbatch(c, z.contiguous(), single), wire.chk(c, phases, max_slots), abft


def _exchange_pair(c: CompiledStandard, v: torch.Tensor,
                   wire: Optional["_Wire"] = None) -> torch.Tensor:
    """Algorithm 1's exchange on ``v [P, cols_pad, nv]``: every rank s
    gathers its padded message to each rank r (``send_idx``), the tiled
    all-to-all over ``("node", "proc")`` swaps the two rank axes
    (``recv[r, s] = send[s, r]``), and each rank gathers its buffer from
    the received slots (``buf_gather``); returns ``buf [P, buf_pad, nv]``.

    The send and recv tables hold ``P * P * pair_pad`` slots per rhs
    column (~5e8 at the paper's size), so they are laid out column-major
    (``[nv, ...]``) and gathered with one index entry per slot: neither
    an nv-expanded element index nor PyTorch's whole-row gather kernel,
    which ran the nv = 8 forward ~10x slower on the H100 (PERF.md).

    With a ``wire`` the exchange is instrumented: the sender's checksums
    of its messages (in each message's row-major ``[pad, nv]`` word
    order), the fault on the send table, the checksums exchanged with it
    and recomputed from the received table.
    """
    p, _, nv = v.shape
    pad, n_procs = c.pair_pad, c.topo.n_procs

    def take(x: torch.Tensor, name: str, seg_len: int) -> torch.Tensor:
        idx = c.flat_index(name, seg_len)
        if nv == 1:
            return x.reshape(-1).index_select(0, idx).reshape(1, -1)
        return x.index_select(1, idx)

    send = take(v.permute(2, 0, 1).reshape(nv, -1), "send_idx", c.cols_pad)
    if wire is not None:
        sent = _pair_checksums(send.reshape(nv, p, n_procs, pad))
        send = _fault_pair(send.reshape(nv, p, n_procs, pad),
                           wire.spec[:, wire.ph["pair"]])
    recv = rank_all_to_all(send.reshape(nv, p, n_procs, pad), c.mesh, lead=1)
    del send
    if wire is not None:
        # the senders' words travel to their receivers as the payload does
        expect = rank_all_to_all(sent[:, :, None], c.mesh)[:, :, 0]
        wire.chks["pair"] = (expect, _pair_checksums(recv))
    buf = take(recv.reshape(nv, -1), "buf_gather", n_procs * pad)
    return buf.reshape(nv, p, c.buf_pad).permute(1, 2, 0).contiguous()


def _fault_pair(send: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """:func:`_apply_fault` on the column-major send table ``[nv, S, R,
    pad]`` (S the owned senders, R every receiver): each sender's targeted
    message is taken out in its row-major ``[pad, nv]`` order,
    transformed and written back."""
    nv, p, n_r, pad = send.shape
    ranks = torch.arange(p, device=send.device)
    slot = torch.remainder(spec[:, 1], n_r)

    def message(dst):
        return send[:, ranks, dst].permute(1, 2, 0).reshape(p, pad * nv)

    new = _fault_rows(message(slot), message(torch.remainder(slot + 1, n_r)), spec)
    send[:, ranks, slot] = new.reshape(p, pad, nv).permute(2, 0, 1)
    return send


def standard_forward(c: CompiledStandard, v_shards, local_compute: str = "auto",
                     materialize_x: bool = False,
                     fault_spec: Optional[torch.Tensor] = None):
    """w = A @ v by Algorithm 1: every rank gathers one padded message per
    destination rank from v_loc, one flat exchange, the recv buffer is
    gathered from the received slots, then local compute runs over the
    two segments ``(v_loc, buf)``.  Shards as in :func:`nap_forward`;
    ``materialize_x`` concatenates the two segments first (bit-equal on
    the BSR path).  ``fault_spec`` runs the instrumented program and
    returns ``(w, chk, abft)`` as :func:`nap_forward` does, with the one
    ``pair`` phase over ``n_procs`` slots."""
    fmt = c.resolve_local_compute(local_compute)
    {"coo": c.ensure_coo, "ell": c.ensure_ell, "bsr": c.ensure_fused}[fmt]()
    v, single = _rank_batch(c, v_shards, c.cols_pad)
    p, _, nv = v.shape
    wire = None
    if fault_spec is not None:
        c.ensure_abft()
        wire = _Wire(fault_spec, "standard")
    segs = (v, _exchange_pair(c, v, wire))
    if fmt == "bsr":
        t = c.tensors(["fused_cols", "fused_blocks"])
        bn = c.block_shape[1]
        if materialize_x:
            w = fused_bsr_spmm(t["fused_cols"], t["fused_blocks"],
                               torch.cat(segs, dim=1).reshape(p, -1, bn, nv))
        else:
            w = fused_bsr_spmm_packed(t["fused_cols"], t["fused_blocks"],
                                      tuple(s.reshape(p, -1, bn, nv) for s in segs))
        w = w.reshape(p, -1, nv)[:, :c.rows_pad]
    elif fmt == "ell":
        t = c.tensors(["ell_cols", "ell_vals"])
        xs = (torch.cat(segs, dim=1),) if materialize_x else segs
        w = ell_spmm_packed(t["ell_cols"], t["ell_vals"], xs)
    else:
        vals = c.tensors(["A_vals"])["A_vals"]
        contrib = vals[..., None] * _gather(c, torch.cat(segs, dim=1), "A_cols")
        w = _scatter(c, contrib, "A_rows", c.rows_pad)
    if wire is None:
        return _unbatch(c, w.contiguous(), single)
    w = wire.fault("compute", w[:, None])[:, 0]
    abft = _abft(c, w, tuple(c.tensors(["abft_col", "abft_col_abs"]).values()), segs)
    return _unbatch(c, w, single), wire.chk(c, ("pair",), c.topo.n_procs), abft


def standard_transpose(c: CompiledStandard, u_shards,
                       local_compute: str = "auto",
                       live_scatter: bool = True,
                       fault_spec: Optional[torch.Tensor] = None):
    """z = A.T @ u, the exact adjoint of :func:`standard_forward`: the
    transposed local compute over the packed contribution domain
    ``[z | buf]``, the buffer contributions scattered back into the recv
    slots, the exchange re-applied, and the returned contributions
    scattered through ``send_idx`` into the owners' rows.

    The padding slots of ``send_idx`` carry exact zeros to row 0 of
    their rank; ``live_scatter`` (the default) scatters only the live
    slots (``send_counts``), which gives the same sums up to the sign of
    a zero without ~P * P * pair_pad atomics on P addresses.
    ``live_scatter=False`` is the literal adjoint, kept to measure it.

    ``fault_spec`` runs the instrumented program (``(z, chk, abft)``):
    the compute fault and the ABFT check on the packed contributions,
    then the ``pair`` exchange of the padded contribution messages,
    checksummed whole (padding included) on both sides.
    """
    fmt = c.resolve_transpose_local_compute(local_compute)
    (c.ensure_ell_t if fmt == "ell" else c.ensure_coo)()
    u, single = _rank_batch(c, u_shards, c.rows_pad)
    p, _, nv = u.shape
    cols_pad, pair_pad, n_procs = c.cols_pad, c.pair_pad, c.topo.n_procs
    wire = None
    if fault_spec is not None:
        c.ensure_abft()
        wire = _Wire(fault_spec, "standard")
    if fmt == "ell":
        t = c.tensors(["ell_t_cols", "ell_t_vals"])
        contrib = ell_spmm_packed(t["ell_t_cols"], t["ell_t_vals"], (u,))
    else:
        vals = c.tensors(["A_vals"])["A_vals"]
        contrib = _scatter(c, vals[..., None] * _gather(c, u, "A_rows"),
                           "A_cols", c.n_x)
    abft = None
    if wire is not None:
        contrib = wire.fault("compute", contrib[:, None])[:, 0]
        abft = _abft(c, contrib, tuple(c.tensors(["abft_row", "abft_row_abs"]).values()),
                     (u,))
    # reverse of buf = recv[buf_gather], then the exchange (an involution)
    recv_c = _scatter(c, contrib[:, cols_pad:], "buf_gather", n_procs * pair_pad)
    if wire is None:
        out_c = rank_all_to_all(recv_c.reshape(p, n_procs, pair_pad, nv), c.mesh)
    else:
        out_c = wire.exchange("pair", recv_c.reshape(p, n_procs, pair_pad, nv),
                              functools.partial(rank_all_to_all, mesh=c.mesh))
    del recv_c
    # reverse of send = v_loc[send_idx]
    if live_scatter:
        pos, rows = c.live_send_slots()
        back = torch.zeros((p * cols_pad, nv), dtype=out_c.dtype, device=out_c.device)
        back.index_add_(0, rows, out_c.reshape(-1, nv).index_select(0, pos))
        back = back.reshape(p, cols_pad, nv)
    else:
        back = _scatter(c, out_c, "send_idx", cols_pad)
    z = _unbatch(c, (contrib[:, :cols_pad] + back).contiguous(), single)
    if wire is None:
        return z
    return z, wire.chk(c, ("pair",), n_procs), abft


# ---------------------------------------------------------------------------
# Traffic accounting
# ---------------------------------------------------------------------------

def padded_traffic(c, integrity: str = "off") -> Dict[str, object]:
    """Padded (what the static exchanges move) vs effective (the plan's
    true payloads) bytes per phase, float32 payloads; the transpose
    direction's per-rank figures come from the recv lists.  NAP plans
    have the phases full / init / inter / final, multi-step plans also
    "direct", standard plans the one "pair" exchange.  With ``integrity``
    on, ``{phase}_checksum`` counts the checksum words the instrumented
    program exchanges per phase (one u32 per slot and rank) and
    ``checksum_total`` their sum."""
    topo, plan = c.topo, c.plan
    if plan is None:
        return {}
    n = topo.n_procs
    if isinstance(c, CompiledStandard):
        phases = {"pair": (n, plan.sends, plan.recvs)}
        pads = {"pair": c.pair_pad}
    else:
        phases = {
            "full": (topo.ppn, plan.local_full_sends, plan.local_full_recvs),
            "init": (topo.ppn, plan.local_init_sends, plan.local_init_recvs),
            "inter": (topo.n_nodes, plan.inter_sends, plan.inter_recvs),
            "final": (topo.ppn, plan.local_final_sends, plan.local_final_recvs),
        }
        if c.comm == "multistep":
            direct = c.ms_plan.direct
            phases["direct"] = (n, direct.sends, direct.recvs)
        pads = c.pads
    out: Dict[str, object] = {}
    transpose: Dict[str, int] = {}
    for name, (n_slots, sends, recvs) in phases.items():
        padded = n * n_slots * pads[name] * 4
        for d, lists in ((out, sends), (transpose, recvs)):
            d[f"{name}_padded"] = padded
            d[f"{name}_effective"] = 4 * sum(m.size for msgs in lists for m in msgs)
            d[f"{name}_max_rank_effective"] = 4 * max(
                (sum(m.size for m in msgs) for msgs in lists), default=0)
            if integrity != "off":
                d[f"{name}_checksum"] = n * n_slots * 4
    if integrity != "off":
        out["checksum_total"] = transpose["checksum_total"] = sum(
            n * n_slots * 4 for n_slots, _, _ in phases.values())
    out["transpose"] = transpose
    return out
