#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the node-aware SpMV,
the multi-step exchange, wire integrity, the float64 simulate backend,
the distributed SpGEMM and the AMG solver path, and the gemma2-2b
serving path.

    python3 chip_smoke.py            # full size; needs one CUDA GPU and nvcc

Phases, each fatal on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. the build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, all sources in parallel) and its seconds;
3. each SpMV kernel against its plain PyTorch version at the main path's
   shapes: max error, kernel / plain / library ms (CUDA events, median of
   20 single calls), the kernel's device time per launch (``device_ms``:
   events around 20 back-to-back launches) and the least time the card
   could take (bound).  The library is ``torch.sparse.mm`` on a CSR
   tensor of the real nonzeros and, for the BSR kernels, on a BSR tensor
   of the live blocks (the same bytes; a refusal by torch is printed and
   recorded as null).  The padded BSR kernel (``bsr_spmm_padded``) runs
   on ``BSR.from_csr`` of the main-path matrix with (8, 128) blocks and
   of the BSR-path matrix with (128, 128) blocks, each first driven
   through ``bsr_spmv`` and held against the float64 host CSR matvec.
   Every BSR layout is also held at nv = 3 and 8 and with its slots
   permuted within each block row (padding inside the rows), and three
   ragged block shapes ((4, 24), (12, 20), (5, 6); 37 slots a row) go
   through all three BSR entry points; packed and concatenated stay
   bit-equal;
4. the main path at full size: the paper's rotated anisotropic diffusion
   (FE 9-point, eps 0.001, theta pi/6) on a 2024 x 2024 grid (4,096,576
   rows) over Topology(32, 16), 512 ranks: ``op @ v`` for nv = 1 and 8,
   then ``op.T @ u``, held against a float64 host CSR matvec at rtol 1e-4
   / atol 1e-5, through the ELL kernel;
5. the fused-BSR forward on a 512 x 512 grid over the same topology,
   packed and concatenated x bit-equal, both against the float64 oracle;
6. the standard method (Algorithm 1, the paper's baseline) on the main
   path's matrix and topology: forward nv = 1 and 8, then the transpose
   (the live-slot scatter, and the literal adjoint timed beside it),
   against the same oracle, through the ELL kernel; padded vs effective
   exchange bytes and the paper's Blue Waters message model for both
   methods; then the standard fused-BSR forward at the BSR path's size;
7. the multi-step exchange on the main path's matrix and topology:
   ``choose_comm``'s verdicts with every candidate's injected inter-node
   bytes, then ``method="multistep"`` forward nv = 1 and 8 and the
   transpose against the same oracle, through the ELL kernel (held
   against its plain version at this plan's shapes), the direct
   exchange's padded vs live bytes, its live-slot and literal padded
   forms bit-equal and timed side by side, and ``threshold=1`` bit-equal
   to the node-aware operator of phase 4 (transposes in PyTorch's
   deterministic mode);
8. wire integrity on the main path's matrix and topology, for the nap,
   multistep and standard methods (``integrity="detect"``, ELL): clean
   detect applies at nv = 1 and 8 in both directions, bit-equal to the
   uninstrumented program (transposes in deterministic mode) with zero
   wire and ABFT mismatches; for every message phase and direction one
   real edge whose payload is neither all zero nor constant (from a
   recorded clean run), every fault kind on it detected with the
   receiver, slot, phase and scope ``scope_for`` gives, and a compute
   bitflip on bit 30 of a value in [0.1, 1) caught by ABFT; device-program
   ms (median of 10) and peak memory, bare and instrumented; then
   ``integrity="recover"`` bit-equal to the clean result after one retry
   each way, one detect apply of the fused-BSR forward at the BSR path's
   grid, and the float64 simulate backend: all three methods at the BSR
   path's grid against the device programs and the float64 host product,
   the node-aware method at full size against phase 4's device results,
   and one scripted wire fault attributed as on the device;
9. the AMG solver path on the same matrix: the smoothed-aggregation
   hierarchy (theta 0.1, coarse_size 2 x ranks), ``level_operators(...,
   comm="auto", materialize=True, spgemm_backend="torch")``: every
   coarse A is the product of two device SpGEMMs (``A @ P``, then
   ``R @ AP``), held against the host assembly at the reference's
   chained float32 tolerance (rtol 5e-5 x depth), and the SpGEMM run
   counter must rise by 2 x (levels - 1); per product the host compile
   seconds, ``exp_pad``, ``c_nnz_pad``, the value pads, padded vs live
   value bytes per phase, the inter-node value bytes of the nap and
   standard plans (the paper's setup traffic), device-program ms (CUDA
   events, median of 10), peak memory and a bound (the expansion read
   once, C written once, the live values exchanged once, at 3.35 TB/s);
   per level the rows, nnz, both directions' exchange and local-format
   verdicts and the host seconds of chooser and compile; every
   distributed level's ``A @ v``, ``A.T @ u``, ``P @ x``, ``R @ r`` and
   lazy ``(R @ A @ P) @ x`` against float64 host products (rtol 1e-4,
   atol 1e-5 of max |ref|), the ELL kernel against its plain version on
   each level's arrays, each level's device programs timed; level 0's
   two products in float64 against host ``csr_matmul`` (rtol 1e-12, atol
   1e-13 x max |ref|), its ``galerkin(materialize=True)`` against the
   lazy chain (one apply each, timed side by side) and its standard
   ``A @ P`` from the live slots of the pair exchange (the literal
   table's bytes printed); then 10 iterations of AMG-preconditioned CG
   through the device operators beside the same solver on float64 host
   matvecs, the true residual of each iteration side by side, and the
   V-cycle's wall and ELL launches;
9b. the distributed SpGEMM at the BSR path's grid: level 0's ``A @ P``
   on the simulate backend bit-equal to ``csr_matmul`` (nap and
   standard), the device program in float32 (rtol 1e-4, atol 1e-4) and
   float64 (rtol 1e-12, atol 1e-13),
   ``smoothed_aggregation_hierarchy(rap=distributed_rap(backend=
   "torch", cross_check=True))`` with every level's structure equal to
   the host hierarchy's, and ``integrity="detect"`` with every fault
   kind on a live edge of every message phase (nap: full, init, inter,
   final; standard: pair) detected with its ``(phase, node, proc,
   slot)``, ``"recover"`` bit-equal to the clean product and the clean
   detect run bit-equal to off (deterministic mode; for the standard
   method that holds the instrumented program's literal padded pair
   exchange against the bare program's live slots);
9c. the port's two examples, ``repro_torch.examples.quickstart`` and
   ``amg_spmv``, on the card to their final checks;
10. the decode-attention kernel against its plain version at gemma2-2b's
   decode_32k shapes: B = 8, S = 32768, Hkv = 4, g = 2, D = 256, softcap
   50, lengths ragged in [1, S] (1, 17, 4096, 4097, S and three drawn
   from the seed); the bf16 [B, S, Hkv, D] cache read in place with
   window 0 and with window 4096, then a float32 [B, Hkv, S, D] copy.
   Max error against a per-sequence tolerance that scales with the
   sequence's output (``attn_tolerance``: a dropped partial or skipped
   rows of a long sequence fail it), kernel /
   plain / ``scaled_dot_product_attention`` ms (softcap 0 for the
   library, where it computes the same function), the profiler's device
   time of the kernel's two launches, and the bound over the k/v rows
   inside the masks; then the kernel's other query-tile instantiations
   at small shapes, untimed;
11. the serving path at full width: gemma2-2b, all 26 layers, bf16,
   weights drawn from the seed on the card, through
   ``repro_torch.launch.serve.generate``: batch 4, a 512-token prompt
   teacher-forced through ``decode_step``, then 32 greedy tokens,
   max_seq 1024.  Median step ms, the kernel's launches (must equal
   layers x steps), peak memory, the profiler's busy share of a step,
   the step's bound (every parameter byte and the cache rows read once),
   finite logits; then the kernel against its plain version on the
   served bf16 cache (read in place, 544 of 1024 positions) of an even
   layer (window 4096) and an odd one (window 1024), with a query drawn
   from the seed, at the same tolerance and timed;
12. the whole decode step checked on the card: the same config with 2
   layers in float32, 8 steps through the kernel, then the same steps
   with the plain version swapped into ``models.attention`` by this
   script, logits compared at atol 1e-3;
13. the whole script's seconds, a JSON line of every kernel (with
    ``device_ms`` and, for the BSR kernels, ``library_bsr_ms``), then the
    result line.

Launch counts are reset right before each path is driven and read right
after, and the peak of allocated device memory is reset and read around
it.  Each phase frees its tensors before the next.  TF32 is switched off,
so the plain versions' products are f32.  ``--n`` and ``--bsr-n`` shrink
the grids of the SpMV phases and ``--lm-layers`` the depth of phase 11,
for a short first call after a kernel change.
"""
import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script needs a GPU")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.amg import (LevelOperators, amg_vcycle, cg_solve,  # noqa: E402
                             level_operators, smoothed_aggregation_hierarchy)
from repro_torch.api import operator  # noqa: E402
from repro_torch.comm import choose_comm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cost_model import BLUE_WATERS  # noqa: E402
from repro_torch.core.integrity import (FAULT_KINDS, IntegrityError,  # noqa: E402
                                        MessageFault, message_phases, scope_for)
from repro_torch.core.partition import contiguous_partition  # noqa: E402
import repro_torch.core.spmv_torch as spmv_torch  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.kernels import build_all, launches, reset_launches  # noqa: E402
from repro_torch.kernels.bsr_spmv import (bsr_spmm_padded,  # noqa: E402
                                          bsr_spmm_padded_ref, bsr_spmv,
                                          fused_bsr_spmm,
                                          fused_bsr_spmm_packed,
                                          fused_bsr_spmm_packed_ref,
                                          fused_bsr_spmm_ref)
from repro_torch.kernels.decode_attn import (decode_attention_grouped,  # noqa: E402
                                             decode_attention_ref)
from repro_torch.kernels.ell_spmv import (ell_spmm_packed,  # noqa: E402
                                          ell_spmm_packed_ref)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.amg.matmul import csr_matmul  # noqa: E402
from repro_torch.examples import amg_spmv, quickstart  # noqa: E402
import repro_torch.spgemm.spgemm_torch as spgemm_torch  # noqa: E402
from repro_torch.spgemm import (assert_matches_host, build_spgemm_plan,  # noqa: E402
                                clear_spgemm_cache, compile_spgemm,
                                distributed_rap, distributed_spgemm,
                                pack_b_values, spgemm_program,
                                torch_spgemm_runs, unpack_c_values)
from repro_torch.spgemm.plan import message_value_size  # noqa: E402
from repro_torch.models import attention, build_model, count_params  # noqa: E402
from repro_torch.sparse import BSR, rotated_anisotropic_2d  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor
# cores (all kernels run f32 FMAs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
U32 = 2.0 ** -24            # f32 unit roundoff
TOL = dict(rtol=1e-4, atol=1e-5)
DEV = torch.device("cuda")
T_START = time.perf_counter()


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single-call CUDA-event timings, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n=20, warmup=3):
    """Device time per launch: CUDA events around ``n`` back-to-back calls
    (after a warm-up), divided by ``n``.  The wrapper's host work overlaps
    the device's queue unless it is longer than the kernel."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def host_apply(a, v, transpose=False):
    """float64 CSR matvec on the host, one bincount per rhs column."""
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    src, dst = (rows, a.indices) if transpose else (a.indices, rows)
    v2 = v.reshape(v.shape[0], -1)
    out = np.stack([np.bincount(dst, weights=a.data * v2[src, j],
                                minlength=a.shape[0])
                    for j in range(v2.shape[1])], axis=1)
    return out.reshape(v.shape)


def csr_from_coo(rows, cols, vals, shape):
    """A torch sparse CSR tensor on the card (the library yardstick)."""
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def check_close(name, got, want, slots, scale):
    """|kernel - plain| <= 2 * slots * u * max_i sum_k |a_ik x_k|: two
    summation orders of the same f32 products (slots = terms per sum)."""
    err = float((got - want).abs().max())
    tol = 2.0 * slots * U32 * scale
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_oracle(label, got, want, ref="float64 host CSR"):
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: bad result {got.shape}")
    np.testing.assert_allclose(got, want, **TOL)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"  {label}: matches {ref} (max abs err / max |ref| {rel:.3e})")


def free():
    gc.collect()
    torch.cuda.empty_cache()


def ell_case(name, source, replaces, cols, vals, xs):
    """Kernel vs plain at one ELL call site; returns the kernels-line entry."""
    out = ell_spmm_packed(cols, vals, xs)
    plain = ell_spmm_packed_ref(cols, vals, xs)
    scale = float(ell_spmm_packed_ref(cols, vals.abs(),
                                      tuple(x.abs() for x in xs)).max())
    err = check_close(name, out, plain, cols.shape[-1], scale)
    nv = xs[0].shape[-1]
    p, n_rows = cols.shape[:2]
    n_x = sum(x.shape[1] for x in xs)
    live = cols >= 0
    a = csr_from_coo(
        (torch.arange(p * n_rows, device=cols.device).reshape(p, n_rows, 1)
         .expand_as(cols))[live],
        (cols.long() + (torch.arange(p, device=cols.device) * n_x)[:, None, None])[live],
        vals[live], (p * n_rows, p * n_x))
    x_cat = torch.cat(xs, dim=1).reshape(p * n_x, nv)
    lib = torch.sparse.mm(a, x_cat).reshape(p, n_rows, nv)
    print(f"  {name}: library result max_abs_err {float((lib - plain).abs().max()):.3e}")
    nbytes = (cols.nbytes + vals.nbytes + sum(x.nbytes for x in xs)
              + out.nbytes)
    bms, by = bound_ms(nbytes, 2.0 * int(live.sum()) * nv)
    entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=0, max_abs_err=err,
                 ms=time_ms(lambda: ell_spmm_packed(cols, vals, xs)),
                 device_ms=device_ms(lambda: ell_spmm_packed(cols, vals, xs)),
                 plain_ms=time_ms(lambda: ell_spmm_packed_ref(cols, vals, xs)),
                 bound_ms=bms, bound_by=by,
                 library_ms=time_ms(lambda: torch.sparse.mm(a, x_cat)))
    print(f"  {name}: shapes cols {tuple(cols.shape)} segments "
          f"{[tuple(x.shape) for x in xs]}; {nbytes / 1e6:.1f} MB; kernel "
          f"{entry['ms']:.4f} ms (device {entry['device_ms']:.4f}), bound {bms:.4f} ms "
          f"({by}), plain {entry['plain_ms']:.4f} ms, torch.sparse.mm CSR "
          f"{entry['library_ms']:.4f} ms")
    return entry


def bsr_library(label, crow, col, vals, size, x, want):
    """The same-format yardstick: ``torch.sparse.mm`` on a BSR tensor of
    the live blocks, which reads the kernel's bytes.  Its ms, or None
    (printed with torch's message) where torch on the card refuses it."""
    try:
        a = torch.sparse_bsr_tensor(crow, col, vals, size=size)
        got = torch.sparse.mm(a, x)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, ValueError) as exc:
        print(f"  {label}: torch.sparse.mm on a BSR tensor of {tuple(vals.shape[1:])} "
              f"blocks refused: {' '.join(str(exc).split())[:300]}")
        return None
    print(f"  {label}: BSR library result max_abs_err "
          f"{float((got.reshape(want.shape) - want).abs().max()):.3e}")
    return time_ms(lambda: torch.sparse.mm(a, x))


def fmt_ms(ms):
    return "refused" if ms is None else f"{ms:.4f} ms"


def bsr_held(label, kernel, plain, cols, blocks, xs):
    """One BSR kernel call against its plain version (``check_close``);
    ``kernel`` and ``plain`` take (cols, blocks, xs).  Returns both
    results and the max error."""
    out, want = kernel(cols, blocks, xs), plain(cols, blocks, xs)
    scale = float(plain(cols, blocks.abs(), [x.abs() for x in xs]).max())
    err = check_close(label, out, want, cols.shape[-1] * blocks.shape[-1], scale)
    return out, want, err


def cat(xs):
    """The concatenated x (no copy when there is one segment, so that a
    timed call of the concatenated kernel times the kernel alone)."""
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)


# the three BSR entry points over (cols, blocks, xs) and their plain versions
BSR_PACKED = (lambda c, b, xs: fused_bsr_spmm_packed(c, b, xs),
              lambda c, b, xs: fused_bsr_spmm_packed_ref(c, b, xs))
BSR_CONCAT = (lambda c, b, xs: fused_bsr_spmm(c, b, cat(xs)),
              lambda c, b, xs: fused_bsr_spmm_ref(c, b, cat(xs)))
BSR_PADDED = (lambda c, b, xs: bsr_spmm_padded(c, b, xs[0]),
              lambda c, b, xs: bsr_spmm_padded_ref(c, b, xs[0]))


def permute_slots(cols, blocks, gen):
    """The same matrix with the slots of every block row in a random order,
    cols and blocks together, so that padding slots land inside rows."""
    ktot = cols.shape[-1]
    perm = torch.rand(cols.shape, generator=gen, device=DEV).reshape(-1, ktot).argsort(-1)
    flat = (torch.arange(perm.shape[0], device=DEV)[:, None] * ktot + perm).reshape(-1)
    return (cols.reshape(-1)[flat].reshape(cols.shape),
            blocks.reshape(cols.numel(), -1)[flat].reshape(blocks.shape))


def bsr_variants(label, fused, cols, blocks, xs1, gen):
    """The cases the kernel design must survive on one layout: nv = 3 and
    8, then nv = 1 with the slots permuted; each kernel against its plain
    version, the packed and concatenated kernels bit-equal.  ``fused``:
    the rank-batched layout (packed and concatenated), else the padded
    one of one matrix."""
    for case in ("nv=3", "nv=8", "permuted slots"):
        c, b, xs = cols, blocks, xs1
        if case == "permuted slots":
            c, b = permute_slots(cols, blocks, gen)
            print(f"  {label} permuted: {int(((c[..., :-1] < 0) & (c[..., 1:] >= 0)).sum())}"
                  f" padding slots before a live one")
        else:
            xs = [torch.randn((*x.shape[:-1], int(case[3:])), generator=gen, device=DEV)
                  for x in xs1]
        if fused:
            o_p = bsr_held(f"{label} packed {case}", *BSR_PACKED, c, b, xs)[0]
            o_c = bsr_held(f"{label} concatenated {case}", *BSR_CONCAT, c, b, xs)[0]
            if not torch.equal(o_p, o_c):
                raise AssertionError(f"{label} {case}: packed and concatenated kernels differ")
            del o_p, o_c
        else:
            bsr_held(f"{label} {case}", *BSR_PADDED, c, b, xs)
        del c, b, xs
        free()


def ragged_bsr_cases(gen):
    """Block shapes off the 16-byte path and off the 8-row band, on small
    matrices of 3 ranks, 7 block rows and 37 slots (past one 32-id load),
    padding anywhere (block row 0 all padding): every entry point against
    its plain version at nv = 1, 3 and 8."""
    p, nbr, ktot, seg = 3, 7, 37, (5, 3, 4)
    for bm, bn in ((4, 24), (12, 20), (5, 6)):
        cols = torch.randint(0, sum(seg), (p, nbr, ktot), generator=gen, device=DEV,
                             dtype=torch.int32)
        pad = torch.rand((p, nbr, ktot), generator=gen, device=DEV) < 0.4
        pad[:, 0] = True
        pad[..., 1] = True
        cols[pad] = -1
        blocks = torch.randn((p, nbr, ktot, bm, bn), generator=gen, device=DEV)
        blocks[pad] = 0.0
        for nv in (1, 3, 8):
            xs = [torch.randn((p, n, bn, nv), generator=gen, device=DEV) for n in seg]
            label = f"ragged ({bm}, {bn}) nv={nv}"
            o_p = bsr_held(f"{label} packed", *BSR_PACKED, cols, blocks, xs)[0]
            o_c = bsr_held(f"{label} concatenated", *BSR_CONCAT, cols, blocks, xs)[0]
            if not torch.equal(o_p, o_c):
                raise AssertionError(f"{label}: packed and concatenated kernels differ")
            # one rank's operands as fresh (16-byte aligned) tensors
            bsr_held(f"{label} padded", *BSR_PADDED, cols[1].clone(), blocks[1].clone(),
                     [torch.cat(xs, dim=1)[1].clone()])


def bsr_case(name, replaces, cols, blocks, xs, packed):
    """Kernel vs plain for one fused-BSR wrapper; the kernels-line entry."""
    kernel, plain = BSR_PACKED if packed else BSR_CONCAT
    run = lambda: kernel(cols, blocks, xs)  # noqa: E731
    plain_fn = lambda: plain(cols, blocks, xs)  # noqa: E731
    out, want, err = bsr_held(name, kernel, plain, cols, blocks, xs)
    p, nbr, ktot, bm, bn = blocks.shape
    nv = xs[0].shape[-1]
    n_bc = sum(x.shape[1] for x in xs)
    live = cols >= 0
    dense = blocks[live]                                  # [n_live, bm, bn]
    b_idx = live.nonzero()                                # (rank, brow, slot)
    nz = dense.nonzero()                                  # (block, m, n)
    blk = b_idx[nz[:, 0]]
    rows = (blk[:, 0] * nbr + blk[:, 1]) * bm + nz[:, 1]
    ccol = (blk[:, 0] * n_bc + cols[live].long()[nz[:, 0]]) * bn + nz[:, 2]
    size = (p * nbr * bm, p * n_bc * bn)
    a = csr_from_coo(rows, ccol, dense[nz[:, 0], nz[:, 1], nz[:, 2]], size)
    x_cat = torch.cat(xs, dim=1).reshape(p * n_bc * bn, nv)
    lib = torch.sparse.mm(a, x_cat).reshape(out.shape)
    print(f"  {name}: library result max_abs_err {float((lib - want).abs().max()):.3e}")
    # the live blocks as a BSR tensor: block rows rank * nbr + i, block
    # columns rank * n_bc + cols, sorted within each block row
    brow = b_idx[:, 0] * nbr + b_idx[:, 1]
    bcol = b_idx[:, 0] * n_bc + cols[live].long()
    order = (brow * (p * n_bc) + bcol).argsort()
    crow = torch.zeros(p * nbr + 1, dtype=torch.long, device=DEV)
    crow[1:] = torch.bincount(brow, minlength=p * nbr).cumsum(0)
    lib_bsr = bsr_library(name, crow, bcol[order], dense[order], size, x_cat, want)
    n_live = int(live.sum())
    nbytes = (cols.nbytes + n_live * bm * bn * 4 + sum(x.nbytes for x in xs)
              + out.nbytes)
    bms, by = bound_ms(nbytes, 2.0 * n_live * bm * bn * nv)
    entry = dict(name=name, route="cuda", source="src/repro_torch/csrc/bsr_spmm.cu",
                 replaces=replaces, launches=0, max_abs_err=err,
                 ms=time_ms(run), device_ms=device_ms(run), plain_ms=time_ms(plain_fn),
                 bound_ms=bms, bound_by=by,
                 library_ms=time_ms(lambda: torch.sparse.mm(a, x_cat)),
                 library_bsr_ms=lib_bsr)
    print(f"  {name}: blocks {tuple(blocks.shape)} ({n_live} live) segments "
          f"{[tuple(x.shape) for x in xs]}; {nbytes / 1e6:.1f} MB; kernel "
          f"{entry['ms']:.4f} ms (device {entry['device_ms']:.4f}, "
          f"{100 * bms / entry['device_ms']:.1f}% of bound), bound {bms:.4f} ms ({by}), "
          f"plain {entry['plain_ms']:.4f} ms, torch.sparse.mm CSR "
          f"{entry['library_ms']:.4f} ms, BSR {fmt_ms(lib_bsr)}")
    return entry


def padded_bsr_case(label, a, bm, bn, v, want, gen):
    """The padded BSR kernel on ``BSR.from_csr(a)``: first the user's path
    ``bsr_spmv`` (counted, against the float64 oracle ``want``), then
    the kernel against its plain version, timed beside the CSR and BSR
    library calls, then the variants; the kernels-line entry."""
    t0 = time.perf_counter()
    b = BSR.from_csr(a, bm=bm, bn=bn)
    t_conv = time.perf_counter() - t0
    w, counts = drive(f"{label} bsr_spmv", lambda: bsr_spmv(b, v))
    check_oracle(f"{label} bsr_spmv", w.cpu().numpy()[: a.shape[0]], want)
    del w
    cols_np, blocks_np, _ = b.padded_uniform()
    cols = torch.from_numpy(cols_np).to(DEV)
    blocks = torch.from_numpy(blocks_np).to(DEV)
    del cols_np, blocks_np
    x = torch.zeros(b.shape[1], device=DEV)
    x[: a.shape[1]] = torch.from_numpy(v).to(DEV, torch.float32)
    x = x.reshape(-1, bn, 1)
    run = lambda: bsr_spmm_padded(cols, blocks, x)  # noqa: E731
    out, plain, err = bsr_held(label, *BSR_PADDED, cols, blocks, [x])
    lib_a = torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr), torch.from_numpy(a.indices),
        torch.from_numpy(a.data.astype(np.float32)), size=a.shape).to(DEV)
    x_lib = x.reshape(-1, 1)[: a.shape[1]]
    lib = torch.sparse.mm(lib_a, x_lib)
    print(f"  {label}: library result max_abs_err "
          f"{float((lib - plain.reshape(-1, 1)[: a.shape[0]]).abs().max()):.3e}")
    n_live, n_slots = b.n_blocks, cols.numel()
    tail = cols.nbytes + x.nbytes + out.nbytes
    bms, by = bound_ms(tail + n_live * bm * bn * 4, 2.0 * n_live * bm * bn)
    pad_ms, pad_by = bound_ms(tail + blocks.nbytes, 2.0 * n_slots * bm * bn)
    entry = dict(name="bsr_spmm_padded", route="cuda",
                 source="src/repro_torch/csrc/bsr_spmm.cu",
                 replaces="src/repro/kernels/bsr_spmv/kernel.py:57",
                 launches=counts.get("bsr_spmm_padded", 0), max_abs_err=err,
                 ms=time_ms(run), device_ms=device_ms(run),
                 plain_ms=time_ms(lambda: bsr_spmm_padded_ref(cols, blocks, x)),
                 bound_ms=bms, bound_by=by,
                 library_ms=time_ms(lambda: torch.sparse.mm(lib_a, x_lib)))
    del lib_a, lib, out
    vals = torch.from_numpy(b.data).to(DEV)
    entry["library_bsr_ms"] = bsr_library(
        label, torch.from_numpy(b.indptr).to(DEV, torch.long),
        torch.from_numpy(b.indices).to(DEV, torch.long), vals, b.shape,
        x.reshape(-1, 1), plain.reshape(-1, 1))
    del vals, b, plain
    free()
    print(f"  {label}: BSR.from_csr {t_conv:.2f} s; blocks {tuple(blocks.shape)} "
          f"({n_live} live, {n_live * bm * bn * 4 / 1e9:.3f} GB; padded "
          f"{blocks.nbytes / 1e9:.3f} GB); kernel {entry['ms']:.4f} ms (device "
          f"{entry['device_ms']:.4f}, {100 * bms / entry['device_ms']:.1f}% of bound), "
          f"bound {bms:.4f} ms ({by}) over the live blocks, {pad_ms:.4f} ms ({pad_by}) "
          f"with the padding; plain {entry['plain_ms']:.4f} ms, torch.sparse.mm "
          f"CSR {entry['library_ms']:.4f} ms, BSR {fmt_ms(entry['library_bsr_ms'])}")
    bsr_variants(label, False, cols, blocks, [x], gen)
    return entry


def profile_program(label, fn, wall_ms):
    """One traced call: device kernel time by operator, and the device's
    busy share of the call's CUDA-event wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"  profile {label}: kernels busy {busy:.4f} ms of a {wall_ms:.4f} ms "
          f"call ({100 * busy / wall_ms:.1f}%), {sum(e.count for e in kernels)} "
          f"kernels; top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.4f} ms x{e.count}"
              for e in top))


def drive(label, fn):
    """Run one path with the launch counts and the device-memory peak
    reset just before it."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(launches)
    print(f"  {label}: launches {counts}; peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return out, counts


def time_programs(ex, calls, profile=True):
    """Device-program ms (median of 10, pack/unpack excluded) and one
    profile of each ``(label, direction, operand, options)``; ``ex`` is
    one executor or a ``{direction: executor}`` map."""
    out = {}
    for lbl, direction, v, opts in calls:
        e = ex[direction] if isinstance(ex, dict) else ex
        shards = e.packed(direction, v)
        prog = e.program(direction, **opts)
        out[lbl] = time_ms(lambda: prog(shards), reps=10)
        if profile:
            profile_program(lbl, lambda: prog(shards), out[lbl])
        del shards
    print(f"  device program ms (median of 10, pack/unpack excluded): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def traffic_bytes(stats):
    """Padded and effective forward exchange bytes over all phases."""
    padded = sum(v for k, v in stats.items() if k.endswith("_padded"))
    effective = sum(v for k, v in stats.items() if k.endswith("_effective")
                    and not k.endswith("max_rank_effective"))
    return padded, effective


def phase_kernels(c, cb, a, a_b, oracles, gen):
    """[3] every kernel against its plain version."""
    print("[3] kernels against plain PyTorch versions")
    p = c.topo.n_procs

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    t = c.tensors(["ell_cols", "ell_vals", "ell_t_cols", "ell_t_vals"])
    seg_lens = (c.cols_pad, c.pads["bnode"], c.pads["boff"])
    ell_src = "src/repro_torch/csrc/ell_spmm.cu"
    ell_ref = "src/repro/kernels/ell_spmv/kernel.py:79"
    entries = [
        ell_case("ell_spmm_packed", ell_src, ell_ref, t["ell_cols"],
                 t["ell_vals"], tuple(randn(p, L, 1) for L in seg_lens)),
        ell_case("ell_spmm_packed:transpose", ell_src, ell_ref, t["ell_t_cols"],
                 t["ell_t_vals"], (randn(p, c.rows_pad, 1),)),
    ]
    xs8 = tuple(randn(p, L, 8) for L in seg_lens)
    check_close("ell_spmm_packed nv=8",
                ell_spmm_packed(t["ell_cols"], t["ell_vals"], xs8),
                ell_spmm_packed_ref(t["ell_cols"], t["ell_vals"], xs8), c.ell_kmax,
                float(ell_spmm_packed_ref(t["ell_cols"], t["ell_vals"].abs(),
                                          tuple(x.abs() for x in xs8)).max()))
    print(f"  ell_spmm_packed nv=8: kernel "
          f"{time_ms(lambda: ell_spmm_packed(t['ell_cols'], t['ell_vals'], xs8)):.4f}"
          f" ms, plain "
          f"{time_ms(lambda: ell_spmm_packed_ref(t['ell_cols'], t['ell_vals'], xs8)):.4f} ms")

    tb = cb.tensors(["fused_cols", "fused_blocks"])
    bn = cb.block_shape[1]
    bsegs = tuple(randn(p, L // bn, bn, 1)
                  for L in (cb.cols_pad, cb.pads["bnode"], cb.pads["boff"]))
    entries.append(bsr_case("fused_bsr_spmm_packed",
                            "src/repro/kernels/bsr_spmv/fused.py:154",
                            tb["fused_cols"], tb["fused_blocks"], bsegs, True))
    entries.append(bsr_case("fused_bsr_spmm",
                            "src/repro/kernels/bsr_spmv/fused.py:57",
                            tb["fused_cols"], tb["fused_blocks"],
                            (torch.cat(bsegs, dim=1),), False))
    bsr_variants(f"fused n={int(np.sqrt(a_b.shape[0]))} {cb.block_shape}", True,
                 tb["fused_cols"], tb["fused_blocks"], bsegs, gen)
    del t, tb, xs8, bsegs
    free()
    ragged_bsr_cases(gen)
    free()

    n_ab = a_b.shape[0]
    entries.append(padded_bsr_case(f"bsr_spmm_padded n={int(np.sqrt(a.shape[0]))} "
                                   f"(8,128)", a, 8, 128, oracles["v1"],
                                   oracles["w1"], gen))
    free()
    padded_bsr_case(f"bsr_spmm_padded n={int(np.sqrt(n_ab))} (128,128)", a_b,
                    128, 128, oracles["vb"], oracles["wb"], gen)
    free()
    return entries


def phase_nap(op, a, oracles):
    """[4] the node-aware main path at full size."""
    print(f"[4] main path: n={int(np.sqrt(a.shape[0]))}, Topology(32, 16), "
          f"local_compute={op.spec.local_compute!r}")
    ex = op.executor
    v1, v8, u1 = oracles["v1"], oracles["v8"], oracles["u1"]
    t0 = time.perf_counter()
    (w1, w8), fwd = drive("forward nv=1 and nv=8", lambda: (op @ v1, op @ v8))
    t_fwd = time.perf_counter() - t0
    (z1,), tr = drive("transpose nv=1", lambda: (op.T @ u1,))
    if op.local_compute != "ell" or op.T.local_compute != "ell":
        raise AssertionError(f"main path did not resolve to ell: "
                             f"{op.local_compute}, {op.T.local_compute}")
    check_oracle("forward nv=1", w1, oracles["w1"])
    check_oracle("forward nv=8", w8, oracles["w8"])
    check_oracle("transpose nv=1", z1, oracles["z1"])
    time_programs(ex, [("forward nv=1", "forward", v1, {}),
                       ("forward nv=8", "forward", v8, {}),
                       ("transpose nv=1", "transpose", u1, {})])
    print(f"  host: first forward pair (pack + program + unpack, nv=1 and "
          f"nv=8) {t_fwd:.2f} s")
    # the NAP results phase 7 holds multistep with threshold=1 against:
    # the forward at nv=1 and the transpose with index_add_ deterministic
    torch.use_deterministic_algorithms(True)
    try:
        z1_det = op.T @ u1
    finally:
        torch.use_deterministic_algorithms(False)
    return fwd, tr, dict(w1=w1, z1=z1_det)


def phase_bsr(op_b, a_b, oracles):
    """[5] the node-aware fused-BSR forward."""
    print(f"[5] bsr forward: n={int(np.sqrt(a_b.shape[0]))}, Topology(32, 16)")
    vb = oracles["vb"][:, None]
    wp, cnt_p = drive("packed x", lambda: op_b @ vb)
    wc, cnt_c = drive("materialize_x", lambda: op_b(vb, materialize_x=True))
    if not np.array_equal(wp, wc):
        raise AssertionError("packed and materialized BSR forwards differ")
    check_oracle("packed x", wp[:, 0], oracles["wb"])
    shards = op_b.executor.packed("forward", vb)
    ms_p = time_ms(lambda: op_b.executor.program("forward")(shards), reps=10)
    ms_c = time_ms(lambda: op_b.executor.program("forward", materialize_x=True)(shards),
                   reps=10)
    print(f"  packed and materialized bit-equal; device program ms packed "
          f"{ms_p:.4f}, materialized {ms_c:.4f}")
    return cnt_p, cnt_c


def phase_standard(a, a_b, topo, part, oracles, nap_summary, full_size):
    """[6] Algorithm 1 at full size, then its fused-BSR forward."""
    print(f"[6] standard method: n={int(np.sqrt(a.shape[0]))}, Topology(32, 16)")
    op = operator(a, topo, part, method="standard")
    t0 = time.perf_counter()
    c = op.executor.compiled
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.ensure_ell()
    c.ensure_ell_t()
    t_ell = time.perf_counter() - t0
    rep = op.autotune_report()
    verdict = (rep["resolved"], rep["transpose_resolved"])
    print(f"[plan] compile_standard {t_compile:.2f} s, ensure_ell + ensure_ell_t "
          f"{t_ell:.2f} s (host plan build {t_compile + t_ell:.2f} s); rows_pad "
          f"{c.rows_pad}, buf_pad {c.buf_pad}, pair_pad {c.pair_pad}, nnz_pad "
          f"{c.nnz_pad}; ell {c.arrays['ell_cols'].shape}, ell_t "
          f"{c.arrays['ell_t_cols'].shape}; send_idx {c.arrays['send_idx'].shape} "
          f"({c.arrays['send_idx'].nbytes / 1e9:.2f} GB); {int(c.send_counts.sum())} "
          f"live slots in {int((c.send_counts > 0).sum())} messages")
    print(f"[plan] autotune verdict forward={verdict[0]} transpose={verdict[1]} "
          f"(times {rep['times']}, transpose {rep['transpose']['times']})")
    if verdict != ("ell", "ell"):
        if full_size:
            raise AssertionError(f"standard plan did not resolve to ell: {verdict}")
        print(f"[plan] verdict is not ell in both directions at this reduced "
              f"size; the phase runs with local_compute='ell'")
        op = operator(a, topo, part, method="standard", local_compute="ell")
        c = op.executor.compiled
    v1, v8, u1 = oracles["v1"], oracles["v8"], oracles["u1"]
    w1, fwd1 = drive("forward nv=1", lambda: op @ v1)
    check_oracle("forward nv=1", w1, oracles["w1"])
    del w1
    w8, fwd8 = drive("forward nv=8", lambda: op @ v8)
    check_oracle("forward nv=8", w8, oracles["w8"])
    del w8
    z1, tr = drive("transpose nv=1", lambda: op.T @ u1)
    check_oracle("transpose nv=1", z1, oracles["z1"])
    del z1
    zl, _ = drive("transpose nv=1 literal adjoint",
                  lambda: op.executor.transpose(u1, live_scatter=False))
    check_oracle("transpose nv=1 literal adjoint", zl, oracles["z1"])
    del zl
    ell = [d.get("ell_spmm_packed", 0) for d in (fwd1, fwd8, tr)]
    if min(ell) < 1:
        raise AssertionError(f"the standard path did not launch the ELL kernel: {ell}")
    time_programs(op.executor, [
        ("forward nv=1", "forward", v1, {}),
        ("forward nv=8", "forward", v8, {}),
        ("transpose nv=1", "transpose", u1, {}),
        ("transpose nv=1 literal adjoint", "transpose", u1,
         {"live_scatter": False})])
    v_flat = op.executor.packed("forward", v1).reshape(-1)
    send_idx = c.flat_index("send_idx", c.cols_pad)
    print(f"  send gather alone (nv=1, {send_idx.numel()} slots, CUDA events): "
          f"{time_ms(lambda: v_flat.index_select(0, send_idx), reps=10):.4f} ms")
    del v_flat, send_idx
    padded, effective = traffic_bytes(op.stats())
    print(f"  exchange bytes per forward (f32): standard padded {padded} vs "
          f"effective {effective} ({padded / max(effective, 1):.1f}x); nap padded "
          f"{nap_summary['padded']} vs effective {nap_summary['effective']} "
          f"({nap_summary['padded'] / max(nap_summary['effective'], 1):.1f}x)")
    cost = op.cost(BLUE_WATERS)
    print(f"  Blue Waters model (paper Tables 3-4; a model of that Cray machine, "
          f"not a time on this card): standard total {cost['total']:.6e} s "
          f"(inter {cost['inter']:.6e}, intra {cost['intra']:.6e}); nap total "
          f"{nap_summary['cost']['total']:.6e} s")
    del op, c
    free()

    op_b = operator(a_b, topo, method="standard", local_compute="bsr")
    t0 = time.perf_counter()
    op_b.executor.compiled.ensure_fused()
    print(f"  standard bsr n={int(np.sqrt(a_b.shape[0]))}: compile + ensure_fused "
          f"{time.perf_counter() - t0:.2f} s, fused_blocks "
          f"{op_b.executor.compiled.arrays['fused_blocks'].nbytes / 1e9:.3f} GB")
    vb = oracles["vb"][:, None]
    wp, cnt_p = drive("standard bsr packed x", lambda: op_b @ vb)
    wc, cnt_c = drive("standard bsr materialize_x", lambda: op_b(vb, materialize_x=True))
    if not np.array_equal(wp, wc):
        raise AssertionError("standard packed and materialized BSR forwards differ")
    if cnt_p.get("fused_bsr_spmm_packed", 0) < 1 or cnt_c.get("fused_bsr_spmm", 0) < 1:
        raise AssertionError("the standard BSR path did not launch its kernels")
    check_oracle("standard bsr packed x", wp[:, 0], oracles["wb"])
    shards = op_b.executor.packed("forward", vb)
    ms_p = time_ms(lambda: op_b.executor.program("forward")(shards), reps=10)
    ms_c = time_ms(lambda: op_b.executor.program("forward", materialize_x=True)(shards),
                   reps=10)
    print(f"  standard bsr packed and materialized bit-equal; device program ms "
          f"packed {ms_p:.4f}, materialized {ms_c:.4f}")
    return fwd1, fwd8, tr

# the multi-step exchange and the AMG solver path (phases 7 and 9) ----------------

def ell_held(label, c, direction, gen):
    """The ELL kernel against its plain version on one compiled plan's own
    arrays and segment lengths (forward over the packed x, transpose over
    u_loc), nv = 1: the shapes its path gives the kernel."""
    p = c.topo.n_procs
    if direction == "forward":
        c.ensure_ell()
        t = c.tensors(["ell_cols", "ell_vals"])
        cols, vals = t["ell_cols"], t["ell_vals"]
        lens = ((c.cols_pad, c.pads["bnode"], c.pads["boff"]) if hasattr(c, "pads")
                else (c.cols_pad, c.buf_pad))
    else:
        c.ensure_ell_t()
        t = c.tensors(["ell_t_cols", "ell_t_vals"])
        cols, vals, lens = t["ell_t_cols"], t["ell_t_vals"], (c.rows_pad,)
    xs = tuple(torch.randn((p, n, 1), generator=gen, device=DEV) for n in lens)
    scale = float(ell_spmm_packed_ref(cols, vals.abs(), tuple(x.abs() for x in xs)).max())
    check_close(f"{label} ell_spmm_packed {direction} {tuple(cols.shape)}",
                ell_spmm_packed(cols, vals, xs), ell_spmm_packed_ref(cols, vals, xs),
                cols.shape[-1], scale)


def print_verdict(label, verdict, seconds):
    for d in ("forward", "transpose"):
        v = verdict[d]
        print(f"  {label} {d}: {v['chosen']} (injected inter-node bytes "
              + ", ".join(f"{k} {c['injected_inter_bytes']}"
                          for k, c in v["candidates"].items())
              + "; postal s " + ", ".join(f"{k} {c['postal_time_s']:.6e}"
                                          for k, c in v["candidates"].items())
              + f"; {v['postal_params']}); {seconds:.2f} s")


def phase_multistep(a, topo, part, oracles, nap_ref, gen, full_size):
    """[7] the multi-step exchange on the main path's matrix.  ``nap_ref``
    holds phase 4's NAP results (forward nv=1, deterministic transpose)
    and the NAP operator's ``local_compute``."""
    print(f"[7] multistep: n={int(np.sqrt(a.shape[0]))}, Topology(32, 16)")
    t0 = time.perf_counter()
    verdict = choose_comm(a.indptr, a.indices, part, topo)
    print_verdict("choose_comm", verdict, time.perf_counter() - t0)
    del verdict
    op = operator(a, topo, part, method="multistep", device=DEV)
    t0 = time.perf_counter()
    c = op.executor.compiled
    t_compile = time.perf_counter() - t0
    formats = (op.local_compute, op.T.local_compute)
    if formats != ("ell", "ell"):
        if full_size:
            raise AssertionError(f"multistep plan did not resolve to ell: {formats}")
        print(f"  verdict {formats} at this reduced size; the phase runs ell")
        op = operator(a, topo, part, method="multistep", local_compute="ell", device=DEV)
        c = op.executor.compiled
    t0 = time.perf_counter()
    c.ensure_ell()
    c.ensure_ell_t()
    c.ensure_live_direct()
    t_ell = time.perf_counter() - t0
    st = op.stats()
    p, dpad = topo.n_procs, c.pads["direct"]
    n_live = c.arrays["direct_live_src"].size
    print(f"[plan] compile_multistep {t_compile:.2f} s, ensure_ell + ensure_ell_t + "
          f"live direct slots {t_ell:.2f} s; threshold {c.ms_plan.threshold}; pads "
          f"{c.pads}; ell_kmax {c.ell_kmax}, ell_t_kmax {c.ell_t_kmax}")
    print(f"  direct exchange per forward (f32, nv=1): padded {st['direct_padded']} B "
          f"([{p}, {p}, {dpad}] slots) vs live {st['direct_effective']} B ({n_live} "
          f"values in {st['messages_direct'].total_msgs} messages, "
          f"{st['direct_padded'] / max(st['direct_effective'], 1):.0f}x); inter "
          f"padded {st['inter_padded']} vs effective {st['inter_effective']}; host "
          f"direct_send {c.arrays['direct_send'].nbytes / 1e9:.2f} GB (never staged)")
    v1, v8, u1 = oracles["v1"], oracles["v8"], oracles["u1"]
    (w1, w8), fwd = drive("forward nv=1 and nv=8", lambda: (op @ v1, op @ v8))
    (z1,), tr = drive("transpose nv=1", lambda: (op.T @ u1,))
    check_oracle("forward nv=1", w1, oracles["w1"])
    check_oracle("forward nv=8", w8, oracles["w8"])
    check_oracle("transpose nv=1", z1, oracles["z1"])
    if fwd.get("ell_spmm_packed", 0) < 2 or tr.get("ell_spmm_packed", 0) < 1:
        raise AssertionError(f"the multistep path did not launch the ELL kernel: {fwd}, {tr}")
    del w8, z1
    ell_held("multistep", c, "forward", gen)
    ell_held("multistep", c, "transpose", gen)
    # the literal padded exchange, run once and timed beside the live one
    ex = op.executor
    shards = ex.packed("forward", v1)
    w_lit, lit = drive("forward nv=1, literal padded direct exchange",
                       lambda: ex.program("forward", live_direct=False)(shards))
    if not torch.equal(w_lit, ex.program("forward")(shards)):
        raise AssertionError("live and literal direct exchanges differ")
    print("  live-slot and literal direct exchanges bit-equal (forward nv=1)")
    del w_lit, shards
    time_programs(ex, [("forward nv=1", "forward", v1, {}),
                       ("forward nv=8", "forward", v8, {}),
                       ("transpose nv=1", "transpose", u1, {}),
                       ("forward nv=1 literal direct", "forward", v1,
                        {"live_direct": False})])
    print(f"  Blue Waters model (not a card time): multistep total "
          f"{op.cost(BLUE_WATERS)['total']:.6e} s")
    del op, ex, c
    free()
    # threshold=1 sends nothing direct: the NAP plan, bit for bit on the card
    # (the transposes' index_add_ in its deterministic form)
    op1 = operator(a, topo, part, method="multistep", threshold=1,
                   local_compute=nap_ref["local_compute"], device=DEV)
    if op1.executor.compiled.pads["direct"] != 1 or op1.stats()["direct_effective"]:
        raise AssertionError("threshold=1 left a direct share")
    w_ms = op1 @ v1
    torch.use_deterministic_algorithms(True)
    try:
        z_ms = op1.T @ u1
    finally:
        torch.use_deterministic_algorithms(False)
    if not (np.array_equal(w_ms, nap_ref["w1"]) and np.array_equal(z_ms, nap_ref["z1"])):
        raise AssertionError("multistep with threshold=1 differs from nap")
    print("  threshold=1: forward and transpose bit-equal to nap on the card")
    del op1
    free()
    return fwd, tr


# wire integrity on the main path (phase 8) ------------------------------------

class deterministic:
    """PyTorch's deterministic algorithms for the block (``index_add_`` of
    the transposes then sums in a fixed order), when ``on``."""

    def __init__(self, on=True):
        self.on = on

    def __enter__(self):
        if self.on:
            torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        if self.on:
            torch.use_deterministic_algorithms(False)


def record_messages(ex, direction, v):
    """One clean instrumented run of ``ex``'s program with every message
    buffer recorded just before its fault boundary: ``{phase: [P, slots,
    words]}`` (int32 words of each message, row-major), ``"compute"`` the
    local result or packed contributions the compute fault would hit."""
    rec = {}
    orig_fault, orig_pair = spmv_torch._Wire.fault, spmv_torch._fault_pair

    def fault(self, phase, buf):
        rec[phase] = buf.reshape(buf.shape[0], buf.shape[1], -1).clone()
        return orig_fault(self, phase, buf)

    def fault_pair(send, spec):
        nv, p, _, pad = send.shape
        rec["pair"] = send.permute(1, 2, 3, 0).reshape(p, p, pad * nv).clone()
        return orig_pair(send, spec)

    spmv_torch._Wire.fault, spmv_torch._fault_pair = fault, fault_pair
    try:
        ex.program(direction, fault_spec=zero_spec(ex))(ex.packed(direction, v))
    finally:
        spmv_torch._Wire.fault, spmv_torch._fault_pair = orig_fault, orig_pair
    torch.cuda.synchronize()
    return rec


def zero_spec(ex):
    n = len(message_phases(ex.method)) + 1
    return torch.zeros((ex.topo.n_nodes, ex.topo.ppn, n, 4), dtype=torch.int32,
                       device=DEV)


def pick_edges(buf):
    """Per fault kind, one real edge ``(sender, slot, element)`` of a
    message phase whose payload is neither all zero nor constant (the
    median such edge), the fault then changing its bits: ``duplicate``
    also needs the next slot's payload to differ.  None where no edge
    qualifies (the documented undetectable classes)."""
    w = buf.view(torch.int32) if buf.dtype != torch.int32 else buf
    good = (w != 0).any(-1) & (w != w[..., :1]).any(-1)
    dup = good & (w != torch.roll(w, -1, 1)).any(-1)

    def median(mask):
        idx = torch.nonzero(mask.reshape(-1)).reshape(-1)
        if idx.numel() == 0:
            return None
        flat = int(idx[idx.numel() // 2])
        s, k = divmod(flat, w.shape[1])
        return s, k, int(torch.nonzero(w[s, k])[0])

    edge = median(good)
    return {kind: (median(dup) if kind == "duplicate" else edge) for kind in FAULT_KINDS}


def expected_mismatch(phase, s, k, ppn):
    """(node, proc, slot) where the receiver reports a fault that sender
    rank ``s`` put on its message slot ``k``."""
    node, proc = divmod(s, ppn)
    if phase == "inter":
        return k, proc, node
    if phase in ("pair", "direct"):
        return k // ppn, k % ppn, s
    return node, k, proc


def expect_detected(view, v, label, fault, want):
    """Inject ``fault``; the next apply of ``view`` to ``v`` must raise
    with exactly the mismatch ``want``."""
    view.queue_fault(fault)
    try:
        view @ v
    except IntegrityError as e:
        got = [(m.check, m.phase, m.scope, m.node, m.proc, m.slot, m.direction)
               for m in e.mismatches]
        if got != [want]:
            raise AssertionError(f"{label}: mismatches {got}, expected [{want}]")
        return
    raise AssertionError(f"{label}: {fault} not detected")


def fault_sweep(op, method, direction, v, ppn):
    """Every fault kind on a real edge of every message phase, then a
    compute bitflip on a high exponent bit, each detected with the
    reference's attribution; returns the number of faults detected."""
    view = op.T if direction == "transpose" else op
    rec = record_messages(op.executor, direction, v)
    n = 0
    for phase in message_phases(method):
        edges = pick_edges(rec[phase])
        for kind in FAULT_KINDS:
            edge = edges[kind]
            if edge is None and kind == "bitflip":
                edge = (0, 0, 0)    # no live edge: a flip in padding is still seen
            if edge is None:
                print(f"    {method} {direction} {phase}: no edge carries a payload "
                      f"{kind} changes (documented undetectable class), skipped")
                continue
            s, k, elem = edge
            node, proc, slot = expected_mismatch(phase, s, k, ppn)
            fault = MessageFault(phase=phase, kind=kind, node=s // ppn, proc=s % ppn,
                                 slot=k, element=elem, bit=20, direction=direction)
            expect_detected(view, v, f"{method} {direction} {phase} {kind}", fault,
                            ("wire", phase, scope_for(phase, node, proc, slot, ppn),
                             node, proc, slot, direction))
            n += 1
        print(f"    {method} {direction} {phase}: edge {edges['bitflip']}, "
              f"{sum(e is not None for e in edges.values())} kinds on live edges")
    # ABFT: bit 30 of a value in [0.1, 1) makes it ~2^128 times larger and
    # still finite, far above the tolerance (a flip to inf would not be)
    r = op.topo.n_procs - 1
    vals = rec["compute"][r, 0]
    idx = torch.nonzero((vals.abs() >= 0.1) & (vals.abs() < 1.0)).reshape(-1)
    elem = int(idx[idx.numel() // 2])
    fault = MessageFault(phase="compute", kind="bitflip", node=r // ppn, proc=r % ppn,
                         element=elem, bit=30, direction=direction)
    expect_detected(view, v, f"{method} {direction} compute", fault,
                    ("abft", "compute", "on_proc", r // ppn, r % ppn, 0, direction))
    del rec
    free()
    return n + 1


def bare_apply(ex, direction, v):
    """The uninstrumented program on the same compiled plan, unpacked: the
    ``integrity="off"`` result."""
    w = ex.program(direction)(ex.packed(direction, v))
    part = ex.row_part if direction == "forward" else ex.col_part
    return spmv_torch.unpack_vector(w.cpu().numpy(), part, ex.topo)


def phase_integrity(a, topo, part, oracles, a_b):
    """[8] wire integrity on the main path: nap, standard and multistep."""
    n = int(np.sqrt(a.shape[0]))
    print(f"[8] integrity: n={n}, Topology(32, 16), nap / multistep / standard, "
          f"integrity='detect'")
    ppn = topo.ppn
    v1, v8, u1 = oracles["v1"], oracles["v8"], oracles["u1"]
    ell = {"forward": 0, "transpose": 0}
    nap_op = None
    for method in ("multistep", "standard", "nap"):   # nap last: it stays alive
        t0 = time.perf_counter()
        op = operator(a, topo, part, method=method, local_compute="ell",
                      integrity="detect", device=DEV)
        ex = op.executor
        c = ex.compiled
        c.ensure_ell()
        c.ensure_ell_t()
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        c.ensure_abft()
        st = op.stats()
        print(f"  {method}: compile + formats {t_compile:.2f} s, ensure_abft "
              f"{time.perf_counter() - t0:.2f} s; checksum words per apply "
              f"{st['checksum_total'] // 4} ({st['checksum_total']} B)")
        # 1. clean detect applies, bit-equal to the bare program, no mismatch
        nvs = (1, 8)
        for direction in ("forward", "transpose"):
            view = op.T if direction == "transpose" else op
            for nv in nvs:
                v = (v1 if direction == "forward" else u1) if nv == 1 else v8
                with deterministic(direction == "transpose"):
                    got, cnt = drive(f"{method} detect {direction} nv={nv}",
                                     lambda: view @ v)
                    want = bare_apply(ex, direction, v)
                if not np.array_equal(got, want):
                    raise AssertionError(f"{method} {direction} nv={nv}: detect != off")
                ell[direction] += cnt.get("ell_spmm_packed", 0)
                if nv == 1:
                    check_oracle(f"{method} detect {direction} nv=1", got,
                                 oracles["w1" if direction == "forward" else "z1"])
                del got, want
        rep = op.integrity_report()
        if rep["wire_mismatches"] or rep["abft_mismatches"] or not rep["wire_checks"]:
            raise AssertionError(f"{method}: clean applies reported {rep}")
        print(f"  {method}: {rep['applies']} clean detect applies bit-equal to off, "
              f"{rep['wire_checks']} wire checks, {rep['abft_checks']} ABFT checks, "
              f"0 mismatches")
        # 2. scripted faults on real edges, both directions
        n_faults = 0
        for direction in ("forward", "transpose"):
            with deterministic(direction == "transpose"):
                n_faults += fault_sweep(op, method, direction,
                                        v1 if direction == "forward" else u1, ppn)
        rep = op.integrity_report()
        print(f"  {method}: {n_faults} scripted faults detected with the expected "
              f"attribution; strikes {rep['strikes']}")
        # 3. device-program times and peaks, bare and instrumented
        spec = zero_spec(ex)
        for direction in ("forward", "transpose"):
            for nv in nvs:
                v = (v1 if direction == "forward" else u1) if nv == 1 else v8
                shards = ex.packed(direction, v)
                row = dict(method=method, direction=direction, nv=nv)
                for label, prog in (("bare", ex.program(direction)),
                                    ("instrumented",
                                     ex.program(direction, fault_spec=spec))):
                    free()
                    torch.cuda.reset_peak_memory_stats()
                    out = prog(shards)
                    torch.cuda.synchronize()
                    row[f"{label}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                    del out
                    row[f"{label}_ms"] = time_ms(lambda: prog(shards), reps=10)
                print(f"  {method} {direction} nv={nv}: bare {row['bare_ms']:.4f} ms "
                      f"(peak {row['bare_peak_gb']:.3f} GB), instrumented "
                      f"{row['instrumented_ms']:.4f} ms (peak "
                      f"{row['instrumented_peak_gb']:.3f} GB), ratio "
                      f"{row['instrumented_ms'] / row['bare_ms']:.2f}")
                if nv == 1:
                    profile_program(f"{method} {direction} nv=1 instrumented",
                                    lambda: prog(shards), row["instrumented_ms"])
                del shards
        if method == "nap":
            nap_op = op
        else:
            del op
        del ex, c
        free()
    # 4. recover: one fault, the clean result bit for bit after one retry
    rec_op = operator(a, topo, part, local_compute="ell", integrity="recover",
                      device=DEV)
    y_off = bare_apply(nap_op.executor, "forward", v1)
    s, k, elem = pick_edges(record_messages(rec_op.executor, "forward", v1)["inter"])["bitflip"]
    rec_op.inject_fault("inter", "bitflip", node=s // ppn, proc=s % ppn, slot=k,
                        element=elem, bit=20)
    if not np.array_equal(rec_op @ v1, y_off):
        raise AssertionError("recover forward is not the clean result")
    rep = rec_op.integrity_report()
    if not rep["retries"] == rep["recovered"] == 1:
        raise AssertionError(f"recover forward: {rep}")
    with deterministic():
        z_off = bare_apply(nap_op.executor, "transpose", u1)
        s, k, elem = pick_edges(record_messages(rec_op.executor, "transpose",
                                                u1)["final"])["zero"]
        rec_op.T.inject_fault("final", "zero", node=s // ppn, proc=s % ppn, slot=k,
                              element=elem)
        if not np.array_equal(rec_op.T @ u1, z_off):
            raise AssertionError("recover transpose is not the clean result")
    rep = rec_op.integrity_report()
    if not rep["retries"] == rep["recovered"] == 2:
        raise AssertionError(f"recover transpose: {rep}")
    print(f"  recover: forward and transpose faults retried once each, results "
          f"bit-equal to off (retries {rep['retries']}, recovered "
          f"{rep['recovered']}, strikes {rep['strikes']})")
    del rec_op, y_off, z_off
    free()
    # 5. the fused-BSR forward at the BSR path's size, one detect apply
    op_b = operator(a_b, topo, local_compute="bsr", integrity="detect", device=DEV)
    vb = oracles["vb"][:, None]
    wb, cnt_b = drive("bsr detect forward", lambda: op_b @ vb)
    if not np.array_equal(wb, bare_apply(op_b.executor, "forward", vb)):
        raise AssertionError("bsr detect != off")
    check_oracle("bsr detect forward", wb[:, 0], oracles["wb"])
    if cnt_b.get("fused_bsr_spmm_packed", 0) < 1:
        raise AssertionError("the BSR detect apply did not launch its kernel")
    print(f"  bsr n={int(np.sqrt(a_b.shape[0]))}: detect apply bit-equal to off, "
          f"{op_b.integrity_report()['wire_checks']} wire checks, 0 mismatches")
    del op_b, wb
    free()
    return ell, cnt_b, nap_op


def phase_simulate(a, topo, part, oracles, a_b, nap_op, nap_w1, nap_z1):
    """[8, simulate] the float64 simulate backend: every method at the BSR
    path's grid against the device programs and the float64 host product;
    the node-aware method at the main path's size against phase 4's device
    results, and one scripted wire fault on both backends."""
    nb = int(np.sqrt(a_b.shape[0]))
    print(f"  simulate: n={nb} all methods, then n={int(np.sqrt(a.shape[0]))} "
          f"node-aware (host float64)")
    rng = np.random.default_rng(16)
    vb = oracles["vb"]
    ub = rng.standard_normal(a_b.shape[0])
    wb, zb = host_apply(a_b, vb), host_apply(a_b, ub, transpose=True)
    for method in ("nap", "standard", "multistep"):
        t0 = time.perf_counter()
        sim = operator(a_b, topo, method=method, backend="simulate")
        w, z = sim @ vb, sim.T @ ub
        t_sim = time.perf_counter() - t0
        dev = operator(a_b, topo, method=method, local_compute="ell", device=DEV)
        check_oracle(f"device {method} n={nb} forward", dev @ vb, w, "float64 simulate")
        check_oracle(f"device {method} n={nb} transpose", dev.T @ ub, z,
                     "float64 simulate")
        for label, got, want in (("forward", w, wb), ("transpose", z, zb)):
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            if not rel <= 1e-12:
                raise AssertionError(f"simulate {method} {label}: {rel:.3e} off float64")
        print(f"  simulate {method} n={nb}: forward + transpose {t_sim:.2f} s host, "
              f"float64 within 1e-12 of the host product")
        del sim, dev
    t0 = time.perf_counter()
    sim = operator(a, topo, part, backend="simulate", integrity="detect")
    w, z = sim @ oracles["v1"], sim.T @ oracles["u1"]
    t_sim = time.perf_counter() - t0
    for label, got, want, dev in (("forward", w, oracles["w1"], nap_w1),
                                  ("transpose", z, oracles["z1"], nap_z1)):
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        if not rel <= 1e-12:
            raise AssertionError(f"simulate nap {label}: {rel:.3e} off float64")
        check_oracle(f"device nap {label} (phase 4)", dev, got, "float64 simulate")
    print(f"  simulate nap n={int(np.sqrt(a.shape[0]))}: forward + transpose "
          f"{t_sim:.2f} s host, within 1e-12 of the host product")
    # one scripted fault on both backends: the device's inter edge
    rec = record_messages(nap_op.executor, "forward", oracles["v1"])
    s, k, elem = pick_edges(rec["inter"])["bitflip"]
    del rec
    fault = dict(phase="inter", kind="bitflip", node=s // topo.ppn,
                 proc=s % topo.ppn, slot=k, element=elem, bit=20)
    got = []
    for view in (nap_op, sim):
        view.inject_fault(**fault)
        try:
            view @ oracles["v1"]
            raise AssertionError(f"{view.spec.backend}: fault not detected")
        except IntegrityError as e:
            got.append([(m.check, m.phase, m.scope, m.node, m.proc, m.slot)
                        for m in e.mismatches])
    if got[0] != got[1]:
        raise AssertionError(f"simulate and device attribute differently: {got}")
    print(f"  simulate wire: fault {fault} attributed as on the device: {got[0]}")


class HostOp:
    """A float64 scipy CSR matrix with the operators' call and ``@``: the
    host-matvec twin of a level's distributed operators."""

    def __init__(self, m):
        self.m = m

    def __call__(self, x):
        return self.m @ x

    __matmul__ = __call__


def scipy_of(m):
    return sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)


def check_level(label, got, want):
    """``check_oracle``'s tolerance on a coarse level, whose entries grow
    with the Galerkin products: rtol 1e-4 and atol 1e-5 of max |ref|."""
    scale = float(np.abs(want).max())
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: bad result {got.shape}")
    np.testing.assert_allclose(got / scale, want / scale, **TOL)
    return float(np.abs(got - want).max()) / scale


def phase_amg(a, topo, gen, seed, full_size):
    """[9] the AMG solver path on the main path's matrix."""
    import repro_torch.api as api_mod
    rng = np.random.default_rng(seed + 8)
    print(f"[9] AMG: n={int(np.sqrt(a.shape[0]))}, smoothed aggregation theta 0.1, "
          f"coarse_size {2 * topo.n_procs}, Topology(32, 16), comm='auto'")
    t0 = time.perf_counter()
    levels = smoothed_aggregation_hierarchy(a, theta=0.1, coarse_size=2 * topo.n_procs)
    t_h = time.perf_counter() - t0
    print(f"  hierarchy {t_h:.2f} s (host, float64): {len(levels)} levels, rows "
          f"{[lv.a.shape[0] for lv in levels]}, nnz {[lv.a.nnz for lv in levels]}, "
          f"P nnz {[lv.p.nnz for lv in levels if lv.p is not None]}")
    chooser = []
    choose = api_mod.choose_comm

    def timed_choose(*args, **kw):
        t = time.perf_counter()
        out = choose(*args, **kw)
        chooser.append(time.perf_counter() - t)
        return out

    products = []
    compile_fn = spgemm_torch.compile_spgemm

    def recorded_compile(a_, b_, *args, **kw):
        t = time.perf_counter()
        out = compile_fn(a_, b_, *args, **kw)
        # host arrays only: the product's device tensors go with ``out``
        products.append(dict(a=a_, b=b_, compiled=out.unstaged(),
                             seconds=time.perf_counter() - t))
        return out

    api_mod.choose_comm = timed_choose
    spgemm_torch.compile_spgemm = recorded_compile
    runs0 = torch_spgemm_runs()
    t0 = time.perf_counter()
    try:
        ops = level_operators(levels, topo, comm="auto", materialize=True,
                              spgemm_backend="torch", device=DEV)
    finally:
        api_mod.choose_comm = choose
        spgemm_torch.compile_spgemm = compile_fn
    t_ops = time.perf_counter() - t0
    n_products = 2 * (len(levels) - 1)
    if torch_spgemm_runs() - runs0 != n_products or len(products) != n_products:
        raise AssertionError(f"materialize=True ran {torch_spgemm_runs() - runs0} "
                             f"device SpGEMMs, expected {n_products}")
    print(f"  level_operators(materialize=True, spgemm_backend='torch') {t_ops:.2f} s "
          f"(chooser {sum(chooser):.2f} s, SpGEMM compile "
          f"{sum(r['seconds'] for r in products):.2f} s); {n_products} device SpGEMM "
          f"runs, every coarse A held against the host assembly at rtol 5e-5 x depth")
    for i in range(1, len(levels)):
        if ops[i].a is not None:
            got, want = ops[i].a.a, levels[i].a
            print(f"  level {i} A from the device products: max abs err / max |host| "
                  f"{np.abs(got.data - want.data).max() / np.abs(want.data).max():.3e} "
                  f"(limit: rtol {5e-5 * i:.1e}, atol 0.1 rtol max(1, max |host|))")
    spgemm_report(products, topo)
    n_dist = sum(e.a is not None for e in ops)
    k = 0
    for i, (lv, e) in enumerate(zip(levels, ops)):
        if e.a is None:
            print(f"  level {i}: {lv.a.shape[0]} rows, {lv.a.nnz} nnz: host (fewer "
                  f"rows than ranks)")
            continue
        for name in ("a", "p"):
            op = getattr(e, name)
            if op is None:
                continue
            t0 = time.perf_counter()
            execs = [op.executor] + ([op.transpose_executor]
                                     if op.transpose_executor is not None else [])
            for ex in execs:
                c = ex.compiled
                if getattr(c, "comm", "nap") == "multistep":
                    c.ensure_live_direct()
            if op.local_compute == "ell":
                op.executor.compiled.ensure_ell()
            if op.T.local_compute == "ell":
                (op.transpose_executor or op.executor).compiled.ensure_ell_t()
            rep = op.autotune_report()["comm"]
            mat = lv.a if name == "a" else lv.p
            print(f"  level {i} {name.upper()} {mat.shape} nnz {mat.nnz}: comm forward "
                  f"{rep['resolved']}, transpose {rep['transpose_resolved']}; local "
                  f"{op.local_compute} / {op.T.local_compute}; chooser "
                  f"{chooser[k]:.2f} s, compile {time.perf_counter() - t0:.2f} s")
            k += 1
    def held_and_timed(label, op, x, y, profile):
        """The ELL kernel against its plain version where a direction of
        ``op`` resolved to it, then both directions' programs timed."""
        execs = {"forward": op.executor,
                 "transpose": op.transpose_executor or op.executor}
        for direction, view in (("forward", op), ("transpose", op.T)):
            if view.local_compute == "ell":
                ell_held(label, execs[direction].compiled, direction, gen)
        time_programs(execs, [(f"{label} forward", "forward", x, {}),
                              (f"{label}.T", "transpose", y, {})], profile=profile)

    errs = []
    for i, (lv, e) in enumerate(zip(levels, ops)):
        if e.a is None:
            continue
        # the float64 oracle of each SpMV is the matrix its operator holds:
        # on the coarse levels the device SpGEMM product, held against the
        # host assembly by level_operators
        sa = scipy_of(e.a.a)
        v, u = rng.standard_normal(sa.shape[1]), rng.standard_normal(sa.shape[0])
        errs.append(check_level(f"level {i} A @ v", e.a @ v, sa @ v))
        errs.append(check_level(f"level {i} A.T @ u", e.a.T @ u, sa.T @ u))
        held_and_timed(f"level {i} A", e.a, v, u, i == 0)
        if e.p is None:
            continue
        sp_, sr = scipy_of(lv.p), scipy_of(lv.r)
        x, r = rng.standard_normal(sp_.shape[1]), rng.standard_normal(sp_.shape[0])
        errs.append(check_level(f"level {i} P @ x", e.p @ x, sp_ @ x))
        errs.append(check_level(f"level {i} R @ r", e.r @ r, sr @ r))
        errs.append(check_level(f"level {i} (R @ A @ P) @ x", e.galerkin() @ x,
                                sr @ (sa @ (sp_ @ x))))
        held_and_timed(f"level {i} P", e.p, x, r, i == 0)
    print(f"  every distributed level ({n_dist}) matches the float64 host products of "
          f"its operators' matrices: max abs err / max |ref| {max(errs):.3e}")
    gal_counts = spgemm_level0(levels, ops, products, topo, rng)
    del products
    free()

    # AMG-preconditioned CG, 10 iterations, on the card and with host matvecs
    a0 = scipy_of(levels[0].a)
    host_ops = [LevelOperators(a=HostOp(scipy_of(lv.a)),
                               p=None if lv.p is None else HostOp(scipy_of(lv.p)),
                               r=None if lv.r is None else HostOp(scipy_of(lv.r)))
                for lv in levels]
    b = rng.standard_normal(a0.shape[0])
    b_norm = float(np.linalg.norm(b))

    def pcg(level_ops):
        hist = []
        cg_solve(levels[0].a, b, tol=0.0, maxiter=10, spmv=level_ops[0].a,
                 precond=lambda r: amg_vcycle(levels, r, operators=level_ops),
                 callback=lambda it, x: hist.append(
                     float(np.linalg.norm(b - a0 @ x)) / b_norm))
        return hist

    t0 = time.perf_counter()
    res_dev, counts = drive("PCG, 10 iterations, device operators", lambda: pcg(ops))
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_host = pcg(host_ops)
    t_host = time.perf_counter() - t0
    print("  PCG true relative residual ||b - A x|| / ||b|| (float64 host A), device "
          "operators vs host float64 matvecs:")
    for it, (rd, rh) in enumerate(zip(res_dev, res_host), 1):
        print(f"    iteration {it}: {rd:.6e}  {rh:.6e}  (ratio {rd / rh:.6f})")
    # Both runs take the same steps.  CG's step length divides by p . A p,
    # which for the smooth p the V-cycle returns is a small fraction of
    # |p| |A p| (0.6% at n = 2024), so the f32 rounding of the device's
    # A p (~4e-5 of |A p|) moves it by ~0.5% and the residuals by up to
    # ~2% (the z . A z comparison below).  The limit is 5%, 2.5x that.
    if len(res_dev) != 10 or not all(
            abs(rd / rh - 1.0) <= 0.05 or max(rd, rh) <= 1e-5
            for rd, rh in zip(res_dev, res_host)):
        raise AssertionError("device PCG does not track the host-matvec PCG")
    if full_size and not res_dev[-1] < 0.5 * res_dev[0]:
        raise AssertionError("device PCG did not reduce the residual")
    r0 = b - a0 @ np.zeros_like(b)
    t0 = time.perf_counter()
    z_dev, vc = drive("one V-cycle, device operators",
                      lambda: amg_vcycle(levels, r0, operators=ops))
    t_vc = time.perf_counter() - t0
    profile_program("one V-cycle, device operators",
                    lambda: amg_vcycle(levels, r0, operators=ops), t_vc * 1e3)
    t0 = time.perf_counter()
    z_host = amg_vcycle(levels, r0, operators=host_ops)
    t_vc_host = time.perf_counter() - t0
    az, az_dev = a0 @ z_host, ops[0].a @ z_host
    print(f"  V-cycle wall {t_vc:.3f} s with device operators ({vc.get('ell_spmm_packed', 0)}"
          f" ELL launches), {t_vc_host:.3f} s with host float64 matvecs; PCG "
          f"{t_dev:.2f} s device, {t_host:.2f} s host; one V-cycle's output, device "
          f"vs host: ||dz|| / ||z|| {np.linalg.norm(z_dev - z_host) / np.linalg.norm(z_host):.3e}"
          f", ||A dz|| / ||A z|| {np.linalg.norm(a0 @ (z_dev - z_host)) / np.linalg.norm(a0 @ z_host):.3e}"
          f"; device A z vs float64 A z on that z: ||d(Az)|| / ||A z|| "
          f"{np.linalg.norm(az_dev - az) / np.linalg.norm(az):.3e}, z . A z / (||z|| "
          f"||A z||) {z_host @ az / (np.linalg.norm(z_host) * np.linalg.norm(az)):.3e}, "
          f"z . d(Az) / z . A z {z_host @ (az_dev - az) / (z_host @ az):.3e}")
    if counts.get("ell_spmm_packed", 0) < 1:
        raise AssertionError("the AMG path did not launch the ELL kernel")
    del ops, host_ops, levels
    clear_spgemm_cache()
    free()
    return {k: counts.get(k, 0) + gal_counts.get(k, 0) for k in {**counts, **gal_counts}}


def spgemm_phase_values(c):
    """Per exchange phase of a compiled SpGEMM: (padded, live) values."""
    topo, plan = c.topo, c.plan
    if c.method == "standard":
        lists = {"pair": (plan.comm.sends, topo.n_procs)}
    else:
        lists = {"full": (plan.comm.local_full_sends, topo.ppn),
                 "init": (plan.comm.local_init_sends, topo.ppn),
                 "inter": (plan.comm.inter_sends, topo.n_nodes),
                 "final": (plan.comm.local_final_sends, topo.ppn)}
    return {ph: (topo.n_procs * slots * c.vpads[ph],
                 sum(message_value_size(m, plan.b_counts) for ms in msgs for m in ms))
            for ph, (msgs, slots) in lists.items()}


def spgemm_bound(a, c, itemsize):
    """The least time of one product: every live expanded product reads its
    position, output slot and A value (int32, int32, payload) and one
    value of the domain once, every live C value is written once, and
    every live exchanged value is read and written once, at 3.35 TB/s."""
    n_exp = int(c.plan.b_counts[a.indices].sum())
    live = sum(v for _, v in spgemm_phase_values(c).values())
    nbytes = n_exp * (8 + 2 * itemsize) + sum(c.c_nnz) * itemsize + 2 * live * itemsize
    return bound_ms(nbytes, n_exp * 2)[0], n_exp


def time_spgemm(c, b, dtype=torch.float32):
    """Device-program ms (median of 10, B staged on the card) and the peak
    of allocated memory over one run, in GB, and the run's output.  The
    product's arrays are staged on a copy of ``c``, freed on return."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    c = c.unstaged()
    b_dev = torch.from_numpy(pack_b_values(b, c, np_dtype)).to(DEV)
    run = spgemm_program(c, dtype=dtype)
    out = run(b_dev)
    torch.cuda.synchronize()
    del out
    torch.cuda.reset_peak_memory_stats()
    out = run(b_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = time_ms(lambda: run(b_dev), reps=10)
    return ms, peak, out


def spgemm_report(products, topo):
    """Per device SpGEMM product of ``level_operators``: host compile s,
    pads, padded vs live value bytes per phase, the paper's inter-node
    value bytes for nap and standard, device-program ms, peak and bound."""
    print("  device SpGEMM products (float32 payloads; bytes at 4 B a value; "
          "ms: CUDA events, median of 10, B already on the card):")
    for j, rec in enumerate(products):
        c, a_, b_ = rec["compiled"], rec["a"], rec["b"]
        label = f"level {j // 2} {'A @ P' if j % 2 == 0 else 'R @ AP'}"
        phases = spgemm_phase_values(c)
        t0 = time.perf_counter()
        std = build_spgemm_plan(a_, b_, c.row_part, c.mid_part, topo,
                                method="standard").stats()["inter"]
        t_std = time.perf_counter() - t0
        nap = c.plan.stats()["inter"]
        ms, peak, _ = time_spgemm(c, b_)
        bound, n_exp = spgemm_bound(a_, c, 4)
        print(f"  {label} {c.shape} nnz(C) {sum(c.c_nnz)}: compile {rec['seconds']:.2f} s; "
              f"exp_pad {c.exp_pad} ({n_exp} live products), c_nnz_pad {c.c_nnz_pad}, "
              f"b_nnz_pad {c.b_nnz_pad}, vpads {c.vpads}; value bytes padded / live "
              + ", ".join(f"{ph} {4 * pv} / {4 * lv}" for ph, (pv, lv) in phases.items())
              + f"; inter-node value bytes (8 B a value, the paper's setup traffic) "
              f"nap {nap.total_bytes} in {nap.total_msgs} messages, standard "
              f"{std.total_bytes} in {std.total_msgs} ({t_std:.2f} s to plan); "
              f"device {ms:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}%), "
              f"peak {peak:.3f} GB")
        free()


def spgemm_level0(levels, ops, products, topo, rng):
    """Level 0's products in float64 against host ``csr_matmul``, its
    materialized Galerkin operator against the lazy chain, and its
    standard-method ``A @ P`` through the live-slot pair exchange."""
    a0, p0 = levels[0].a, levels[0].p
    t0 = time.perf_counter()
    ap_host = csr_matmul(a0, p0)
    print(f"  level 0 host csr_matmul A @ P {time.perf_counter() - t0:.2f} s")
    for rec, b_, want, label in ((products[0], p0, ap_host, "A @ P"),
                                 (products[1], ap_host, levels[1].a, "R @ AP")):
        c = rec["compiled"]
        ms, peak, out = time_spgemm(c, b_, torch.float64)
        got = unpack_c_values(out, c)
        del out
        if not (np.array_equal(got.indptr, want.indptr)
                and np.array_equal(got.indices, want.indices)):
            raise AssertionError(f"level 0 float64 {label}: structure differs")
        scale = float(np.abs(want.data).max())
        np.testing.assert_allclose(got.data, want.data, rtol=1e-12, atol=1e-13 * scale)
        bound, _ = spgemm_bound(rec["a"], c, 8)
        print(f"  level 0 {label} float64 on the card: max abs err / max |ref| "
              f"{np.abs(got.data - want.data).max() / scale:.3e} (rtol 1e-12, atol "
              f"1e-13 x max |ref|); device {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}%), peak {peak:.3f} GB")
        free()

    # materialized against lazy Galerkin operator, one apply each
    t0 = time.perf_counter()
    gal_m = ops[0].galerkin(materialize=True)
    t_mat = time.perf_counter() - t0
    gal_l = ops[0].galerkin()
    x = rng.standard_normal(gal_m.shape[1])
    t0 = time.perf_counter()
    y_m, counts = drive("level 0 materialized R @ A @ P, first apply", lambda: gal_m @ x)
    t_first = time.perf_counter() - t0
    y_l = gal_l @ x
    want = scipy_of(levels[1].a) @ x
    e_ml = check_level("level 0 materialized vs lazy (R @ A @ P) @ x", y_m, y_l)
    e_m = check_level("level 0 materialized (R @ A @ P) @ x", y_m, want)
    ms_m = time_ms(lambda: gal_m @ x, reps=10)
    ms_l = time_ms(lambda: gal_l @ x, reps=10)
    print(f"  level 0 R @ A @ P materialized {gal_m.shape}, nnz {gal_m.a.nnz} "
          f"({gal_m.method}, {gal_m.local_compute}): materialize {t_mat:.2f} s, first "
          f"apply (with its plan compile) {t_first:.2f} s; one apply (pack + program + "
          f"unpack, CUDA events, median of 10) materialized {ms_m:.4f} ms vs lazy "
          f"{ms_l:.4f} ms; results apart by {e_ml:.3e} of max |lazy|, materialized "
          f"vs float64 host {e_m:.3e}")
    time_programs(gal_m.executor, [("level 0 materialized R @ A @ P", "forward", x, {})],
                  profile=False)
    del gal_m, gal_l
    free()

    # the standard method's A @ P: its literal [P, P, vpad] table vs live slots
    fine = products[0]["compiled"].row_part
    t0 = time.perf_counter()
    cs = compile_spgemm(a0, p0, fine, fine, topo, method="standard", device=DEV)
    t_cs = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.ensure_live_pair()
    t_live = time.perf_counter() - t0
    p_, vpad = topo.n_procs, cs.vpads["pair"]
    live = int(cs.arrays["pair_live_src"].size)
    c_std = distributed_spgemm(a0, p0, fine, fine, topo, method="standard", device=DEV)
    assert_matches_host(c_std, ap_host, "torch", "level 0 standard A @ P")
    ms, peak, _ = time_spgemm(cs, p0)
    bound, _ = spgemm_bound(a0, cs, 4)
    print(f"  level 0 standard A @ P: compile {t_cs:.2f} s + live slots {t_live:.2f} s; "
          f"the literal pair table [{p_}, {p_}, {vpad}] is {4 * p_ * p_ * vpad / 1e9:.3f} "
          f"GB of float32 (+ {8 * p_ * p_ * vpad / 1e9:.3f} GB of int64 gather index) "
          f"for {live} live values ({4 * live / 1e9:.4f} GB), so it runs from its live "
          f"slots (recv pad {cs.live_pad}); matches host csr_matmul at rtol 5e-5; "
          f"device {ms:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}%), peak "
          f"{peak:.3f} GB")
    del cs, c_std
    free()
    return counts


def record_spgemm_messages(c, b):
    """One clean instrumented run of compiled SpGEMM ``c`` on ``b`` with
    every message buffer recorded at its fault boundary: ``{phase: [P,
    slots, words]}``."""
    rec = {}
    orig = spmv_torch._Wire.fault

    def fault(self, phase, buf):
        rec[phase] = buf.reshape(buf.shape[0], buf.shape[1], -1).clone()
        return orig(self, phase, buf)

    spmv_torch._Wire.fault = fault
    try:
        n = len(message_phases(c.method)) + 1
        spgemm_program(c, integrity=True)(pack_b_values(b, c, np.float32),
                                          np.zeros((c.topo.n_nodes, c.topo.ppn, n, 4),
                                                   dtype=np.int32))
    finally:
        spmv_torch._Wire.fault = orig
    torch.cuda.synchronize()
    return rec


def same_csr(x, y):
    return (np.array_equal(x.indptr, y.indptr) and np.array_equal(x.indices, y.indices)
            and np.array_equal(x.data, y.data))


def phase_spgemm_small(a_b, topo, seed):
    """[9b] the distributed SpGEMM at the BSR path's grid: simulate bit-equal
    to ``csr_matmul``, the device program in float32 and float64, the
    hierarchy assembled by ``distributed_rap`` on the card, and scripted
    faults on every message phase detected and recovered, the clean
    instrumented run (for the standard method its literal pair exchange)
    bit-equal to the bare one (its live slots)."""
    nb = int(np.sqrt(a_b.shape[0]))
    print(f"[9b] distributed SpGEMM at n={nb}, Topology(32, 16)")
    t0 = time.perf_counter()
    host = smoothed_aggregation_hierarchy(a_b, theta=0.1, coarse_size=2 * topo.n_procs)
    a, p = host[0].a, host[0].p
    fine = contiguous_partition(a.shape[0], topo.n_procs)
    want = csr_matmul(a, p)
    scale = float(np.abs(want.data).max())
    print(f"  hierarchy {time.perf_counter() - t0:.2f} s: rows "
          f"{[lv.a.shape[0] for lv in host]}; level 0 A @ P {a.shape} @ {p.shape}")
    for method in ("nap", "standard"):
        t0 = time.perf_counter()
        sim = distributed_spgemm(a, p, fine, fine, topo, method=method,
                                 backend="simulate")
        if not same_csr(sim, want):
            raise AssertionError(f"simulate {method}: not bit-equal to csr_matmul")
        print(f"  simulate {method}: bit-equal to csr_matmul ({time.perf_counter() - t0:.2f}"
              f" s host)")
        for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)),
                           (torch.float64, dict(rtol=1e-12, atol=1e-13))):
            got = distributed_spgemm(a, p, fine, fine, topo, method=method,
                                     device=DEV, dtype=dtype)
            if not np.array_equal(got.indices, want.indices):
                raise AssertionError(f"device {method} {dtype}: structure differs")
            np.testing.assert_allclose(got.data, want.data, **tol)
            print(f"  device {method} {str(dtype)[6:]}: max abs err "
                  f"{np.abs(got.data - want.data).max():.3e} (max |ref| {scale:.3e}; "
                  f"rtol {tol['rtol']:.0e}, atol {tol['atol']:.0e})")
    # the whole hierarchy assembled by the device SpGEMM (float32)
    runs0 = torch_spgemm_runs()
    t0 = time.perf_counter()
    dev = smoothed_aggregation_hierarchy(
        a_b, theta=0.1, coarse_size=2 * topo.n_procs,
        rap=distributed_rap(topo, backend="torch", device=DEV, cross_check=True))
    runs = torch_spgemm_runs() - runs0
    if len(dev) != len(host) or runs != 2 * (len(host) - 1) or not all(
            np.array_equal(x.a.indptr, y.a.indptr) and np.array_equal(x.a.indices, y.a.indices)
            for x, y in zip(dev, host)):
        raise AssertionError("distributed_rap hierarchy: structure differs from host")
    print(f"  smoothed_aggregation_hierarchy(rap=distributed_rap(backend='torch', "
          f"cross_check=True)) {time.perf_counter() - t0:.2f} s: {runs} device products, "
          f"every level's structure equal to the host hierarchy's; values drift "
          + ", ".join(f"{np.abs(x.a.data - y.a.data).max() / np.abs(y.a.data).max():.2e}"
                      for x, y in zip(dev[1:], host[1:]))
          + " of max |host| (float32 products feed the next level's aggregation)")
    del dev
    free()

    # integrity: every fault kind on a live edge of every message phase
    torch.use_deterministic_algorithms(True)
    try:
        for method in ("nap", "standard"):
            off = distributed_spgemm(a, p, fine, fine, topo, method=method, device=DEV)
            clean = distributed_spgemm(a, p, fine, fine, topo, method=method, device=DEV,
                                       integrity="detect")
            if not same_csr(clean, off):
                raise AssertionError(f"{method}: clean detect run differs from off")
            c = compile_spgemm(a, p, fine, fine, topo, method=method, device=DEV)
            rec = record_spgemm_messages(c, p)
            n = 0
            for phase in message_phases(method):
                edges = pick_edges(rec[phase])
                for kind in FAULT_KINDS:
                    if edges[kind] is None:
                        raise AssertionError(f"{method} {phase}: no live edge for {kind}")
                    s, k, elem = edges[kind]
                    node, proc, slot = expected_mismatch(phase, s, k, topo.ppn)
                    fault = MessageFault(phase=phase, kind=kind, node=s // topo.ppn,
                                         proc=s % topo.ppn, slot=k, element=elem, bit=20)
                    want_m = [("wire", phase, scope_for(phase, node, proc, slot, topo.ppn),
                               node, proc, slot, "forward")]
                    try:
                        distributed_spgemm(a, p, fine, fine, topo, method=method,
                                           device=DEV, integrity="detect", faults=[fault])
                        raise AssertionError(f"{method} {phase} {kind}: not detected")
                    except IntegrityError as e:
                        got = [(m.check, m.phase, m.scope, m.node, m.proc, m.slot,
                                m.direction) for m in e.mismatches]
                        if got != want_m:
                            raise AssertionError(f"{method} {phase} {kind}: {got}, "
                                                 f"expected {want_m}")
                    rep = {}
                    rc = distributed_spgemm(a, p, fine, fine, topo, method=method,
                                            device=DEV, integrity="recover",
                                            faults=[fault], report=rep)
                    if not same_csr(rc, clean) or rep["recovered"] != 1:
                        raise AssertionError(f"{method} {phase} {kind}: recover {rep}")
                    n += 1
                print(f"    {method} {phase}: edge {edges['bitflip']}, every kind detected "
                      f"with its (phase, node, proc, slot) and recovered bit-equal")
            print(f"  integrity {method}: clean detect bit-equal to off"
                  + (" (the literal pair exchange vs its live slots)"
                     if method == "standard" else "")
                  + f", {n} faults detected and recovered")
            del rec, c
            clear_spgemm_cache()
            free()
    finally:
        torch.use_deterministic_algorithms(False)


def phase_examples():
    """[9c] the port's two examples on the card, each to its final check."""
    print("[9c] torch examples on the card")
    for name, example in (("quickstart", quickstart), ("amg_spmv", amg_spmv)):
        t0 = time.perf_counter()
        example.main([])
        print(f"  example {name}: ran to its final check, {time.perf_counter() - t0:.2f} s")
    free()


# gemma2-2b serving (phases 10-12) ------------------------------------------------
ATTN_REPLACES = "src/repro/kernels/decode_attn/kernel.py:71"
ATTN_SOURCE = "src/repro_torch/csrc/decode_attn.cu"


def attn_tolerance(q, k, plain, lengths, window, scale, softcap):
    """Per-sequence limit on |kernel - plain|: the same f32 inputs summed
    in two orders, under the random-rounding model (n roundings grow as
    sqrt(n) u, not n u; u = 2^-24).
    - A score's error is about delta = u (sqrt(D) smax + 4 cap): the
      D-term dot product (smax = scale max|q| max|k|, Cauchy-Schwarz),
      then the scaling and tanhf.
    - Relative errors delta_s of the softmax weights move out by
      sum_s p_s delta_s (v_s - out), independent terms, so about
      delta sqrt(sum_s p_s^2 (v_s - out)^2): delta times the spread of
      out itself, which the largest of its Hkv g D entries, max|plain_b|,
      exceeds.
    - The running sums over the sequence's n_b valid rows and the
      partials add about u sqrt(n_b) max|plain_b|.
    The limit is 8 times u (sqrt(D) smax + 4 cap + sqrt(n_b)) max|plain_b|
    (two versions, two kinds of error, a factor 2 for the model).  It
    scales with the output, so a combine that drops one partial or a
    chunk that skips rows of a long sequence (a change of order
    max|plain_b| / partials) fails it."""
    d = q.shape[-1]
    norm = lambda t: float(torch.linalg.vector_norm(  # noqa: E731
        t, dim=-1, dtype=torch.float32).max())
    smax = scale * norm(q) * norm(k)
    n = lengths.long().clamp(min=0, max=k.shape[2])
    if window:
        n = n.clamp(max=window)
    out_b = plain.abs().amax(dim=(1, 2, 3)).double()
    return 8.0 * U32 * (d ** 0.5 * smax + 4.0 * softcap + n.double().sqrt()) * out_b


def attn_case(label, q, k, v, lengths, window, softcap, scale, timed=True):
    """Kernel vs plain (and the library at softcap 0) on one layout;
    the kernels-line numbers of this case."""
    run = lambda: decode_attention_grouped(q, k, v, lengths, scale=scale,  # noqa: E731
                                           softcap=softcap, window=window)
    plain_fn = lambda: decode_attention_ref(q, k, v, lengths, scale=scale,  # noqa: E731
                                            softcap=softcap, window=window)
    out, plain = run(), plain_fn()
    torch.cuda.synchronize()
    tol = attn_tolerance(q, k, plain, lengths, window, scale, softcap)
    err_b = (out - plain).abs().amax(dim=(1, 2, 3)).double()
    err = float(err_b.max())
    ratio = err_b / tol.clamp_min(1e-300)
    worst = int(ratio.argmax())
    print(f"  {label}: max_abs_err {err:.3e} (per-sequence tolerance "
          f"{float(tol.min()):.3e} .. {float(tol.max()):.3e}); worst err / "
          f"tolerance {float(ratio[worst]):.3e} (sequence {worst}, length "
          f"{int(lengths[worst])}: err {float(err_b[worst]):.3e}, tolerance "
          f"{float(tol[worst]):.3e}); max |out| {float(plain.abs().max()):.3f}")
    if not bool((err_b <= tol).all()) or not torch.isfinite(out).all():
        print(f"  {label}: by sequence, lengths {lengths.tolist()}, err "
              f"{[f'{e:.3e}' for e in err_b.tolist()]}, tolerance "
              f"{[f'{t:.3e}' for t in tol.tolist()]}")
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    b, hkv, g, d = q.shape
    n = lengths.long().clamp(max=window) if window else lengths.long()
    rows = int(n.sum())
    nbytes = (2 * rows * hkv * d * k.element_size() + q.nbytes
              + b * hkv * g * d * 4 + lengths.nbytes)
    bms, by = bound_ms(nbytes, 4.0 * rows * hkv * g * d)
    entry = dict(max_abs_err=err, bound_ms=bms, bound_by=by, library_ms=None)
    if not timed:
        return entry
    pos = torch.arange(k.shape[2], device=DEV)[None]
    mask = pos < lengths[:, None]
    if window:
        mask &= pos >= lengths[:, None] - window
    q4, mask4 = q.reshape(b, hkv * g, 1, d), mask[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k, v, attn_mask=mask4, scale=scale, enable_gqa=True)
    lib_err = float((library().float().reshape(out.shape) - decode_attention_grouped(
        q, k, v, lengths, scale=scale, window=window)).abs().max())
    entry.update(ms=time_ms(run), device_ms=device_ms(run), plain_ms=time_ms(plain_fn),
                 library_ms=time_ms(library))
    ms0 = time_ms(lambda: decode_attention_grouped(q, k, v, lengths, scale=scale,
                                                   window=window))
    profile_program(label, run, entry["ms"])
    print(f"  {label}: {rows} k/v rows of {k.shape[2]} x {b}, {nbytes / 1e9:.4f} GB; "
          f"kernel {entry['ms']:.4f} ms (device {entry['device_ms']:.4f}; softcap 0: "
          f"{ms0:.4f}), bound {bms:.4f} ms "
          f"({by}), plain {entry['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"(softcap 0) {entry['library_ms']:.4f} ms, its result vs the kernel "
          f"at softcap 0: max_abs_err {lib_err:.3e}")
    return entry


def phase_decode_attn(rng, gen):
    """[10] the decode-attention kernel at gemma2-2b's decode_32k shapes."""
    cfg = get_config("gemma2-2b")
    b, s, hkv, d = 8, 32768, cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // hkv
    print(f"[10] decode attention: B {b}, S {s}, Hkv {hkv}, g {g}, D {d}, softcap "
          f"{cfg.attn_softcap}")
    lengths = np.concatenate([[1, 17, 4096, 4097], rng.integers(1, s + 1, 3), [s]])
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(DEV)
    q = torch.randn((b, hkv, g, d), generator=gen, device=DEV).to(torch.bfloat16)
    kc = torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
    vc = torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
    scale, cap = 1.0 / d ** 0.5, cfg.attn_softcap
    print(f"  lengths {lengths.tolist()}; cache [B, S, Hkv, D] bf16, k+v "
          f"{(kc.nbytes + vc.nbytes) / 1e9:.3f} GB")
    main = attn_case("bf16 [B,S,Hkv,D] window 0", q, kc.transpose(1, 2),
                     vc.transpose(1, 2), lengths, 0, cap, scale)
    attn_case(f"bf16 [B,S,Hkv,D] window {cfg.sliding_window}", q, kc.transpose(1, 2),
              vc.transpose(1, 2), lengths, cfg.sliding_window, cap, scale)
    k32 = kc.transpose(1, 2).float().contiguous()
    del kc
    v32 = vc.transpose(1, 2).float().contiguous()
    del vc
    attn_case("f32 [B,Hkv,S,D] window 0", q.float(), k32, v32, lengths, 0, cap, scale)
    del k32, v32
    free()
    # the kernel's other instantiations (query tiles of 1, 4 and 8 rows,
    # two tiles at g = 16), untimed at small shapes
    for gg, dd, dtype in ((1, 64, torch.float32), (3, 128, torch.bfloat16),
                          (8, 256, torch.bfloat16), (16, 96, torch.float32)):
        qs = torch.randn((2, 2, gg, dd), generator=gen, device=DEV).to(dtype)
        ks, vs = (torch.randn((2, 1000, 2, dd), generator=gen, device=DEV).to(dtype)
                  for _ in range(2))
        ls = torch.tensor([1000, 333], dtype=torch.int32, device=DEV)
        for w in (0, 100):
            attn_case(f"g {gg} D {dd} {str(dtype)[6:]} window {w}", qs,
                      ks.transpose(1, 2), vs.transpose(1, 2), ls, w, 30.0,
                      dd ** -0.5, timed=False)
    return dict(name="decode_attention_grouped", route="cuda", source=ATTN_SOURCE,
                replaces=ATTN_REPLACES, launches=0, **main)


def phase_serve(n_layers, seed):
    """[11] gemma2-2b serving at full width through serve.generate."""
    cfg = get_config("gemma2-2b").replace(n_layers=n_layers)
    batch, prompt_len, gen_len, max_seq = 4, 512, 32, 1024
    print(f"[11] serve: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}; batch {batch}, prompt {prompt_len}, gen "
          f"{gen_len}, max_seq {max_seq}")
    t0 = time.perf_counter()
    model = build_model(cfg).init(seed)
    torch.cuda.synchronize()
    n_params = count_params(model)
    param_bytes = sum(p.nbytes for p in model.parameters())
    print(f"  init from seed {seed} on the card {time.perf_counter() - t0:.2f} s; "
          f"{n_params} parameters, {param_bytes / 1e9:.3f} GB")
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, prompt_len))
    res, counts = drive("generate", lambda: generate(model, prompts, gen_len, max_seq))
    steps = prompt_len + gen_len
    n_launch = counts.get("decode_attention_grouped", 0)
    if n_launch != cfg.n_layers * steps:
        raise AssertionError(f"decode_attention_grouped launched {n_launch} times, "
                             f"not layers x steps = {cfg.n_layers * steps}")
    if not torch.isfinite(res.logits).all():
        raise AssertionError("serve: non-finite logits")
    step = statistics.median(res.step_ms)
    # bound of the median greedy step: every parameter byte and the cache
    # rows it reads (count c = tokens stored; even layers capped at the window)
    c = prompt_len + gen_len // 2 + 1
    rows = sum(min(c, cfg.sliding_window if i % 2 == 0 else max_seq)
               for i in range(cfg.n_layers))
    cache_bytes = rows * batch * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    step_bound = (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"  kernel launches {n_launch} = {cfg.n_layers} layers x {steps} steps; "
          f"prompt {res.prefill_ms:.1f} ms ({res.prefill_ms / prompt_len:.3f} ms/step); "
          f"greedy step median {step:.4f} ms (min {min(res.step_ms):.4f}, max "
          f"{max(res.step_ms):.4f}), {batch * 1e3 / step:.1f} tok/s; step bound "
          f"{step_bound:.4f} ms (params {param_bytes / 1e9:.3f} GB + cache rows "
          f"{cache_bytes / 1e6:.1f} MB at 3.35 TB/s); logits finite; greedy ids "
          f"[batch 0] {res.tokens[0, :8].tolist()}...")
    # the kernel against its plain version at the serve path's own shapes:
    # the served cache read in place, its lengths after the last step,
    # the windows of an even and an odd layer, a query drawn from the seed
    cache, tok = res.cache, res.tokens[:, -1:]
    g = cfg.n_heads // cfg.n_kv_heads
    q = torch.randn((batch, cfg.n_kv_heads, g, cfg.head_dim), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(seed)
                    ).to(cache["layers"]["k"].dtype)
    for i in range(min(2, cfg.n_layers)):
        w = cfg.sliding_window if i % 2 == 0 else max_seq
        attn_case(f"served cache, layer {i}, window {w}", q,
                  cache["layers"]["k"][i].transpose(1, 2),
                  cache["layers"]["v"][i].transpose(1, 2), cache["length"], w,
                  cfg.attn_softcap, cfg.head_dim ** -0.5)
    profile_program("serve: 4 greedy decode steps",
                    lambda: [model.decode_step(cache, tok) for _ in range(4)], 4 * step)
    del model, res, cache
    free()
    return n_launch


def phase_step_check(seed):
    """[12] the decode step through the kernel vs through the plain version."""
    cfg = get_config("gemma2-2b").replace(n_layers=2, dtype="float32")
    batch, n_steps = 4, 8
    model = build_model(cfg).init(seed)
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (batch, n_steps))).to(DEV)

    def run():
        cache, out = model.init_cache(batch, 64), []
        for t in range(n_steps):
            logits, cache = model.decode_step(cache, toks[:, t:t + 1])
            out.append(logits)
        return torch.stack(out)

    reset_launches()
    got = run()
    n_launch = launches["decode_attention_grouped"]
    kernel = attention.decode_attention_grouped
    attention.decode_attention_grouped = decode_attention_ref
    try:
        reset_launches()
        want = run()
        plain_launches = launches["decode_attention_grouped"]
    finally:
        attention.decode_attention_grouped = kernel
    err = float((got - want).abs().max())
    # Both runs do the same f32 products on the card and differ only in the
    # attention's summation order (<= 8 rows, D = 256: ~1e-6 relative);
    # through two layers and the head that stays below 1e-4 on logits
    # bounded by the final softcap of 30, so 1e-3 leaves a wide margin.
    tol = 1e-3
    print(f"[12] decode step, {cfg.name} 2 layers float32, {n_steps} steps: kernel "
          f"({n_launch} launches) vs plain ({plain_launches}) logits max_abs_err "
          f"{err:.3e} (tolerance {tol:.0e}), max |logit| {float(want.abs().max()):.2f}")
    if n_launch != 2 * n_steps or plain_launches != 0 or not err <= tol \
            or not torch.isfinite(got).all():
        raise AssertionError("decode step through the kernel disagrees with the plain one")
    del model, got, want
    free()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2024, help="main-path grid side")
    ap.add_argument("--bsr-n", type=int, default=512, help="BSR-path grid side")
    ap.add_argument("--lm-layers", type=int, default=26,
                    help="gemma2-2b depth of the serving phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register and shared-memory report")
    args = ap.parse_args()
    global T_START
    T_START = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=DEV).manual_seed(args.seed)

    # 1. environment ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}; TF32 off")

    # 2. build ----------------------------------------------------------------
    info = build_all(ptxas_verbose=args.ptxas)
    print(f"[2] built {info['built']} in {info['seconds']:.2f} s")
    if args.ptxas:
        for src, log in info["log"].items():
            print(f"[2] nvcc {src}:\n{log}")

    # host plans of the NAP paths and the float64 oracles -------------------
    topo = Topology(32, 16)
    t0 = time.perf_counter()
    a = rotated_anisotropic_2d(args.n)
    t_gen = time.perf_counter() - t0
    part = contiguous_partition(a.shape[0], topo.n_procs)
    op = operator(a, topo, part)
    t0 = time.perf_counter()
    c = op.executor.compiled
    t_compile = time.perf_counter() - t0
    rep = op.autotune_report()
    verdict = (rep["resolved"], rep["transpose_resolved"])
    print(f"[plan] n={args.n}: {a.shape[0]} rows, {a.nnz} nnz, "
          f"{topo.n_procs} ranks; generate {t_gen:.2f} s, compile_nap "
          f"{t_compile:.2f} s; rows_pad {c.rows_pad}, pads {c.pads}")
    print(f"[plan] autotune verdict forward={verdict[0]} transpose={verdict[1]} "
          f"(times {rep['times']}, transpose {rep['transpose']['times']})")
    if verdict != ("ell", "ell"):
        print(f"[plan] verdict is not ell in both directions {verdict}; the "
              f"ell phase runs with local_compute='ell'")
        op = operator(a, topo, part, local_compute="ell")
        c = op.executor.compiled
    t0 = time.perf_counter()
    c.ensure_ell()
    c.ensure_ell_t()
    t_ell = time.perf_counter() - t0
    print(f"[plan] ensure_ell + ensure_ell_t {t_ell:.2f} s (host plan build "
          f"{t_compile + t_ell:.2f} s): ell_kmax {c.ell_kmax}, ell_t_kmax "
          f"{c.ell_t_kmax}")

    a_b = rotated_anisotropic_2d(args.bsr_n)
    op_b = operator(a_b, topo, local_compute="bsr")
    t0 = time.perf_counter()
    cb = op_b.executor.compiled
    cb.ensure_fused()
    print(f"[plan] bsr n={args.bsr_n}: {a_b.shape[0]} rows; compile + "
          f"ensure_fused {time.perf_counter() - t0:.2f} s; layout {cb.bsr_layout}, "
          f"fused_blocks {cb.arrays['fused_blocks'].nbytes / 1e9:.3f} GB")

    t0 = time.perf_counter()
    oracles = dict(v1=rng.standard_normal(a.shape[0]),
                   v8=rng.standard_normal((a.shape[0], 8)),
                   u1=rng.standard_normal(a.shape[0]),
                   vb=rng.standard_normal(a_b.shape[0]))
    oracles.update(w1=host_apply(a, oracles["v1"]), w8=host_apply(a, oracles["v8"]),
                   z1=host_apply(a, oracles["u1"], transpose=True),
                   wb=host_apply(a_b, oracles["vb"]))
    print(f"[plan] float64 host oracles {time.perf_counter() - t0:.2f} s")

    # 3-9. the phases ---------------------------------------------------------
    entries = phase_kernels(c, cb, a, a_b, oracles, gen)
    by_name = {e["name"]: e for e in entries}
    fwd, tr, nap_ref = phase_nap(op, a, oracles)
    nap_ref["local_compute"] = op.spec.local_compute
    nap_padded, nap_effective = traffic_bytes(op.stats())
    nap_summary = dict(padded=nap_padded, effective=nap_effective,
                       cost=op.cost(BLUE_WATERS))
    del op, c
    free()
    cnt_p, cnt_c = phase_bsr(op_b, a_b, oracles)
    del op_b, cb
    free()
    s_fwd1, s_fwd8, s_tr = phase_standard(a, a_b, topo, part, oracles,
                                          nap_summary, args.n == 2024)
    free()
    m_fwd, m_tr = phase_multistep(a, topo, part, oracles, nap_ref, gen,
                                  args.n == 2024)
    free()
    t0 = time.perf_counter()
    i_ell, i_bsr, nap_det = phase_integrity(a, topo, part, oracles, a_b)
    phase_simulate(a, topo, part, oracles, a_b, nap_det, nap_ref["w1"],
                   nap_ref["z1"])
    print(f"  phase 8 {time.perf_counter() - t0:.1f} s")
    del oracles, nap_ref, nap_det
    free()
    t0 = time.perf_counter()
    amg = phase_amg(a, topo, gen, args.seed, args.n == 2024)
    print(f"  phase 9 {time.perf_counter() - t0:.1f} s")
    del a
    free()
    t0 = time.perf_counter()
    phase_spgemm_small(a_b, topo, args.seed)
    phase_examples()
    print(f"  phases 9b-9c {time.perf_counter() - t0:.1f} s")
    del a_b
    free()

    # 10-12. gemma2-2b serving ---------------------------------------------------
    entries.append(phase_decode_attn(rng, gen))
    by_name["decode_attention_grouped"] = entries[-1]
    by_name["decode_attention_grouped"]["launches"] = phase_serve(args.lm_layers,
                                                                  args.seed)
    phase_step_check(args.seed)

    # launches of each kernel over the paths that run it (each path's
    # counts were reset just before it); the AMG solve's launches, forward
    # and transpose together, and the materialized Galerkin operator's
    # apply count with the forward entry
    by_name["ell_spmm_packed"]["launches"] = sum(
        d.get("ell_spmm_packed", 0) for d in (fwd, s_fwd1, s_fwd8, m_fwd, amg)) \
        + i_ell["forward"]
    by_name["ell_spmm_packed:transpose"]["launches"] = sum(
        d.get("ell_spmm_packed", 0) for d in (tr, s_tr, m_tr)) + i_ell["transpose"]
    by_name["fused_bsr_spmm_packed"]["launches"] = (
        cnt_p.get("fused_bsr_spmm_packed", 0) + i_bsr.get("fused_bsr_spmm_packed", 0))
    by_name["fused_bsr_spmm"]["launches"] = cnt_c.get("fused_bsr_spmm", 0)
    for e in entries:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']} was not launched on its path")
    print(f"[13] whole script {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
