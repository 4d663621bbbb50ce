#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the node-aware SpMV on one GPU.

    python3 chip_smoke.py            # full size; needs one CUDA GPU and nvcc

Phases, each fatal on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. the build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, all sources in parallel) and its seconds;
3. each kernel against its plain PyTorch version at the main path's
   shapes: max error, kernel / plain / library ms (CUDA events, median of
   20) and the least time the card could take (bound);
4. the main path at full size: the paper's rotated anisotropic diffusion
   (FE 9-point, eps 0.001, theta pi/6) on a 2024 x 2024 grid (4,096,576
   rows) over Topology(32, 16), 512 ranks: ``op @ v`` for nv = 1 and 8,
   then ``op.T @ u``, held against a float64 host CSR matvec at rtol 1e-4
   / atol 1e-5, through the ELL kernel;
5. the fused-BSR forward on a 512 x 512 grid over the same topology,
   packed and concatenated x bit-equal, both against the float64 oracle;
6. a JSON line of every kernel, then the result line.

Launch counts are reset right before each path is driven and read right
after.  TF32 is switched off, so the plain versions' products are f32.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script needs a GPU")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.api import operator  # noqa: E402
from repro_torch.core.partition import contiguous_partition  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.kernels import build_all, launches, reset_launches  # noqa: E402
from repro_torch.kernels.bsr_spmv import (fused_bsr_spmm,  # noqa: E402
                                          fused_bsr_spmm_packed,
                                          fused_bsr_spmm_packed_ref,
                                          fused_bsr_spmm_ref)
from repro_torch.kernels.ell_spmv import (ell_spmm_packed,  # noqa: E402
                                          ell_spmm_packed_ref)
from repro_torch.sparse import rotated_anisotropic_2d  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor
# cores (both kernels run f32 FMAs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
U32 = 2.0 ** -24            # f32 unit roundoff
TOL = dict(rtol=1e-4, atol=1e-5)


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
                 plain_ms=time_ms(lambda: ell_spmm_packed_ref(cols, vals, xs)),
                 bound_ms=bms, bound_by=by,
                 library_ms=time_ms(lambda: torch.sparse.mm(a, x_cat)))
    print(f"  {name}: shapes cols {tuple(cols.shape)} segments "
          f"{[tuple(x.shape) for x in xs]}; {nbytes / 1e6:.1f} MB; kernel "
          f"{entry['ms']:.4f} ms, bound {bms:.4f} ms ({by}), plain "
          f"{entry['plain_ms']:.4f} ms, torch.sparse.mm CSR {entry['library_ms']:.4f} ms")
    return entry


def bsr_case(name, replaces, cols, blocks, xs, packed):
    """Kernel vs plain for one fused-BSR wrapper; the kernels-line entry."""
    if packed:
        run = lambda: fused_bsr_spmm_packed(cols, blocks, xs)  # noqa: E731
        plain_fn = lambda: fused_bsr_spmm_packed_ref(cols, blocks, xs)  # noqa: E731
        abs_xs = tuple(x.abs() for x in xs)
        scale_fn = lambda: fused_bsr_spmm_packed_ref(cols, blocks.abs(), abs_xs)  # noqa: E731
    else:
        run = lambda: fused_bsr_spmm(cols, blocks, xs[0])  # noqa: E731
        plain_fn = lambda: fused_bsr_spmm_ref(cols, blocks, xs[0])  # noqa: E731
        scale_fn = lambda: fused_bsr_spmm_ref(cols, blocks.abs(), xs[0].abs())  # noqa: E731
    out, plain = run(), plain_fn()
    p, nbr, ktot, bm, bn = blocks.shape
    err = check_close(name, out, plain, ktot * bn, float(scale_fn().max()))
    nv = xs[0].shape[-1]
    n_bc = sum(x.shape[1] for x in xs)
    live = cols >= 0
    dense = blocks[live]                                  # [n_live, bm, bn]
    b_idx = live.nonzero()                                # (rank, brow, slot)
    nz = dense.nonzero()                                  # (block, m, n)
    blk = b_idx[nz[:, 0]]
    rows = (blk[:, 0] * nbr + blk[:, 1]) * bm + nz[:, 1]
    ccol = (blk[:, 0] * n_bc + cols[live].long()[nz[:, 0]]) * bn + nz[:, 2]
    a = csr_from_coo(rows, ccol, dense[nz[:, 0], nz[:, 1], nz[:, 2]],
                     (p * nbr * bm, p * n_bc * bn))
    x_cat = torch.cat(xs, dim=1).reshape(p * n_bc * bn, nv)
    lib = torch.sparse.mm(a, x_cat).reshape(out.shape)
    print(f"  {name}: library result max_abs_err {float((lib - plain).abs().max()):.3e}")
    n_live = int(live.sum())
    nbytes = (cols.nbytes + n_live * bm * bn * 4 + sum(x.nbytes for x in xs)
              + out.nbytes)
    bms, by = bound_ms(nbytes, 2.0 * n_live * bm * bn * nv)
    entry = dict(name=name, route="cuda", source="src/repro_torch/csrc/bsr_spmm.cu",
                 replaces=replaces, launches=0, max_abs_err=err,
                 ms=time_ms(run), plain_ms=time_ms(plain_fn),
                 bound_ms=bms, bound_by=by,
                 library_ms=time_ms(lambda: torch.sparse.mm(a, x_cat)))
    print(f"  {name}: blocks {tuple(blocks.shape)} ({n_live} live) segments "
          f"{[tuple(x.shape) for x in xs]}; {nbytes / 1e6:.1f} MB; kernel "
          f"{entry['ms']:.4f} ms, bound {bms:.4f} ms ({by}), plain "
          f"{entry['plain_ms']:.4f} ms, torch.sparse.mm CSR {entry['library_ms']:.4f} ms")
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
    """Run one path with the launch counts reset just before it."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(launches)
    print(f"  {label}: launches {counts}")
    return out, counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2024, help="main-path grid side")
    ap.add_argument("--bsr-n", type=int, default=512, help="BSR-path grid side")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register and shared-memory report")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

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

    # host plans of both paths (what phases 3-5 run on) ---------------------
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
    print(f"[plan] ensure_ell + ensure_ell_t {t_ell:.2f} s: ell_kmax "
          f"{c.ell_kmax}, ell_t_kmax {c.ell_t_kmax}")

    a_b = rotated_anisotropic_2d(args.bsr_n)
    op_b = operator(a_b, topo, local_compute="bsr")
    t0 = time.perf_counter()
    cb = op_b.executor.compiled
    cb.ensure_fused()
    print(f"[plan] bsr n={args.bsr_n}: {a_b.shape[0]} rows; compile + "
          f"ensure_fused {time.perf_counter() - t0:.2f} s; layout {cb.bsr_layout}, "
          f"fused_blocks {cb.arrays['fused_blocks'].nbytes / 1e9:.3f} GB")

    # 3. kernels against their plain versions -------------------------------
    print("[3] kernels against plain PyTorch versions")
    p = topo.n_procs

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

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
    bsegs3 = tuple(randn(*s.shape[:3], 3) for s in bsegs)
    check_close("fused_bsr_spmm_packed nv=3",
                fused_bsr_spmm_packed(tb["fused_cols"], tb["fused_blocks"], bsegs3),
                fused_bsr_spmm_packed_ref(tb["fused_cols"], tb["fused_blocks"], bsegs3),
                cb.bsr_layout["kmax"] * bn,
                float(fused_bsr_spmm_packed_ref(
                    tb["fused_cols"], tb["fused_blocks"].abs(),
                    tuple(x.abs() for x in bsegs3)).max()))
    if not torch.equal(
            fused_bsr_spmm_packed(tb["fused_cols"], tb["fused_blocks"], bsegs3),
            fused_bsr_spmm(tb["fused_cols"], tb["fused_blocks"],
                           torch.cat(bsegs3, dim=1))):
        raise AssertionError("packed and concatenated BSR kernels differ")
    by_name = {e["name"]: e for e in entries}

    # 4. the main path at full size -----------------------------------------
    print(f"[4] main path: n={args.n}, Topology(32, 16), local_compute="
          f"{op.spec.local_compute!r}")
    ex = op.executor
    v1 = rng.standard_normal(a.shape[0])
    v8 = rng.standard_normal((a.shape[0], 8))
    u1 = rng.standard_normal(a.shape[0])
    t0 = time.perf_counter()
    (w1, w8), fwd = drive("forward nv=1 and nv=8", lambda: (op @ v1, op @ v8))
    t_fwd = time.perf_counter() - t0
    (z1,), tr = drive("transpose nv=1", lambda: (op.T @ u1,))
    if op.local_compute != "ell" or op.T.local_compute != "ell":
        raise AssertionError(f"main path did not resolve to ell: "
                             f"{op.local_compute}, {op.T.local_compute}")
    by_name["ell_spmm_packed"]["launches"] = fwd.get("ell_spmm_packed", 0)
    by_name["ell_spmm_packed:transpose"]["launches"] = tr.get("ell_spmm_packed", 0)
    for lbl, got, v, trans in (("forward nv=1", w1, v1, False),
                               ("forward nv=8", w8, v8, False),
                               ("transpose nv=1", z1, u1, True)):
        want = host_apply(a, v, transpose=trans)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{lbl}: bad result {got.shape}")
        np.testing.assert_allclose(got, want, **TOL)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"  {lbl}: matches float64 host CSR (max abs err / max |ref| {rel:.3e})")
    prog_ms = {}
    for lbl, direction, v in (("forward nv=1", "forward", v1),
                              ("forward nv=8", "forward", v8),
                              ("transpose nv=1", "transpose", u1)):
        shards = ex.packed(direction, v)
        prog = ex.program(direction)
        prog_ms[lbl] = time_ms(lambda: prog(shards), reps=10)
        profile_program(lbl, lambda: prog(shards), prog_ms[lbl])
    print(f"  device program ms (median of 10, pack/unpack excluded): "
          + ", ".join(f"{k} {v:.4f}" for k, v in prog_ms.items()))
    print(f"  host: plan build {t_compile + t_ell:.2f} s; first forward pair "
          f"(pack + program + unpack, nv=1 and nv=8) {t_fwd:.2f} s")

    # 5. the fused-BSR forward ----------------------------------------------
    print(f"[5] bsr forward: n={args.bsr_n}, Topology(32, 16)")
    vb = rng.standard_normal((a_b.shape[0], 1))
    wp, cnt_p = drive("packed x", lambda: op_b @ vb)
    wc, cnt_c = drive("materialize_x", lambda: op_b(vb, materialize_x=True))
    by_name["fused_bsr_spmm_packed"]["launches"] = cnt_p.get("fused_bsr_spmm_packed", 0)
    by_name["fused_bsr_spmm"]["launches"] = cnt_c.get("fused_bsr_spmm", 0)
    if not np.array_equal(wp, wc):
        raise AssertionError("packed and materialized BSR forwards differ")
    want = host_apply(a_b, vb)
    np.testing.assert_allclose(wp, want, **TOL)
    shards = op_b.executor.packed("forward", vb)
    ms_p = time_ms(lambda: op_b.executor.program("forward")(shards), reps=10)
    ms_c = time_ms(lambda: op_b.executor.program("forward", True)(shards), reps=10)
    print(f"  packed and materialized bit-equal, both match float64 host CSR; "
          f"device program ms packed {ms_p:.4f}, materialized {ms_c:.4f}")

    for e in entries:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']} was not launched on its path")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
