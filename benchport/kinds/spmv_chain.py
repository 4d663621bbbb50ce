"""Traffic kind ``spmv_chain``: one client's closed loop of SpMV applies,
as a Krylov or eigen solver issues them.

Set-up builds the configuration's matrix from the seed with the frozen
generator of ``problems/``, then the program's default node-aware
operator over it, ``repro_torch.api.operator(a, topo,
contiguous_partition(n, P))`` (``method="nap"``, ``local_compute="auto"``),
its plan and its device programs ``op.executor.program("forward")`` and
``("transpose")``, and stages the first operand with
``op.executor.packed``.  It warms the cell's own shapes.

A request runs the traffic's ``directions`` in turn on the card (each
apply's output is the next one's input), scales the last output to unit
norm per right-hand side, which becomes the next request's input, and
reads the norms back to the host: that read is the request's one sync.
Inputs and outputs stay on the card, packed as the program lays them
out.

The check, once the window has closed and the program's state is freed,
compares a sample of the window's requests drawn from the seed, and the
last request, with the float64 reference: each apply's unpacked output
against the reference's product of that apply's unpacked input.  The
chain feeds each request the program's own previous output, so the
reference follows it step by step; the start (the staged first operand)
and the link between requests (the norms and the unit norm of each
input) are checked by themselves.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchport import harness, reference, trace

PROGRAM = "benchport.program"
NORMALIZE = "benchport.normalize"


def rng(seed: int, stream: int) -> np.random.Generator:
    """The run's numpy stream ``stream``, from any whole-number seed."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def worst(values: List[float]) -> float:
    """The largest value, NaN if any is NaN (Python's ``max`` would drop it)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


class Layout:
    """The contiguous row partition's packed layout, ``[n_nodes, ppn, pad(,
    nv)]``: rank r holds rows ``first[r]:first[r + 1]`` at the front of its
    ``pad`` slots.  The benchmark's own copy of the layout, so that it
    unpacks what the program returns without the program's help."""

    def __init__(self, n: int, n_nodes: int, ppn: int, pad: int, device) -> None:
        procs = n_nodes * ppn
        base, extra = divmod(n, procs)
        counts = np.full(procs, base, dtype=np.int64)
        counts[:extra] += 1
        if counts.max() > pad:
            raise ValueError(f"a rank holds {counts.max()} rows, more than pad {pad}")
        self.n, self.procs, self.pad = n, procs, pad
        self.shape = (n_nodes, ppn, pad)
        self.mask = (torch.arange(pad)[None, :]
                     < torch.from_numpy(counts)[:, None]).to(device)

    def unpack(self, t: torch.Tensor) -> torch.Tensor:
        """Packed ``[.., pad(, nv)]`` -> global ``[n, nv]``."""
        return t.reshape(self.procs, self.pad, -1)[self.mask]

    def pack(self, g: torch.Tensor, single: bool) -> torch.Tensor:
        """Global ``[n, nv]`` -> packed, padding zero; ``single`` drops nv."""
        out = torch.zeros((self.procs, self.pad, g.shape[1]), dtype=g.dtype,
                          device=g.device)
        out[self.mask] = g
        return out.reshape(self.shape) if single else out.reshape(self.shape + (-1,))


#: configuration keys that this kind acts on; every other key of a
#: configuration file has to be one of ``DESCRIPTIVE``
CONSUMED = ("generator", "params", "topology", "operator", "precision", "limits",
            "rows", "nnz")
#: configuration keys that describe and change nothing a run does
DESCRIPTIVE = ("name", "source", "what", "deployment", "reference", "reduced",
               "source_precision", "reduced_why")
#: the value type the program's device programs run
PRECISION = "float32"


def check_config(config: dict) -> None:
    """Refuse a configuration that states what this kind would not run:
    a key it neither acts on nor knows as a description, a precision
    other than the device programs' float32, or integrity checks (the
    chain drives the bare programs, not the instrumented ones)."""
    unknown = sorted(set(config) - set(CONSUMED) - set(DESCRIPTIVE))
    if unknown:
        raise ValueError(f"configuration {config.get('name')!r}: keys "
                         f"{unknown} are not run by the spmv_chain kind")
    if config["precision"] != PRECISION:
        raise ValueError(f"configuration {config.get('name')!r}: precision "
                         f"{config['precision']!r}; the device programs run "
                         f"{PRECISION} only")
    if config["operator"].get("integrity", "off") != "off":
        raise ValueError(f"configuration {config.get('name')!r}: integrity "
                         f"{config['operator']['integrity']!r}; the chain drives "
                         "the bare programs, not the instrumented ones")


class Problem:
    """One configuration built from one seed: the matrix, the program's
    operator (built with the configuration's ``operator`` options) and
    its programs, the layout and the set-up spans."""

    def __init__(self, config: dict, seed: int, device) -> None:
        from repro_torch import api
        from repro_torch.core.partition import contiguous_partition
        from repro_torch.core.topology import Topology
        from repro_torch.sparse.csr import CSR

        check_config(config)
        self.config, self.seed, self.device = config, seed, torch.device(device)
        gen = harness.load_module("problems", config["generator"])
        t0 = time.perf_counter()
        self.csr = gen.build(seed=seed % 2 ** 64, **config["params"])
        self.generate_s = time.perf_counter() - t0
        indptr, indices, data, shape = self.csr
        if shape[0] != shape[1]:
            raise ValueError(f"the chain needs a square matrix, got {shape}")
        self.n, self.nnz = shape[0], int(indices.size)
        for key, got in (("rows", self.n), ("nnz", self.nnz)):
            if key in config and config[key] != got:
                raise ValueError(f"configuration {config['name']!r} states "
                                 f"{key} {config[key]}, the generator made {got}")
        topo = Topology(**config["topology"])

        t0 = time.perf_counter()
        self.op = api.operator(CSR(indptr, indices, data, shape), topo,
                               contiguous_partition(self.n, topo.n_procs),
                               device=str(self.device), **config["operator"])
        self.method = self.op.executor.method
        # the executors that ``op @ v`` and ``op.T @ u`` run (``comm="auto"``
        # may give the transpose one of its own)
        ex = self.op.executor
        ex_t = self.op.transpose_executor or ex
        if ex.local_compute == "ell":
            ex.compiled.ensure_ell()
        if ex_t.transpose_local_compute == "ell":
            ex_t.compiled.ensure_ell_t()
        self.plan_build_s = time.perf_counter() - t0
        self.local_compute = (ex.local_compute, ex_t.transpose_local_compute)
        pads = {ex.compiled.rows_pad, ex.compiled.cols_pad,
                ex_t.compiled.rows_pad, ex_t.compiled.cols_pad}
        if len(pads) != 1:
            raise ValueError(f"packed lengths {sorted(pads)} differ: outputs "
                             "cannot feed the next apply")
        self.layout = Layout(self.n, topo.n_nodes, topo.ppn, pads.pop(), self.device)
        self.programs: Dict[str, Callable] = {
            "forward": ex.program("forward"), "transpose": ex_t.program("transpose")}

    def stage(self, x: np.ndarray) -> torch.Tensor:
        """The program's packing of a global operand, on the card."""
        return self.op.executor.packed("forward", x)

    def release(self) -> None:
        """Free the program's state: operator, plan and programs."""
        from repro_torch.core.spmv_torch import clear_compile_cache
        self.op = self.programs = None
        clear_compile_cache()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def control_programs(problem: Problem, ref: reference.Reference) -> Dict[str, Callable]:
    """The control: the reference in bf16 in the program's place, on the
    same packed operands."""
    lay = problem.layout

    def program(transpose: bool):
        def run(s: torch.Tensor) -> torch.Tensor:
            y, _ = ref.apply(lay.unpack(s), transpose, precision="bf16")
            return lay.pack(y.to(torch.float32), single=s.dim() == 3)
        return run
    return {"forward": program(False), "transpose": program(True)}


class Chain:
    """The traffic's loop over one problem: warm-up, window, traced
    stretch, and what the check needs afterwards."""

    def __init__(self, problem: Problem, traffic: dict, seed: int,
                 programs: Optional[Dict[str, Callable]] = None) -> None:
        self.problem, self.traffic, self.seed = problem, traffic, seed
        self.nv = int(traffic["nv"])
        self.directions = list(traffic["directions"])
        self.programs = programs or problem.programs
        g = rng(seed, 1)
        x0 = g.standard_normal((problem.n, self.nv))
        x0 /= np.linalg.norm(x0, axis=0)
        self.x0 = x0.astype(np.float32)
        host_x0 = self.x0[:, 0] if self.nv == 1 else self.x0
        self.staged = problem.stage(host_x0)
        # the sample: request indices drawn from the seed, compared if due
        self.sample = sorted(int(k) for k in rng(seed, 2).choice(
            int(traffic["sample_within"]), size=int(traffic["sample_requests"]),
            replace=False))
        pin = problem.device.type == "cuda"
        self.snap_bufs = [[torch.empty(self.staged.shape, dtype=torch.float32,
                                       pin_memory=pin)
                           for _ in range(1 + len(self.directions))]
                          for _ in self.sample]
        self.snaps: Dict[int, tuple] = {}
        self.latencies: List[float] = []
        self.failed = 0
        self.window_s = 0.0
        self.last: Optional[tuple] = None

    def request(self, x: torch.Tensor):
        outs = []
        cur = x
        for d in self.directions:
            with record_function(PROGRAM):
                cur = self.programs[d](cur)
            outs.append(cur)
        with record_function(NORMALIZE):
            nrm = torch.linalg.vector_norm(cur, dim=(0, 1, 2))
            nxt = cur / nrm
        return outs, nxt, nrm

    def _snapshot(self, slot: int, x, outs) -> None:
        for buf, t in zip(self.snap_bufs[slot], [x] + outs):
            buf.copy_(t, non_blocking=True)

    def warm_up(self) -> None:
        for _ in range(int(self.traffic["warmup_requests"])):
            outs, _, nrm = self.request(self.staged)
            if self.snap_bufs:
                self._snapshot(0, self.staged, outs)
            nrm.cpu()

    def window(self, seconds: float, min_requests: int = 0) -> None:
        """Closed loop until ``seconds`` have passed (and, for the control
        readings, ``min_requests`` have ended); every request that starts
        in the window ends in it."""
        sample = {k: i for i, k in enumerate(self.sample)}
        x, k = self.staged, 0
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            t0 = time.perf_counter()
            outs, nxt, nrm = self.request(x)
            if k in sample:
                self._snapshot(sample[k], x, outs)
            nrm_h = nrm.cpu()
            t1 = time.perf_counter()
            self.latencies.append(t1 - t0)
            if not bool(torch.isfinite(nrm_h).all()):
                self.failed += 1
            if k in sample:
                self.snaps[k] = (self.snap_bufs[sample[k]], nrm_h)
            self.last = (x, outs, nrm_h)
            x, k = nxt, k + 1
            if t1 >= deadline and k >= min_requests:
                break
        self.window_s = t1 - start
        self._next = x

    def traced(self) -> Dict[str, object]:
        """The chain continued under the profiler for two stretches of the
        traffic's ``trace_requests``: the device's activity alone, whose
        busy and idle time the host's recording would distort, then host
        and device together, which attribute each device operation to the
        benchmark call that launched it and label the idle gaps.  The last
        request traced becomes the last request."""
        state = {"x": self._next}

        def one():
            outs, nxt, nrm = self.request(state["x"])
            self.last = (state["x"], outs, nrm.cpu())
            state["x"] = nxt

        n = int(self.traffic["trace_requests"])
        span = None
        if self.problem.device.type == "cuda":
            span = trace.device_span(trace.profile_requests(one, n, host=False))
        out = trace.reduce(trace.profile_requests(one, n, host=True))
        out["host_window_s"], out["host_busy_s"] = out["window_s"], out["busy_s"]
        if span and span["busy_s"] > 0:
            out.update(span)
        return out

    def check(self, ref: reference.Reference) -> Dict[str, float]:
        """The compared numbers (see the module docstring)."""
        lay = self.problem.layout
        dev = ref.device
        checks = {"start_err": float((lay.pack(torch.from_numpy(self.x0).to(dev),
                                               single=self.nv == 1)
                                      - self.staged.to(dev)).abs().max())}
        cases = [(k, [b.to(dev) for b in bufs], nrm)
                 for k, (bufs, nrm) in sorted(self.snaps.items())]
        x, outs, nrm = self.last
        cases.append((len(self.latencies), [x.to(dev)] + [o.to(dev) for o in outs], nrm))
        errs = {d: [] for d in self.directions}
        norm_errs = []
        for k, tensors, nrm in cases:
            cur = lay.unpack(tensors[0]).to(torch.float64)
            if k > 0:
                norm_errs.append(float((torch.linalg.vector_norm(cur, dim=0)
                                        - 1).abs().max()))
            for d, out in zip(self.directions, tensors[1:]):
                want, scale = ref.apply(cur, transpose=d == "transpose")
                got = lay.unpack(out)
                errs[d].append(reference.scaled_error(got, want, scale))
                cur = got.to(torch.float64)
            exact = torch.linalg.vector_norm(cur, dim=0)
            norm_errs.append(float(((nrm.to(dev, torch.float64) - exact).abs()
                                    / exact).max()))
        for d in self.directions:
            checks[f"{d}_err"] = worst(errs[d])
        checks["norm_err"] = worst(norm_errs)
        checks["compared"] = len(cases)
        return checks


def run(config: dict, traffic: dict, seed: int, seconds: float, trace_on: bool,
        device, programs: Optional[Callable[[Problem, reference.Reference],
                                            Dict[str, Callable]]] = None,
        mark_setup_done: Optional[Callable[[], None]] = None,
        min_requests: int = 0, problem: Optional[Problem] = None,
        ref: Optional[reference.Reference] = None) -> Dict[str, object]:
    """One run of the cell: set-up, window, optional traced stretch, the
    device's peak, the program's state freed, then the check.  Returns
    the record the metric readers read.  ``programs`` puts other programs
    in the program's place (the control, or a fault in a test);
    ``min_requests`` keeps the window open until that many have ended.
    A ``problem`` (and its ``ref``) built by the caller is used as it is
    and left to the caller to release: the readings of many seeds on one
    matrix build it once."""
    own = problem is None
    if own:
        problem = Problem(config, seed, device)
    if ref is None and programs is not None:
        ref = reference.Reference(*problem.csr, device=problem.device)
    chain = Chain(problem, traffic, seed,
                  None if programs is None else programs(problem, ref))
    chain.warm_up()
    if problem.device.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    if mark_setup_done is not None:
        mark_setup_done()
    chain.window(seconds, min_requests)
    peak = (torch.cuda.max_memory_allocated(problem.device)
            if problem.device.type == "cuda" else 0)
    traced = chain.traced() if trace_on else None
    gc.unfreeze()
    chain.programs = None
    if own:
        problem.release()
    if ref is None:
        ref = reference.Reference(*problem.csr, device=problem.device)
    t0 = time.perf_counter()
    checks = chain.check(ref)
    check_s = time.perf_counter() - t0
    applies = len(chain.latencies) * len(chain.directions)
    return {
        "n": problem.n, "nnz": problem.nnz, "nv": chain.nv,
        "applies_per_request": len(chain.directions),
        "method": problem.method,
        "local_compute": problem.local_compute,
        "plan_build_s": problem.plan_build_s,
        "generate_s": problem.generate_s,
        "window": {"seconds": chain.window_s, "latencies_s": chain.latencies,
                   "requests": len(chain.latencies), "applies": applies},
        "attempted": len(chain.latencies), "failed": chain.failed,
        "peak_bytes": peak,
        "trace": traced,
        "checks": checks,
        "check_s": check_s,
    }
