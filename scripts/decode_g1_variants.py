"""Time shapes of the g = 1 decode kernel's design against each other on
the card, in turns, in one process.

    python3 scripts/decode_g1_variants.py

Each variant is a copy of ``src/repro_torch/csrc/decode_attn.cu`` with the
g = 1 constants replaced (ring slots a thread, positions a slot, warps a
block, blocks an SM in the launch bounds), built with nvcc into
``build/variants/``; some also force the head group (hg, phases) that the
wrapper's ``g1_groups`` would choose.  Variant A is the source as it is,
timed first and last.  Cases: zamba2-2.7b's heads (Hkv 32, D 80) and
whisper-small's (Hkv 12, D 64) at decode_32k's lengths (rows 5e, 5f of
PERF.md), whisper's cross-attention as served (B 4 x 1500 rows) and one
application of zamba2's long_500k (B 1, S 524,288).  Caches are bf16
[B, S, Hkv, D] from seed 0, read in place.  "dev" is CUDA events around
20 back-to-back calls over 20; "graph" the same calls captured in a CUDA
graph and replayed (the device's time alone); "share" the bound (k/v rows
inside the masks once at 3.35 TB/s) over the graph time.  One line a
variant.  Needs one CUDA card.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn import kernel as K  # noqa: E402
from repro_torch.kernels.decode_attn.ref import decode_attention_ref  # noqa: E402

# name: (ring slots, positions a bf16 slot, warps, blocks an SM, {(Hkv, D): (hg, phases)})
VARIANTS = {
    "A": (4, 2, 8, 3, {}),
    "B": (3, 2, 8, 3, {}),
    "C": (6, 2, 8, 3, {}),
    "D": (2, 4, 8, 3, {}),
    "E": (4, 4, 8, 3, {}),
    "F": (4, 2, 4, 3, {}),
    "G": (8, 2, 4, 3, {}),
    "H": (3, 4, 4, 3, {}),
    "I": (4, 2, 11, 2, {(32, 80): (32, 1), (12, 64): (12, 3)}),
    "J": (4, 2, 16, 1, {(32, 80): (32, 1), (12, 64): (12, 5)}),
    "K": (4, 2, 8, 3, {(32, 80): (16, 1), (12, 64): (12, 2)}),
    "L": (4, 2, 8, 3, {(12, 64): (12, 2)}),
}
L32 = [1, 17, 4096, 4097, 9000, 20000, 30000, 32768]
CASES = {"5e": (8, 32768, 32, 80, L32), "5f": (8, 32768, 12, 64, L32),
         "cross": (4, 1500, 12, 64, [1500] * 4), "500k": (1, 524288, 32, 80, [524288])}
DEV = torch.device("cuda")


def build():
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/decode_attn.cu")).read()
    out = os.path.join(ROOT, "build", "variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, (stages, pos, warps, blocks, _) in VARIANTS.items():
        text = src
        for old, new in (("constexpr int kG1Stages = 4;", f"constexpr int kG1Stages = {stages};"),
                         ("static constexpr int kPos = 2 / kVecs;",
                          f"static constexpr int kPos = {pos} / kVecs;"),
                         ("constexpr int kG1Warps = 8;", f"constexpr int kG1Warps = {warps};"),
                         ("constexpr int kG1MinBlocks = 3;",
                          f"constexpr int kG1MinBlocks = {blocks};")):
            if old not in text:
                raise SystemExit(f"the source no longer has {old!r}")
            text = text.replace(old, new)
        path = os.path.join(out, f"decode_attn_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"decode_attn_{name}.so"))
    return libs


def use(lib, name, groups=K.g1_groups):
    """Route the wrapper's g = 1 path to variant ``name``'s library."""
    _, _, warps, _, force = VARIANTS[name]
    _build._libs["decode_attn"] = lib
    K.G1_WARPS = warps
    K.g1_groups = lambda hkv, d: force.get((hkv, d)) or groups(hkv, d)
    K._g1_slots.cache_clear()
    K._g1_plan.cache_clear()
    K._G1_SCRATCH.clear()


def device_ms(fn, n=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n=20, reps=5):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * reps)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build()
    gen = torch.Generator(device=DEV).manual_seed(0)
    data = {}
    for label, (b, s, hkv, d, lens) in CASES.items():
        q = torch.randn((b, hkv, 1, d), generator=gen, device=DEV).to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
                .transpose(1, 2) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=DEV)
        plain = decode_attention_ref(q, k, v, lengths, scale=d ** -0.5)
        bound = 2 * sum(min(n, s) for n in lens) * hkv * d * 2 / 3.35e12 * 1e3
        data[label] = (q, k, v, lengths, plain, bound)
    groups = K.g1_groups
    for name in list(VARIANTS) + ["A"]:
        use(libs[name], name, groups)
        row = {"variant": name, "shape": VARIANTS[name][:4],
               "groups": [K.g1_groups(32, 80), K.g1_groups(12, 64)],
               "slots": K._g1_slots(torch.cuda.current_device(), 1)}
        for label, (q, k, v, lengths, plain, bound) in data.items():
            def run(q=q, k=k, v=v, lengths=lengths):
                return K.decode_attention_grouped(q, k, v, lengths, scale=q.shape[3] ** -0.5)
            err = float((run() - plain).abs().max())
            graph = graph_ms(run, n=5 if label == "500k" else 20)
            row[label] = dict(max_abs_err=err, dev=round(device_ms(run), 5),
                              graph=round(graph, 5), share=round(bound / graph, 3))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
