"""Hold the port's decode-attention kernel of two checkouts against each
other on the card, in turns (A, B, B, A), each turn a fresh process.

    python3 scripts/decode_attn_ab.py PARENT_DIR CHANGE_DIR

Each directory is a checkout (or ``git archive``) holding
``src/repro_torch``; its kernels build into its own ``build/kernels``.
A turn times the kernel at the shapes of PERF.md's decode rows: gemma2-2b's
heads (Hkv 4, g 2, D 256, softcap 50) at phase 10's lengths with windows 0
and 4096, qwen3-moe's (Hkv 4, g 16, D 128) and chameleon-34b's (Hkv 8, g 8,
D 128) at phase 20's decode_32k lengths, qwen3-moe's heads on a
[B, Hkv, S, D] copy of the same cache, served-cache shapes (B 4,
S 128 and 1024), and one query row a kv head (g = 1): zamba2-2.7b's heads
(Hkv 32, D 80) and whisper-small's (Hkv 12, D 64) at the same lengths, and
whisper's cross-attention as served (B 4 x 1500 rows).  Caches are bf16
[B, S, Hkv, D] from seed 0, read in place.  "device ms" is CUDA events
around 20 back-to-back calls over 20 (the wrapper's host time where it is
longer than the kernel); "graph ms" the same calls captured in a CUDA
graph and replayed, the device's time alone.  Each turn also reports the
largest error against the plain version.  One JSON line a turn, then a
table of the turns.  Needs one CUDA card.
"""
import json
import subprocess
import sys

L32 = [1, 17, 4096, 4097, 9000, 20000, 30000, 32768]
L10 = [1, 17, 4096, 4097, 27874, 20872, 16749, 32768]
CASES = [  # label, B, S, Hkv, g, D, lengths, window, softcap, layout
    ("5 gemma2 g2 D256 w0", 8, 32768, 4, 2, 256, L10, 0, 50.0, "BSHD"),
    ("5 gemma2 g2 D256 w4096", 8, 32768, 4, 2, 256, L10, 4096, 50.0, "BSHD"),
    ("5b qwen3 g16 D128", 8, 32768, 4, 16, 128, L32, 0, 0.0, "BSHD"),
    ("5c chameleon g8 D128", 8, 32768, 8, 8, 128, L32, 0, 0.0, "BSHD"),
    ("5b qwen3 g16 D128 [B,Hkv,S,D]", 8, 32768, 4, 16, 128, L32, 0, 0.0, "BHSD"),
    ("served qwen3 g16 D128 S128", 4, 128, 4, 16, 128, [68] * 4, 0, 0.0, "BSHD"),
    ("served gemma2 g2 D256 S1024", 4, 1024, 4, 2, 256, [544] * 4, 4096, 50.0, "BSHD"),
    ("5e zamba2 g1 D80", 8, 32768, 32, 1, 80, L32, 0, 0.0, "BSHD"),
    ("5f whisper g1 D64", 8, 32768, 12, 1, 64, L32, 0, 0.0, "BSHD"),
    ("5f whisper cross g1 S1500", 4, 1500, 12, 1, 64, [1500] * 4, 0, 0.0, "BSHD"),
]


def turn(tree):
    """Time the kernel of checkout ``tree`` at CASES; one JSON line."""
    sys.path.insert(0, tree + "/src")
    import torch
    from repro_torch.kernels.decode_attn import (decode_attention_grouped,
                                                 decode_attention_ref)

    dev = torch.device("cuda")

    def device_ms(fn, n=20, warmup=3):
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

    def graph_ms(fn, n=20, reps=5):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (n * reps)

    res = {"tree": tree}
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, s, hkv, g, d, lens, window, cap, layout in CASES:
        q = torch.randn((b, hkv, g, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
                .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
        if layout == "BHSD":
            k, v = k.contiguous(), v.contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(scale=d ** -0.5, softcap=cap, window=window)
        run = lambda: decode_attention_grouped(q, k, v, lengths, **kw)  # noqa: E731
        err = float((run() - decode_attention_ref(q, k, v, lengths, **kw)).abs().max())
        res[label] = dict(device_ms=device_ms(run), graph_ms=graph_ms(run), max_abs_err=err)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main(argv):
    if argv[:1] == ["--turn"]:
        turn(argv[1])
        return
    if len(argv) != 2:
        sys.exit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    a, b = argv
    turns = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, __file__, "--turn", tree], check=True,
                             capture_output=True, text=True).stdout
        turns.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    for key in ("device_ms", "graph_ms"):
        print(key.ljust(32) + "".join(f"{t['tree'][-12:]:>14}" for t in turns))
        for label, *_ in CASES:
            print(label.ljust(32) + "".join(f"{t[label][key]:14.4f}" for t in turns))


if __name__ == "__main__":
    main(sys.argv[1:])
