"""Serving entry point: teacher-forced prompt + greedy decode on a KV cache.

The port's counterpart of ``repro/launch/serve.py``: a model from a config
with weights drawn from ``--seed``, the prompts teacher-forced through
``decode_step`` (the cache's shape is fixed up front), then greedy
decoding.  Every family serves: the LMs (dense, MoE, rwkv6), zamba2 and
whisper, whose encoder takes frame embeddings ``[B, encoder_seq, d]``
drawn from ``--seed`` (the stubbed conv frontend's output) and fills the
cross-attention caches before the prompt.  Runs on CUDA unless
``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --no-reduced --batch 4 --prompt-len 512 --gen 32 --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build_model
from repro_torch.models.params import TreeModel


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor        # [B, gen] greedy ids (int64)
    logits: torch.Tensor        # [B, 1, V] float32 of the last step
    prompt_logits: torch.Tensor  # [B, 1, V] float32 after the prompt
    cache: Dict
    prefill_ms: float           # the teacher-forced prompt, all steps (whisper:
                                # the encoder's cross caches first)
    step_ms: List[float]        # each greedy decode step


class Clock:
    """Marks on the device's timeline (CUDA events: the step time as the
    card sees it, no sync per step) or on the host's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def generate(model: TreeModel, prompts, gen: int, max_seq: int,
             frames=None) -> Generation:
    """Teacher-force ``prompts`` [B, S] through ``decode_step``, then decode
    ``gen`` tokens greedily (the first from the prompt's last logits).
    ``frames`` [B, encoder_seq, d] (whisper only) fill the cross-attention
    caches from ``model.cross_cache`` first; without them they stay zero,
    as the reference's server leaves them."""
    prompts = torch.as_tensor(prompts, device=model.device)
    b, s = prompts.shape
    if s < 1 or s + gen > max_seq:
        raise ValueError(f"prompt {s} + gen {gen} must be within 1..max_seq {max_seq}")
    if frames is not None and not hasattr(model, "cross_cache"):
        raise ValueError(f"{model.cfg.name} has no encoder to take frames")
    clock = Clock(model.device)
    cache = model.init_cache(b, max_seq)
    clock.mark()
    if frames is not None:
        cache.update(model.cross_cache(torch.as_tensor(frames, device=model.device)))
    logits = None
    for t in range(s):
        logits, cache = model.decode_step(cache, prompts[:, t:t + 1])
    clock.mark()
    prompt_logits = logits
    out: List[torch.Tensor] = []
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for _ in range(gen):
        out.append(tok)
        logits, cache = model.decode_step(cache, tok)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        clock.mark()
    times = clock.intervals_ms()
    tokens = torch.cat(out, dim=1) if out else prompts.new_zeros((b, 0))
    return Generation(tokens=tokens, logits=logits, prompt_logits=prompt_logits,
                      cache=cache, prefill_ms=times[0], step_ms=times[1:])


def main(argv: Optional[Sequence[str]] = None) -> Generation:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=args.device).init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    frames = (rng.standard_normal((args.batch, cfg.encoder_seq, cfg.d_model))
              .astype(np.float32) if cfg.is_encoder_decoder else None)
    res = generate(model, prompts, args.gen, args.max_seq, frames=frames)
    step = statistics.median(res.step_ms) if res.step_ms else float("nan")
    print(f"{cfg.name} on {model.device}: prompt {args.prompt_len} toks x "
          f"{args.batch} seqs {res.prefill_ms / 1e3:.2f}s; decode {args.gen} "
          f"steps, median {step:.3f} ms/step "
          f"({args.batch * 1e3 / step:.1f} tok/s)")
    print("generated ids [batch 0]:", res.tokens[0].tolist())
    if not torch.isfinite(res.logits).all():
        raise RuntimeError("non-finite logits")
    return res


if __name__ == "__main__":
    main()
