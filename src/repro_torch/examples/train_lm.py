"""End-to-end training of a small gemma2-family LM on the synthetic bigram
stream: the port's counterpart of ``examples/train_lm.py``.

Exercises the training stack of the port: the bigram data pipeline, the
gemma2-family model at a ~20M width (``--full-100m`` for ~100M), AdamW,
async checkpoints, and asserts that the loss drops by more than 0.5 toward
the generating process's entropy floor.  Runs on CUDA unless ``--device
cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
"""
import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import to_device
from repro_torch.models import build_model, count_params
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    base = get_config("gemma2-2b")
    if args.full_100m:
        cfg = base.replace(n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
                           d_head=64, d_ff=2048, vocab=32_768,
                           sliding_window=64, attn_block_q=64,
                           attn_block_kv=64, xent_chunk=128,
                           dtype="float32", remat=False, grad_accum=1)
    else:
        cfg = base.replace(n_layers=6, d_model=256, n_heads=8, n_kv_heads=4,
                           d_head=32, d_ff=1024, vocab=8_192,
                           sliding_window=64, attn_block_q=64,
                           attn_block_kv=64, xent_chunk=128,
                           dtype="float32", remat=False, grad_accum=1)
    model = build_model(cfg, device=args.device).init(0)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} "
          f"-> {count_params(model) / 1e6:.1f}M params on {model.device}")

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    opt_state = adamw_init(model.param_tree(), opt_cfg)
    step_fn = make_train_step(model, opt_cfg)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, seed=0)
    floor = ds.bigram_entropy()
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        loss, _ = step_fn(opt_state, to_device(ds.batch(step, args.batch),
                                               model.device))
        losses.append(float(loss))
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"(floor {floor:.3f}, {time.time() - t0:.0f}s)")
        if mgr and (step + 1) % 100 == 0:
            mgr.save(step + 1, (model.param_tree(), opt_state),
                     extra={"step": step + 1})
    if mgr:
        mgr.wait()

    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    print(f"\nloss {first:.3f} -> {last:.3f}; bigram-entropy floor {floor:.3f}")
    if not last < first - 0.5:
        raise AssertionError("training failed to learn the bigram structure")
    print("OK: the model learned the synthetic structure")
    return {"first": first, "last": last, "floor": floor,
            "seconds": time.time() - t0}


if __name__ == "__main__":
    main()
