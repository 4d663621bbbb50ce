"""Training driver: data pipeline -> train step -> checkpoints.

The port's counterpart of ``repro/launch/train.py``: a model from a config
(any family: ``LM``, ``ZambaModel``, ``WhisperModel``) with weights drawn
from ``--seed``, the synthetic bigram batches (an encoder-decoder's with
the reference driver's frames of each step, ``data.step_frames``), AdamW
(the config's moment dtype and fp32 masters), ``grad_accum`` forced to 1
as the reference does, a warmup of ``max(steps // 20, 1)``, rolling
checkpoints of ``(params, opt_state)`` with ``extra={"step"}`` and
``--resume`` from the last of them (the last step's checkpoint written
once, where the reference writes it twice when ``--ckpt-every`` divides
``--steps``), each step's host seconds recorded by a
``StragglerDetector``, and the reference's own end rule: ``SystemExit``
unless the mean of the last losses is below the mean of the first.  Runs
on CUDA unless ``--device cpu``.

As the reference's driver builds every model on its (one-chip) mesh,
``train`` puts the MoE archs' blocks on the expert-parallel island of one
chip, ``Topology(1, 1)`` with no pod axis, so their gradients cross the
island's exchanges.  The island differentiates only on the f32 wire: a
config with a narrow wire (qwen3-moe's full config ships ``bf16``)
raises at its first MoE block, saying why.

Checkpoints store the port's tree, one entry per layer
(``0/layers/3/attn/wq``), where the reference stacks the layers.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
      --device cpu --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --full --steps 8 --batch 4 --seq 512
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.topology import Topology
from repro_torch.data import SyntheticLM, step_frames
from repro_torch.device import DeviceLike
from repro_torch.launch.serve import Clock
from repro_torch.launch.steps import TrainStep, make_train_step
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import TreeModel
from repro_torch.moe.dispatch import EPInfo
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves_with_path
from repro_torch.runtime import StragglerDetector


@dataclasses.dataclass
class TrainRun:
    model: TreeModel
    opt_state: Dict
    step_fn: TrainStep          # the run's step, for further steps
    start_step: int
    losses: List[float]         # one per step run
    grad_norms: List[float]     # global grad norm before clipping
    fwd_bwd_ms: List[float]     # loss and grads (CUDA events on the card)
    update_ms: List[float]      # the AdamW update
    floor: float                # the bigram entropy, the loss floor
    detector: StragglerDetector


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The batch on ``device``: integer arrays (tokens, labels) as int64,
    floating ones (whisper's frames) as float32."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64
                                      if np.issubdtype(v.dtype, np.integer)
                                      else torch.float32)
            for k, v in batch.items()}


def step_batch(cfg: ModelConfig, ds: SyntheticLM, step: int,
               batch: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s host batch: ``ds``'s bigram tokens and labels, and
    for an encoder-decoder config the frames the reference driver draws
    for the step (``data.step_frames``)."""
    out = ds.batch(step, batch)
    if cfg.is_encoder_decoder:
        out["frames"] = step_frames(step, batch, cfg.encoder_seq, cfg.d_model)
    return out


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0, device: DeviceLike = None,
          ckpt_dir: str = "", ckpt_every: int = 25, resume: bool = False,
          log_every: int = 5) -> TrainRun:
    """Train ``cfg`` (as given: the caller sets ``grad_accum``) from the
    seed's weights, or from the last checkpoint in ``ckpt_dir`` when
    ``resume``; the schedule spans ``steps``.  A MoE config's blocks run
    on the one-chip island."""
    island = dict(mesh=Topology(1, 1), ep=EPInfo("model", None)) if cfg.is_moe else {}
    model = build_model(cfg, device=device, **island).init(seed)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 1),
                          state_dtype=cfg.opt_state_dtype,
                          master_fp32=cfg.opt_master_fp32)
    opt_state = adamw_init(model.param_tree(), opt_cfg)
    start_step = 0
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=seed)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume:
        (params, opt_state), extra = mgr.restore(
            target=(model.param_tree(), opt_state), device=model.device)
        with torch.no_grad():
            for (_, p), (_, saved) in zip(tree_leaves_with_path(model.param_tree()),
                                          tree_leaves_with_path(params)):
                p.copy_(saved)
        opt_state["step"] = int(opt_state["step"])
        start_step = int(extra["step"])
        print(f"resumed at step {start_step}")

    step_fn = make_train_step(model, opt_cfg)
    run = TrainRun(model=model, opt_state=opt_state, step_fn=step_fn,
                   start_step=start_step,
                   losses=[], grad_norms=[], fwd_bwd_ms=[], update_ms=[],
                   floor=ds.bigram_entropy(), detector=StragglerDetector())
    on_island = f", MoE blocks on the island {model.mesh} ({cfg.wire_dtype} wire)" \
        if cfg.is_moe else ""
    print(f"training {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype}, moments {cfg.opt_state_dtype}) on {model.device}{on_island}; "
          f"bigram-entropy loss floor ~ {run.floor:.3f}")
    for step in range(start_step, steps):
        tb = to_device(step_batch(cfg, ds, step, batch), model.device)
        t0 = time.time()
        clock = Clock(model.device)
        clock.mark()
        loss, grads = step_fn.loss_and_grad(tb)
        clock.mark()
        gnorm = step_fn.update(grads, opt_state)
        clock.mark()
        del grads
        loss = float(loss)
        run.detector.record("local", time.time() - t0)
        fwd_bwd, update = clock.intervals_ms()
        run.losses.append(loss)
        run.grad_norms.append(float(gnorm))
        run.fwd_bwd_ms.append(fwd_bwd)
        run.update_ms.append(update)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  grad norm "
                  f"{run.grad_norms[-1]:.4f}  ({fwd_bwd + update:.1f} ms)")
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, (model.param_tree(), opt_state),
                     extra={"step": step + 1})
    if mgr and steps > start_step and ckpt_every and steps % ckpt_every == 0:
        mgr.wait()           # the last step's checkpoint is the one just saved
    elif mgr:
        mgr.save(steps, (model.param_tree(), opt_state), extra={"step": steps},
                 block=True)
    return run


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    run = train(cfg.replace(grad_accum=1), steps=args.steps, batch=args.batch,
                seq=args.seq, lr=args.lr, seed=args.seed, device=args.device,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume, log_every=args.log_every)
    # the reference's rule: the mean of the last tenth of the losses (at
    # least 3) below the mean of the first
    n = max(3, len(run.losses) // 10)
    first, last = float(np.mean(run.losses[:n])), float(np.mean(run.losses[-n:]))
    print(f"loss {first:.4f} -> {last:.4f} (floor {run.floor:.3f})")
    if last >= first:
        raise SystemExit("loss did not decrease")
    return run


if __name__ == "__main__":
    main()
