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

**Data parallel.**  The reference builds its mesh over every device it
has (``data`` x ``model`` = ``(device_count, 1)``) and splits the batch
over ``data``.  Here the data axis is the processes of a
``torch.distributed`` job: ``main`` attaches to the launcher's job when
its ``REPRO_MESH_*`` environment is set
(``launch("repro_torch.launch.train:main", 2, args=[...])``), and
``train(..., mesh=)`` takes the job's ``ProcessMesh`` over
``Topology(world, 1)``.  Every process draws the
global batch of the step from the same seed and keeps its rows (a batch
that does not split over the world raises before any compute), runs one
replica of the model, sums the loss and gradient over the job
(``TrainStep.all_reduce``) and applies the same AdamW update; after
every step the processes compare a digest of every parameter and stop
if they differ.  Process 0 alone writes the checkpoints and tells every
process how the save went; every process restores between two barriers.
The state is replicated, so a checkpoint resumes in a job of any size.
A MoE arch keeps a one-chip island a replica unless ``train`` is given
another ``island`` (a ``ProcessMesh``: the island's exchanges cross the
processes, each running its pods' rows).  In one process (no
environment, or a world of 1) nothing of this runs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
      --device cpu --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --full --steps 8 --batch 4 --seq 512
  PYTHONPATH=src REPRO_MESH_BACKEND=gloo python -c "from repro_torch.mesh \
      import launch; print(launch('repro_torch.launch.train:main', 2, args=[ \
      '--arch', 'gemma2-2b', '--device', 'cpu', '--steps', '20']).output(0))"
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.topology import Topology
from repro_torch.data import SyntheticLM, step_frames
from repro_torch.device import DeviceLike
from repro_torch.launch.serve import Clock
from repro_torch.launch.steps import TrainStep, make_train_step
from repro_torch.mesh.buffers import (ProcessMesh, broadcast_from_first,
                                      gather_from_all, is_first_process,
                                      job_barrier, mesh_for, process_count)
from repro_torch.mesh.launcher import attach, detach
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
    # a data-parallel job's, one per step: the all-reduce's ms (CUDA
    # events on the card) and wall ms, what the mesh counted in it
    # (``ProcessMesh.stats``), and the parameters' digest every process
    # agreed on after the update
    allreduce_ms: List[float] = dataclasses.field(default_factory=list)
    allreduce_wall_ms: List[float] = dataclasses.field(default_factory=list)
    sync_stats: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    digests: List[str] = dataclasses.field(default_factory=list)


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


def param_digest(model: TreeModel) -> str:
    """sha256 of every parameter's bytes, leaves in path order."""
    h = hashlib.sha256()
    for _, p in tree_leaves_with_path(model.param_tree()):
        h.update(p.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def check_replicas(model: TreeModel, mesh: ProcessMesh, step: int) -> str:
    """The parameters' digest, the same in every process of the job, or
    ``RuntimeError`` in every process."""
    digests = gather_from_all(param_digest(model), mesh)
    if len(set(digests)) != 1:
        raise RuntimeError(f"step {step}: the replicas' parameters differ across the "
                           f"job's processes (digests {[d[:12] for d in digests]})")
    return digests[0]


def _first_writes(mesh: Optional[ProcessMesh], write: Callable[[], None]) -> None:
    """``write()`` (a checkpoint save, or the wait for one) in one process;
    in a job on process 0 alone, and every process learns how it went: a
    failure, of this save or of the previous background one, stops every
    process."""
    if mesh is None:
        write()
        return
    err = None
    if is_first_process():
        try:
            write()
        except RuntimeError as e:
            err = e
    failed = broadcast_from_first(None if err is None else f"{err} ({err.__cause__})",
                                  mesh)
    if err is not None:
        raise err
    if failed is not None:
        raise RuntimeError(f"process 0's checkpoint save failed: {failed}")


def _restore(mgr: CheckpointManager, mesh: Optional[ProcessMesh], target, device):
    """The last committed checkpoint; in a job every process reads it
    between two barriers, so none writes (or collects old steps) before
    all have read."""
    if mesh is None:
        return mgr.restore(target=target, device=device)
    job_barrier(mesh)
    try:
        return mgr.restore(target=target, device=device)
    finally:
        job_barrier(mesh)


GradsHook = Callable[[int, TreeModel, Dict[str, torch.Tensor], torch.Tensor, Dict], None]


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0, device: DeviceLike = None,
          ckpt_dir: str = "", ckpt_every: int = 25, resume: bool = False,
          log_every: int = 5, mesh: Optional[ProcessMesh] = None,
          island: Optional[Union[Topology, ProcessMesh]] = None,
          on_grads: Optional[GradsHook] = None) -> TrainRun:
    """Train ``cfg`` (as given: the caller sets ``grad_accum``) from the
    seed's weights, or from the last checkpoint in ``ckpt_dir`` when
    ``resume``; the schedule spans ``steps``.  A MoE config's blocks run
    on the one-chip island, or on ``island``.  ``mesh`` is the job's data
    axis (module docstring); ``batch`` is the global batch.
    ``on_grads(step, model, batch, loss, grads)``, for a caller that
    inspects a step, sees this process's batch and the global loss and
    gradient before the update."""
    world = 1 if mesh is None else mesh.world
    if batch % world:
        raise ValueError(f"a global batch of {batch} does not split over the "
                         f"{world} processes of the job")
    mesh = mesh if world > 1 else None
    rows = slice(mesh.rank * (batch // world), (mesh.rank + 1) * (batch // world)) \
        if mesh is not None else slice(None)
    if not cfg.is_moe:
        placed = {}
    elif island is None:
        placed = dict(mesh=Topology(1, 1), ep=EPInfo("model", None))
    else:
        placed = dict(mesh=island)
    model = build_model(cfg, device=device, **placed).init(seed)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 1),
                          state_dtype=cfg.opt_state_dtype,
                          master_fp32=cfg.opt_master_fp32)
    opt_state = adamw_init(model.param_tree(), opt_cfg)
    start_step = 0
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=seed)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume:
        (params, opt_state), extra = _restore(
            mgr, mesh, (model.param_tree(), opt_state), model.device)
        with torch.no_grad():
            for (_, p), (_, saved) in zip(tree_leaves_with_path(model.param_tree()),
                                          tree_leaves_with_path(params)):
                p.copy_(saved)
        opt_state["step"] = int(opt_state["step"])
        start_step = int(extra["step"])
        print(f"resumed at step {start_step}")

    step_fn = make_train_step(model, opt_cfg, mesh)
    run = TrainRun(model=model, opt_state=opt_state, step_fn=step_fn,
                   start_step=start_step,
                   losses=[], grad_norms=[], fwd_bwd_ms=[], update_ms=[],
                   floor=ds.bigram_entropy(), detector=StragglerDetector())
    where = f"{model.mesh.topo} across {model.mesh.world} processes" \
        if isinstance(model.mesh, ProcessMesh) else f"{model.mesh}"
    on_island = f", MoE blocks on the island {where} ({cfg.wire_dtype} wire)" \
        if cfg.is_moe else ""
    replicas = "" if mesh is None else \
        f"; process {mesh.rank} of {world} ({mesh.backend}), rows {rows.start}:{rows.stop}"
    print(f"training {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype}, moments {cfg.opt_state_dtype}) on {model.device}{on_island}"
          f"{replicas}; bigram-entropy loss floor ~ {run.floor:.3f}")
    cuda = model.device.type == "cuda"
    for step in range(start_step, steps):
        host = step_batch(cfg, ds, step, batch)
        tb = to_device({k: v[rows] for k, v in host.items()}, model.device)
        t0 = time.time()
        clock = Clock(model.device)
        clock.mark()
        loss, grads = step_fn.loss_and_grad(tb)
        clock.mark()
        if mesh is not None:
            before = dict(mesh.stats)
            if cuda:
                torch.cuda.synchronize()
            t_ar = time.perf_counter()
            loss, grads = step_fn.all_reduce(loss, grads)
            if cuda:
                torch.cuda.synchronize()
            run.allreduce_wall_ms.append((time.perf_counter() - t_ar) * 1e3)
            run.sync_stats.append({k: v - before.get(k, 0) for k, v in mesh.stats.items()})
        clock.mark()
        if on_grads is not None:
            on_grads(step, model, tb, loss, grads)
        clock.mark()
        gnorm = step_fn.update(grads, opt_state)
        clock.mark()
        del grads
        loss = float(loss)
        run.detector.record("local", time.time() - t0)
        fwd_bwd, allreduce, _, update = clock.intervals_ms()
        run.losses.append(loss)
        run.grad_norms.append(float(gnorm))
        run.fwd_bwd_ms.append(fwd_bwd)
        run.update_ms.append(update)
        if mesh is not None:
            run.allreduce_ms.append(allreduce)
            run.digests.append(check_replicas(model, mesh, step))
        if step % log_every == 0 or step == steps - 1:
            sync = "" if mesh is None else f" + all-reduce {allreduce:.1f}"
            print(f"step {step:5d}  loss {loss:.4f}  grad norm "
                  f"{run.grad_norms[-1]:.4f}  ({fwd_bwd + update:.1f}{sync} ms)")
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            _first_writes(mesh, lambda: mgr.save(step + 1, (model.param_tree(), opt_state),
                                                 extra={"step": step + 1}))
    if mgr and steps > start_step and ckpt_every and steps % ckpt_every == 0:
        _first_writes(mesh, mgr.wait)   # the last step's checkpoint is the one just saved
    elif mgr:
        _first_writes(mesh, lambda: mgr.save(steps, (model.param_tree(), opt_state),
                                             extra={"step": steps}, block=True))
    return run


def main(argv: Optional[Union[Sequence[str], str]] = None, *more: str) -> TrainRun:
    """The command line; ``launch("repro_torch.launch.train:main", n,
    args=[...])`` passes the arguments one by one.  Attaches to the
    launcher's job when its environment is set: the job's processes are
    the data axis."""
    if isinstance(argv, str):
        argv = [argv, *more]
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
    # a no-op outside the launcher's job; a job it joins here it leaves
    attached = not dist.is_initialized() and attach(verbose=True)["attached"]
    world = process_count()
    try:
        run = train(cfg.replace(grad_accum=1), steps=args.steps, batch=args.batch,
                    seq=args.seq, lr=args.lr, seed=args.seed, device=args.device,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    resume=args.resume, log_every=args.log_every,
                    mesh=mesh_for(Topology(world, 1)) if world > 1 else None)
    finally:
        if attached:
            detach()
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
