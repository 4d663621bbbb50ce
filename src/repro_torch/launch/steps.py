"""The port's training step: the loss with gradient accumulation, then the
AdamW update (``repro/launch/steps.py``'s ``adamw_config_for``,
``make_loss_with_accum`` and ``make_train_step``).

The reference's step is a pure jitted function of ``(params, opt_state,
batch)``.  Here the step works on the model's own weights (any model
``build_model`` returns: ``LM``, ``ZambaModel``, ``WhisperModel``, whose
batch carries ``frames``): the gradients
come from ``torch.autograd.grad`` (nothing accumulates in ``.grad``), and
the update writes the weights and the optimizer state in place.  The
sharding and cell helpers of the reference's module serve its dry run
(ROADMAP Queue 1 item 7c).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.params import TreeModel
from repro_torch.moe.dispatch import check_island_batch, island_pods
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     tree_leaves_with_path, tree_map)

Batch = Dict[str, torch.Tensor]


def adamw_config_for(cfg) -> AdamWConfig:
    return AdamWConfig(state_dtype=cfg.opt_state_dtype,
                       master_fp32=cfg.opt_master_fp32)


def make_loss_with_accum(model: TreeModel) -> Callable[[Batch], Tuple[torch.Tensor, Any]]:
    """``loss_and_grad(batch) -> (loss, grads)`` over the global batch,
    with ``cfg.grad_accum`` microbatches: each microbatch's grads are
    summed into float32 buffers (as the reference's scan does; summing into
    bf16 would round at every microbatch), then the sums and the loss are
    scaled by 1 / A.  With one microbatch the grads keep the weights'
    dtype.  ``grads`` is a tree shaped like ``model.param_tree()``.  Every
    key of the batch splits along its first axis (whisper's ``frames``
    with its tokens).  On the island each microbatch must split over the
    pods this process runs; a batch that does not raises before any
    compute."""
    a = model.cfg.grad_accum

    def loss_and_grad(batch: Batch):
        params = model.param_tree()
        leaves = [p for _, p in tree_leaves_with_path(params)]
        b = batch["tokens"].shape[0]
        if a > 1 and b % a:
            raise ValueError(f"a batch of {b} does not split into grad_accum "
                             f"= {a} microbatches")
        if model.mesh is not None and model.cfg.is_moe:
            check_island_batch(b // max(a, 1), island_pods(model.mesh, model.ep))
        if a <= 1:
            loss = model.loss(batch)
            grads = iter(torch.autograd.grad(loss, leaves))
            return loss.detach(), tree_map(lambda _: next(grads), params)
        micro = {k: v.reshape(a, v.shape[0] // a, *v.shape[1:])
                 for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(a):
            loss = model.loss({k: v[i] for k, v in micro.items()})
            for buf, g in zip(acc, torch.autograd.grad(loss, leaves)):
                buf.add_(g)
            loss_acc = loss_acc + loss.detach()
        inv = 1.0 / a
        grads = iter(buf.mul_(inv) for buf in acc)
        return loss_acc * inv, tree_map(lambda _: next(grads), params)

    return loss_and_grad


class TrainStep:
    """``step(opt_state, batch) -> (loss, grad_norm)``: one training step
    that updates ``model``'s weights and ``opt_state`` in place.  Its two
    halves, ``loss_and_grad(batch)`` and ``update(grads, opt_state)``, are
    there for a caller that times them apart."""

    def __init__(self, model: TreeModel, opt_cfg: AdamWConfig):
        self.model = model
        self.opt_cfg = opt_cfg
        self.loss_and_grad = make_loss_with_accum(model)

    def update(self, grads, opt_state: Dict) -> torch.Tensor:
        return adamw_update(grads, self.model.param_tree(), opt_state,
                            self.opt_cfg)

    def __call__(self, opt_state: Dict, batch: Batch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        loss, grads = self.loss_and_grad(batch)
        return loss, self.update(grads, opt_state)


def make_train_step(model: TreeModel, opt_cfg: AdamWConfig) -> TrainStep:
    return TrainStep(model, opt_cfg)
