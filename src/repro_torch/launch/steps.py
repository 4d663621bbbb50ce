"""The port's training step: the loss with gradient accumulation, then the
AdamW update (``repro/launch/steps.py``'s ``adamw_config_for``,
``make_loss_with_accum`` and ``make_train_step``), and the dry run's
cells: the sharding specs of a cell's state (``opt_state_spec_tree``,
``batch_specs_for``), its inputs, its per-device budgets and its
program (``build_cell``, ``count_cell``).

The reference's step is a pure jitted function of ``(params, opt_state,
batch)``.  Here the step works on the model's own weights (any model
``build_model`` returns: ``LM``, ``ZambaModel``, ``WhisperModel``, whose
batch carries ``frames``): the gradients
come from ``torch.autograd.grad`` (nothing accumulates in ``.grad``), and
the update writes the weights and the optimizer state in place.

Across the processes of a ``torch.distributed`` job the step is the
reference driver's ``data`` axis: one replica of the model a process, the
global batch split by rows.  ``make_train_step(model, opt_cfg, mesh=)``
takes the job's :class:`~repro_torch.mesh.buffers.ProcessMesh` over
``Topology(world, 1)`` (one rank a process): each process scales its
loss to its share of the global mean (shard rows / global rows), so the
sum over the processes is the global loss and gradient; ``all_reduce``
sums them with :func:`~repro_torch.core.hier_collectives.flat_psum_tree`
(GSPMD's data-axis psum: the float32 bucket reduce-scattered, each chunk
folded once in rank order, then all-gathered, so every process holds
the same bits, each leaf cast back to its dtype once), and the same
AdamW update follows on every process.  In one process (no mesh, or a
world of 1) nothing is scaled or reduced.

A cell is one (arch x shape x mesh) of the dry run.  The reference lowers
its program for a TPU mesh and reads the HLO; here ``build_cell`` builds
the model and its inputs on ``meta`` (no memory: any cell fits) or on a
real device, and ``count_cell`` runs the program once under
:func:`repro_torch.core.op_analysis.count_ops`: a train step with its
``grad_accum`` microbatches, ``prefill``, or one ``decode_step`` against
an S-token cache.  The MoE archs run their blocks through the
expert-parallel island over the mesh's EP axes (``Topology(pods,
model)``); on one card over the one-chip island, as the training driver
does.  ``analytic_gb`` holds the reference's per-device budgets, from the
same specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core import op_analysis
from repro_torch.core.hier_collectives import flat_psum_tree
from repro_torch.core.topology import Topology
from repro_torch.mesh.buffers import ProcessMesh
from repro_torch.models import partitioning as part
from repro_torch.models.common import dtype_of
from repro_torch.models.params import TreeModel
from repro_torch.moe.dispatch import EPInfo, check_island_batch, island_pods
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves_with_path, tree_map)

Batch = Dict[str, torch.Tensor]


def adamw_config_for(cfg) -> AdamWConfig:
    return AdamWConfig(state_dtype=cfg.opt_state_dtype,
                       master_fp32=cfg.opt_master_fp32)


def make_loss_with_accum(model: TreeModel, share: float = 1.0
                         ) -> Callable[[Batch], Tuple[torch.Tensor, Any]]:
    """``loss_and_grad(batch) -> (loss, grads)`` over the global batch,
    with ``cfg.grad_accum`` microbatches: each microbatch's grads are
    summed into float32 buffers (as the reference's scan does; summing into
    bf16 would round at every microbatch), then the sums and the loss are
    scaled by 1 / A.  With one microbatch the grads keep the weights'
    dtype.  ``grads`` is a tree shaped like ``model.param_tree()``.  Every
    key of the batch splits along its first axis (whisper's ``frames``
    with its tokens).  On the island each microbatch must split over the
    pods this process runs; a batch that does not raises before any
    compute.  ``share`` (a data-parallel process's rows over the global
    batch's) scales the loss before the backward with one microbatch, the
    mean of the microbatches after it with more."""
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
            if share != 1.0:
                loss = loss * share
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
        for buf in acc:
            buf.mul_(inv)
            if share != 1.0:
                buf.mul_(share)
        loss_acc = loss_acc * inv
        if share != 1.0:
            loss_acc = loss_acc * share
        grads = iter(acc)
        return loss_acc, tree_map(lambda _: next(grads), params)

    return loss_and_grad


class TrainStep:
    """``step(opt_state, batch) -> (loss, grad_norm)``: one training step
    that updates ``model``'s weights and ``opt_state`` in place.  Its
    parts, ``loss_and_grad(batch)``, ``all_reduce(loss, grads)`` and
    ``update(grads, opt_state)``, are there for a caller that times them
    apart.  With ``mesh`` (the job's data axis, module docstring) ``batch``
    is this process's rows of the global batch and ``all_reduce`` returns
    the global loss and gradient; without one it returns its arguments."""

    def __init__(self, model: TreeModel, opt_cfg: AdamWConfig,
                 mesh: Optional[ProcessMesh] = None):
        if mesh is not None and mesh.topo.n_procs != mesh.world:
            raise ValueError(f"the data axis takes one rank a process: a mesh over "
                             f"Topology({mesh.world}, 1), not {mesh.topo}")
        self.model = model
        self.opt_cfg = opt_cfg
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.loss_and_grad = make_loss_with_accum(
            model, 1.0 if self.mesh is None else 1.0 / self.mesh.world)

    def all_reduce(self, loss: torch.Tensor, grads) -> Tuple[torch.Tensor, Any]:
        """The sum over the job's processes of ``loss`` and every leaf of
        ``grads``, in one float32 bucket; the same bits on every process."""
        if self.mesh is None:
            return loss, grads
        tree = {"grads": tree_map(lambda g: g[None], grads), "loss": loss[None]}
        out = flat_psum_tree(tree, self.mesh.topo, self.mesh, device=loss.device)
        return out["loss"][0], tree_map(lambda g: g[0], out["grads"])

    def update(self, grads, opt_state: Dict) -> torch.Tensor:
        return adamw_update(grads, self.model.param_tree(), opt_state,
                            self.opt_cfg)

    def __call__(self, opt_state: Dict, batch: Batch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        loss, grads = self.all_reduce(*self.loss_and_grad(batch))
        return loss, self.update(grads, opt_state)


def make_train_step(model: TreeModel, opt_cfg: AdamWConfig,
                    mesh: Optional[ProcessMesh] = None) -> TrainStep:
    return TrainStep(model, opt_cfg, mesh)


# ---------------------------------------------------------------------------
# shardings of a cell's state
# ---------------------------------------------------------------------------

def _map_specs(fn, spec_tree, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(spec_tree, part.P):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, spec_tree[k], *(t[k] for t in trees))
                for k in spec_tree}
    return type(spec_tree)(_map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(spec_tree))


def opt_state_spec_tree(cfg, params_shape, multi_pod: bool,
                        state_shape=None, axis_sizes=None):
    """Specs for the AdamW state: ZeRO-3 (all-DP) sharded moments and
    masters.  int8 states: the codes ``q`` shard like the parameter; the
    per-block scales (``s``; ``lo`` and ``st``), of the same rank with the
    last dim the block count, take the same spec guarded on their own
    shapes (blocks run along the last axis, so this stays sharding-stable)."""
    z3 = part.param_specs(cfg, params_shape, multi_pod, zero3=True,
                          axis_sizes=axis_sizes)

    def q8(keys, states):
        if states is None:
            return _map_specs(lambda sp: {k: sp if k == "q" else part.P() for k in keys}, z3)
        return _map_specs(lambda sp, st: {k: part._guard(sp, st[k].shape, axis_sizes)
                                          for k in keys}, z3, states)

    if cfg.opt_state_dtype == "int8":
        m_spec = q8(("q", "s"), state_shape["m"] if state_shape is not None else None)
        v_spec = q8(("q", "lo", "st"), state_shape["v"] if state_shape is not None else None)
    else:
        m_spec = v_spec = z3
    state = {"step": part.P(), "m": m_spec, "v": v_spec}
    has_master = (cfg.opt_master_fp32 if state_shape is None
                  else "master" in state_shape)
    if has_master:
        state["master"] = z3
    return state


def batch_specs_for(cfg, shape: ShapeSpec, multi_pod: bool, mesh) -> Dict:
    from repro_torch.launch.mesh import dp_size
    dp = dp_size(mesh)
    bspec = part.batch_spec(multi_pod) if shape.global_batch >= dp else part.P()
    specs = {"tokens": bspec, "labels": bspec}
    if cfg.is_encoder_decoder:
        specs["frames"] = (part.frames_spec(multi_pod) if shape.global_batch >= dp
                           else part.P(None, None, None))
    return specs


def input_specs(cfg, shape: ShapeSpec, device="meta") -> Dict[str, torch.Tensor]:
    """Every model input of the cell, as tensors on ``device`` (meta: no
    memory, the reference's ``ShapeDtypeStruct`` stand-ins)."""
    b, s = shape.global_batch, shape.seq_len
    tok = lambda shp: torch.zeros(shp, dtype=torch.int32, device=device)  # noqa: E731
    if shape.kind in ("train", "prefill"):
        out = {"tokens": tok((b, s))}
        if shape.kind == "train":
            out["labels"] = tok((b, s))
        if cfg.is_encoder_decoder:
            out["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                        dtype=torch.float32, device=device)
        return out
    return {"tokens": tok((b, 1))}     # decode: one token against the cache


# ---------------------------------------------------------------------------
# cells of the dry run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) of the dry run: ``run()`` runs its program
    once on the model's device."""
    run: Callable[[], Any]
    kind: str
    tokens: int             # tokens one run processes (for MODEL_FLOPS)
    n_active_params: int
    analytic_gb: Dict = dataclasses.field(default_factory=dict)
    island: Optional[str] = None    # the MoE blocks' island, when they have one


def _sharded_gb(shape_tree, spec_tree, axis_sizes) -> float:
    """Per-device GB of a tree under its specs."""
    total = 0.0
    for _, leaf, spec in part.leaf_specs(shape_tree, spec_tree):
        n = 1
        for s in leaf.shape:
            n *= int(s)
        total += n * leaf.element_size() / part.spec_divisor(spec, axis_sizes)
    return total / 1e9


def island_of(cfg, mesh) -> Tuple[Optional[Topology], Optional[EPInfo]]:
    """The MoE blocks' island over ``mesh``'s EP axes (pod, model): one pod
    of ``model`` chips, or ``pod`` pods of them; on one chip the training
    driver's ``Topology(1, 1)``.  Other archs: none."""
    if not cfg.is_moe:
        return None, None
    sizes = mesh.shape
    if "pod" in sizes:
        return Topology(sizes["pod"], sizes.get("model", 1)), EPInfo("model", "pod")
    return Topology(1, sizes.get("model", 1)), EPInfo("model", None)


def build_cell(arch: str, shape_name: str, mesh, multi_pod: Optional[bool] = None,
               overrides: Optional[Dict] = None, device="meta") -> Cell:
    """The cell's model, inputs and state on ``device`` and its per-device
    budgets on ``mesh`` (a :class:`repro_torch.launch.mesh.ProductionMesh`
    or anything with a ``.shape`` dict), as the reference's ``build_cell``
    assembles them."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import dp_size
    from repro_torch.models.registry import (build_model, count_active_params,
                                             param_shapes)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    axis_sizes = dict(mesh.shape)
    if multi_pod is None:
        multi_pod = "pod" in axis_sizes
    topo, ep = island_of(cfg, mesh)
    model = build_model(cfg, device, mesh=topo, ep=ep, shard_mesh=mesh)
    pshape = param_shapes(model)
    if torch.device(device).type == "meta":
        model.load(pshape)
    else:
        model.init(0)
    pspec = part.param_specs(cfg, pshape, multi_pod, axis_sizes=axis_sizes)
    params_gb = _sharded_gb(pshape, pspec, axis_sizes)
    n_active = count_active_params(model)
    island = None if topo is None else f"Topology({topo.n_nodes}, {topo.ppn})"
    b, s = shape.global_batch, shape.seq_len
    inputs = input_specs(cfg, shape, device)

    if shape.kind == "train":
        opt_cfg = adamw_config_for(cfg)
        state = adamw_init(model.param_tree(), opt_cfg)
        oshape = dict(adamw_init(pshape, opt_cfg))
        # the state's step is a host int here, the reference's an int32 scalar
        oshape["step"] = torch.zeros((), dtype=torch.int32, device="meta")
        ospec = opt_state_spec_tree(cfg, pshape, multi_pod, oshape, axis_sizes)
        opt_gb = _sharded_gb(oshape, ospec, axis_sizes)
        # fp32 grads live at param sharding during the update
        grads_gb = params_gb * (4 / torch.empty((), dtype=dtype_of(cfg)).element_size())
        # remat residuals: one hidden a layer a microbatch, seq-sharded
        act = (cfg.n_layers * (b // max(cfg.grad_accum, 1)) * s * cfg.d_model * 2
               / (dp_size(mesh) * mesh.shape.get("model", 1))) / 1e9
        step = make_train_step(model, opt_cfg)
        return Cell(run=lambda: step(state, inputs), kind="train", tokens=b * s,
                    n_active_params=n_active, island=island,
                    analytic_gb={"params": params_gb, "opt": opt_gb,
                                 "grads": grads_gb, "residuals": act,
                                 "total": params_gb + opt_gb + grads_gb + act})

    cache_shape = model.init_cache(b, s)
    cspec = part.cache_specs(cfg, cache_shape, multi_pod, axis_sizes=axis_sizes)
    cache_gb = _sharded_gb(cache_shape, cspec, axis_sizes)
    analytic = {"params": params_gb, "cache": cache_gb, "total": params_gb + cache_gb}
    if shape.kind == "prefill":
        args = (inputs["tokens"], inputs["frames"]) if cfg.is_encoder_decoder \
            else (inputs["tokens"],)
        return Cell(run=lambda: model.prefill(*args), kind="prefill", tokens=b * s,
                    n_active_params=n_active, analytic_gb=analytic, island=island)

    # decode: one new token at position S - 1 of an S-token cache
    cache_shape["length"] = torch.full((b,), s - 1, dtype=torch.int32,
                                       device=cache_shape["length"].device)
    cache_shape["pos"] = s - 1
    return Cell(run=lambda: model.decode_step(cache_shape, inputs["tokens"]),
                kind="decode", tokens=b, n_active_params=n_active,
                analytic_gb=analytic, island=island)


def count_cell(cell: Cell) -> op_analysis.OpCost:
    """The operators, kernels' declared work and exchanges of one run of
    the cell's program (the counterpart of lowering it and reading its
    HLO)."""
    with op_analysis.count_ops() as cost:
        cell.run()
    return cost
