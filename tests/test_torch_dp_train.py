"""Data-parallel training across the processes of a job, on the CPU.

One job of two gloo processes (this file re-entered as ``child``) trains
every family the port trains through ``repro_torch.launch.train.train``
with ``mesh=`` the job's data axis: reduced gemma2-2b (float32 and int8
moments), qwen3-moe (a one-chip island a replica), whisper-small,
zamba2-2.7b and rwkv6-3b, and qwen3-moe and deepseek-v2 on the island
over ``Topology(2, 2)`` across the two processes (flat and nap, f32
wire).  Each case resumes from a checkpoint this process wrote from the
reference's state after two of its steps (``params_from_jax`` /
``opt_state_from_jax``: a one-process checkpoint resumed by two) and takes
three steps, held against the reference's ``make_train_step`` on the
whole global batch: losses rtol 1e-4, parameters as
``test_torch_train.py`` holds them (within 2 lr steps, 99% of each leaf
within 1e-6 of max |p|).  The two processes' parameter digests agree after every
step, and every step sends the other process the bucket's arithmetic.

Checkpoints of a job: process 0 alone writes; a checkpoint of the
uninterrupted two-process run resumed in one process reaches its step 3
within the same tolerance.  A world of one is bit-equal to the plain
driver, a batch that does not split over the world raises before any
compute, and a failed ``attach`` under the launcher's environment ends
the job non-zero.
"""
import json
import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.core.topology import Topology
from repro_torch.launch import train
from repro_torch.mesh.buffers import ProcessMesh
from repro_torch.models import build_model
from repro_torch.models.convert import (LAYER_GROUPS, opt_state_from_jax,
                                        params_from_jax)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_at, tree_leaves_with_path

N_PROC = 2
BATCH, SEQ, LR, SEED = 4, 32, 3e-3, 3
WARM, STEPS = 2, 5              # the reference's steps before the job's three
# the MoE cases' capacity holds every copy (no drop), so the island is
# the reference's local MoE layer
MOE = dict(wire_dtype="f32", capacity_factor=8.0)
CASES = {
    "gemma2-2b-float32": ("gemma2-2b", {}, False),
    "gemma2-2b-int8": ("gemma2-2b", dict(opt_state_dtype="int8"), False),
    "qwen3-moe-replicas": ("qwen3-moe-235b-a22b", MOE, False),
    "whisper-small": ("whisper-small", {}, False),
    "zamba2-2.7b": ("zamba2-2.7b", {}, False),
    "rwkv6-3b": ("rwkv6-3b", {}, False),
} | {f"{arch.split('-')[0]}-island-{mode}": (arch, dict(MOE, moe_dispatch=mode), True)
     for arch in ("qwen3-moe-235b-a22b", "deepseek-v2-236b") for mode in ("flat", "nap")}
CKPT_ARCH = "gemma2-2b"
ISLAND_TOPO = (2, 2)
WAIT_S = 600


def port_cfg(case):
    arch, over, _ = CASES[case]
    return get_reduced(arch).replace(grad_accum=1, **over)


def opt_cfg(cfg, steps=STEPS):
    return AdamWConfig(lr=LR, total_steps=steps, warmup_steps=max(steps // 20, 1),
                       state_dtype=cfg.opt_state_dtype, master_fp32=cfg.opt_master_fp32)


def params_close(got, want_at, steps, what):
    """``test_torch_train.py``'s rule for parameters after ``steps``
    steps: every element within 2 lr steps of the reference's (AdamW moves
    an element by about +-lr wherever its gradient sits at round-off
    level), and at least 99% of each leaf's within 1e-6 of the largest
    |p| (``want_at(path)`` is the reference's leaf)."""
    leaves = [(path, np.asarray(p, np.float32), want_at(path))
              for path, p in tree_leaves_with_path(got)]
    assert leaves, what
    scale = max(float(np.abs(w).max()) for _, _, w in leaves)
    for path, p, w in leaves:
        diff = np.abs(p - w)
        assert diff.max() <= 2 * LR * steps, (what, path, diff.max())
        assert (diff <= 1e-6 * scale).mean() >= 0.99, \
            (what, path, (diff > 1e-6 * scale).mean())


def stacked(tree_j, path):
    if path[0] in LAYER_GROUPS:
        return np.asarray(tree_at(tree_j[path[0]], path[2:])[path[1]], np.float32)
    return np.asarray(tree_at(tree_j, path), np.float32)


def saved_params(directory, cfg, step):
    model = build_model(cfg, device="cpu").init(0)
    (params, _), extra = load_checkpoint(
        str(directory), step, target=(model.param_tree(),
                                      adamw_init(model.param_tree(), opt_cfg(cfg))))
    assert extra == {"step": step}
    return params


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------

def child(spec_file):
    """One process of the job: the uninterrupted checkpoint run, then every
    case once its checkpoint is ready; what it saw as JSON."""
    import repro_torch.checkpoint.store as store
    from repro_torch.mesh import attach, detach, mesh_for
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_file).read_text())
    pid = attach(verbose=True)["process_id"]
    data = mesh_for(Topology(N_PROC, 1))
    saves, write = [], store.save_checkpoint

    def counted(directory, step, *args, **kw):
        saves.append([Path(directory).name, step])
        return write(directory, step, *args, **kw)

    store.save_checkpoint = counted
    out = {}
    run = train.train(get_reduced(CKPT_ARCH).replace(grad_accum=1), steps=3, batch=BATCH,
                      seq=SEQ, lr=LR, seed=SEED, device="cpu", ckpt_dir=spec["ckpt"],
                      ckpt_every=2, mesh=data)
    out["ckpt"] = dict(losses=run.losses, digests=run.digests)
    for case in CASES:
        case_dir = Path(spec["cases"]) / case
        deadline = time.monotonic() + WAIT_S
        while not (case_dir / "ready").exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"{case}: no checkpoint after {WAIT_S} s")
            time.sleep(0.1)
        island = mesh_for(Topology(*ISLAND_TOPO)) if CASES[case][2] else None
        run = train.train(port_cfg(case), steps=STEPS, batch=BATCH, seq=SEQ, lr=LR,
                          seed=SEED, device="cpu", ckpt_dir=str(case_dir), ckpt_every=0,
                          resume=True, log_every=1, mesh=data, island=island)
        out[case] = dict(start=run.start_step, losses=run.losses, digests=run.digests,
                         sent=[st["sent_bytes_nodexproc"] for st in run.sync_stats],
                         island_grad_bytes=0 if island is None else
                         island.stats.get("sent_bytes_nodexproc:tokens:grad", 0))
    out["saves"] = saves
    (Path(spec["out"]) / f"out_{pid}.json").write_text(json.dumps(out))
    detach()
    print(f"CHILD {pid} OK", flush=True)


def reference_key(case):
    """What the reference's run of a case depends on: its local MoE layer
    is the same for every dispatch mode."""
    arch, over, _ = CASES[case]
    return arch, tuple(sorted((k, v) for k, v in over.items() if k != "moe_dispatch"))


def reference_case(case, case_dirs):
    """The reference's two warm steps, written as a port checkpoint at step
    2 into each of ``case_dirs`` for the job; then its three more steps on
    the global batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.data import SyntheticLM as JaxSyntheticLM
    from repro.launch.steps import make_train_step as jax_train_step
    from repro.models import build_model as jax_build
    from repro.optim import AdamWConfig as JaxAdamWConfig
    from repro.optim import adamw_init as jax_adamw_init

    arch, over, _ = CASES[case]
    cfg = port_cfg(case)
    jm = jax_build(jax_reduced(arch).replace(grad_accum=1, **over))
    o = opt_cfg(cfg)
    jcfg = JaxAdamWConfig(lr=o.lr, total_steps=o.total_steps, warmup_steps=o.warmup_steps,
                          state_dtype=o.state_dtype, master_fp32=o.master_fp32)
    step = jax.jit(jax_train_step(jm, jcfg))
    params = jm.init(jax.random.key(SEED))
    state = jax_adamw_init(params, jcfg)
    ds = JaxSyntheticLM(jm.cfg.vocab, SEQ, seed=SEED)
    losses = []
    for s in range(STEPS):
        if s == WARM:
            host_p, host_s = jax.device_get(params), jax.device_get(state)
            pm = build_model(cfg, device="cpu").load(params_from_jax(host_p))
            for case_dir in case_dirs:
                CheckpointManager(str(case_dir)).save(
                    WARM, (pm.param_tree(), opt_state_from_jax(host_s)),
                    extra={"step": WARM}, block=True)
                (case_dir / "ready").touch()
        batch = {k: jnp.asarray(v) for k, v in train.step_batch(cfg, ds, s, BATCH).items()}
        loss, params, state = step(params, state, batch)
        losses.append(float(loss))
    return losses[WARM:], jax.device_get(params)


@pytest.fixture(scope="module")
def dp_job(tmp_path_factory):
    """The job, started first; this process writes each case's checkpoint
    as the reference reaches it, while the job runs the cases before it."""
    from repro_torch.mesh import launch
    root = tmp_path_factory.mktemp("dp_train")
    spec = {"out": str(root), "ckpt": str(root / "ckpt"), "cases": str(root / "cases")}
    for case in CASES:
        (root / "cases" / case).mkdir(parents=True)
    spec_file = root / "spec.json"
    spec_file.write_text(json.dumps(spec))
    job = {}

    def run():
        try:
            job["res"] = launch(__file__, N_PROC, args=["child", str(spec_file)],
                                local_devices=1, timeout_s=WAIT_S,
                                env={"JAX_PLATFORMS": "cpu", "REPRO_MESH_BACKEND": "gloo"})
        except BaseException as e:      # raised again below, in the test's thread
            job["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    ref = {}
    try:
        for case in CASES:
            if case not in ref:
                group = [c for c in CASES if reference_key(c) == reference_key(case)]
                out = reference_case(case, [root / "cases" / c for c in group])
                ref.update({c: out for c in group})
    finally:
        thread.join()
    if "err" in job:
        raise job["err"]
    outs = []
    for pid in range(N_PROC):
        assert f"CHILD {pid} OK" in job["res"].output(pid), job["res"].output(pid)
        outs.append(json.loads((root / f"out_{pid}.json").read_text()))
    return dict(root=root, ref=ref, outs=outs)


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_match_reference(dp_job, case):
    """Three data-parallel steps against the reference's one-device steps
    on the global batch; the replicas agree bit for bit after each."""
    want_losses, want_params = dp_job["ref"][case]
    got = [o[case] for o in dp_job["outs"]]
    assert all(g["start"] == WARM for g in got)
    for g in got:       # every process prints and keeps the global losses
        np.testing.assert_allclose(g["losses"], want_losses, rtol=1e-4)
    assert got[0]["losses"] == got[1]["losses"]
    assert len(got[0]["digests"]) == STEPS - WARM
    assert got[0]["digests"] == got[1]["digests"]
    cfg = port_cfg(case)
    params = saved_params(dp_job["root"] / "cases" / case, cfg, STEPS)
    params_close(params, lambda path: stacked(want_params, path), STEPS - WARM, case)
    # each step's reduce-scatter and all-gather send the other process
    # half the float32 bucket (the gradient and the loss, padded to 2)
    n = sum(np.size(p) for _, p in tree_leaves_with_path(params)) + 1
    assert n > 1000
    for g in got:
        assert g["sent"] == [2 * 4 * ((n + 1) // 2)] * (STEPS - WARM)
    if CASES[case][2]:      # the island's backward crossed the processes
        assert all(g["island_grad_bytes"] > 0 for g in got)


def test_only_first_process_writes_checkpoints(dp_job):
    saves = [o["saves"] for o in dp_job["outs"]]
    assert saves[1] == []
    assert saves[0] == [["ckpt", 2], ["ckpt", 3]] + [[case, STEPS] for case in CASES]
    committed = sorted(p.name for p in (dp_job["root"] / "ckpt").glob("step_*")
                       if (p / "_COMMITTED").exists())
    assert committed == ["step_00000002", "step_00000003"]


def test_job_checkpoint_resumes_in_one_process(dp_job, tmp_path):
    """Step 2's checkpoint of the two-process run, resumed in one process,
    reaches the uninterrupted run's step 3."""
    job = dp_job["outs"][0]["ckpt"]
    shutil.copytree(dp_job["root"] / "ckpt", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_00000003")
    cfg = get_reduced(CKPT_ARCH).replace(grad_accum=1)
    resumed = train.train(cfg, steps=3, batch=BATCH, seq=SEQ, lr=LR, seed=SEED,
                          device="cpu", ckpt_dir=str(tmp_path / "b"), ckpt_every=2,
                          resume=True)
    assert resumed.start_step == 2 and resumed.digests == []
    np.testing.assert_allclose(resumed.losses, job["losses"][2:], rtol=1e-4)
    want = dict(tree_leaves_with_path(saved_params(dp_job["root"] / "ckpt", cfg, 3)))
    params_close(saved_params(tmp_path / "b", cfg, 3), want.__getitem__, 1, "resumed")


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------

def test_world_of_one_is_bit_equal_to_the_plain_driver():
    from repro_torch.mesh import mesh_for
    cfg = get_reduced("whisper-small").replace(grad_accum=1)
    kw = dict(steps=3, batch=BATCH, seq=SEQ, lr=LR, seed=SEED, device="cpu")
    plain = train.train(cfg, **kw)
    one = train.train(cfg, mesh=mesh_for(Topology(1, 1)), **kw)
    assert one.losses == plain.losses and one.grad_norms == plain.grad_norms
    assert one.step_fn.mesh is None and one.digests == one.sync_stats == []
    for (path, a), (_, b) in zip(tree_leaves_with_path(one.model.param_tree()),
                                 tree_leaves_with_path(plain.model.param_tree())):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("accum", [1, 2])
def test_loss_share_of_a_process(accum):
    """With the job's data axis each process's loss and gradient are its
    share of the global mean (rows / global rows: half of two), scaled
    after the microbatch mean with more than one."""
    from repro_torch.launch.steps import make_train_step
    cfg = get_reduced("gemma2-2b").replace(grad_accum=accum)
    model = build_model(cfg, device="cpu").init(SEED)
    mesh = ProcessMesh(topo=Topology(N_PROC, 1), world=N_PROC, rank=0, backend="gloo")
    batch = train.to_device(train.step_batch(cfg, train.SyntheticLM(cfg.vocab, SEQ, seed=SEED),
                                             0, BATCH), "cpu")
    whole_loss, whole = make_train_step(model, opt_cfg(cfg)).loss_and_grad(batch)
    loss, grads = make_train_step(model, opt_cfg(cfg), mesh).loss_and_grad(batch)
    assert torch.equal(loss, whole_loss * 0.5)
    for (path, g), (_, w) in zip(tree_leaves_with_path(grads), tree_leaves_with_path(whole)):
        assert torch.equal(g, w * 0.5), path


def test_batch_must_split_over_the_world(monkeypatch):
    def no_compute(*_, **__):
        raise AssertionError("the model was built")

    monkeypatch.setattr(train, "build_model", no_compute)
    mesh = ProcessMesh(topo=Topology(N_PROC, 1), world=N_PROC, rank=0, backend="gloo")
    with pytest.raises(ValueError, match="a global batch of 3 does not split over "
                                         "the 2 processes"):
        train.train(get_reduced("gemma2-2b"), steps=1, batch=3, seq=SEQ,
                    device="cpu", mesh=mesh)
    from repro_torch.launch.steps import make_train_step
    pods = ProcessMesh(topo=Topology(N_PROC, 2), world=N_PROC, rank=0, backend="gloo")
    with pytest.raises(ValueError, match="one rank a process"):
        make_train_step(None, AdamWConfig(), pods)


def test_failed_attach_ends_the_job():
    """``main`` under the launcher's environment with a backend that does
    not exist: every process exits non-zero, none trains alone."""
    from repro_torch.mesh import LaunchError, launch
    with pytest.raises(LaunchError, match="failed") as err:
        launch(train.__file__, N_PROC, args=["--arch", "gemma2-2b", "--device", "cpu",
                                             "--steps", "2"],
               env={"REPRO_MESH_BACKEND": "no-such-backend"}, timeout_s=120)
    assert "backend must be one of" in str(err.value)
    assert "training gemma2-2b" not in str(err.value)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "child":
        child(sys.argv[2])
    else:
        sys.exit("usage: test_torch_dp_train.py child SPEC (under launch())")
