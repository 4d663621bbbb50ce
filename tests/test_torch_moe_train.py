"""Training the MoE LMs through the port's expert-parallel island, on the CPU.

* the island LM's gradients (``build_model(cfg, mesh=Topology(2, 2))``)
  against the local LM's on the same weights and batch, every leaf within
  1e-5 of that leaf's max |grad|, for both MoE archs and ``flat`` /
  ``nap`` on the f32 wire; a remat recompute records no island stats;
* the island's gradient against the reference's ``jax.grad`` of
  ``(moe_apply_sharded(...) ** 2).sum()`` on a forced 8-device host mesh
  (2, 4), run once in a subprocess (``tests/test_torch_moe.py``'s inputs),
  for ``flat`` / ``nap`` / ``auto`` at capacity factors 0.25 (copies
  drop), 1.0 and 8.0, with and without a shared expert: rtol 1e-5 / atol
  1e-6 on every leaf and on ``x``;
* narrow wires: the reference's gradient through a ``bf16`` wire is zero
  on every island leaf (its bitcast), and the port raises under grad;
* the exchanges' adjoints: each is its own inverse, checked by
  ``gradcheck`` in float64 and by the vector-Jacobian product equal to
  the exchange of the vector; backward bytes counted under ``:grad``;
* ``make_train_step`` on the island against the local LM (float32 and
  int8 moments, ``grad_accum`` 1 and 2), a microbatch that does not split
  over the pods raising before any compute, and the driver's MoE path
  (a one-chip island) on the CPU;
* two gloo processes (this file re-entered as ``child``), one pod a
  process on Topology(2, 2): each process's gradients of its batch
  shard's share of the loss, summed, equal one process's within 1e-6 of
  each leaf's max.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.topology import Topology
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.moe.dispatch import EPInfo
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v2-236b"]
LM_TOPO = (2, 2)
LM_BATCH = (4, 16)
GRAD_MODES = ("flat", "nap", "auto")
GRAD_CFS = (0.25, 1.0, 8.0)
N_PROC = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models' ops are tiny: one intra-op thread, so that the
    test workers running beside this module do not oversubscribe the
    cores (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lm_cfg(arch, mode, **kw):
    return get_reduced(arch).replace(**dict(
        dict(moe_dispatch=mode, wire_dtype="f32", capacity_factor=4.0), **kw))


def lm_batch(vocab):
    return {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
                0, vocab, LM_BATCH)),
            "labels": torch.from_numpy(np.random.default_rng(2).integers(
                0, vocab, LM_BATCH))}


def lm_pair(cfg, mesh=Topology(*LM_TOPO)):
    """(local LM, island LM) on the same weights drawn from seed 9."""
    local = build_model(cfg, device="cpu").init(9)
    island = build_model(cfg, device="cpu", mesh=mesh)
    island.load(local.param_tree())
    return local, island


def loss_and_grads(model, batch, scale=1.0):
    """``scale`` x the loss and every leaf's gradient of it, by path (None
    where the leaf gets none)."""
    leaves = list(tree_leaves_with_path(model.param_tree()))
    loss = model.loss(batch) * scale
    grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
    return loss.detach(), {path: g for (path, _), g in zip(leaves, grads)}


def assert_grads_close(got, want, rel, what):
    assert set(got) == set(want)
    missing = [p for p, g in got.items() if g is None]
    assert not missing, f"{what}: {len(missing)} leaves get no gradient: {missing[:4]}"
    for path, w in want.items():
        scale = float(w.abs().max())
        err = float((got[path] - w).abs().max())
        assert err <= rel * scale, (what, path, err, scale)


# ---------------------------------------------------------------------------
# the island LM's gradients against the local LM's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["flat", "nap"])
@pytest.mark.parametrize("arch", ARCHS)
def test_island_lm_grads_match_local(arch, mode):
    cfg = lm_cfg(arch, mode)
    local, island = lm_pair(cfg)
    island.moe_stats = []
    batch = lm_batch(cfg.vocab)
    want_loss, want = loss_and_grads(local, batch)
    got_loss, got = loss_and_grads(island, batch)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    assert_grads_close(got, want, 1e-5, f"{arch} {mode}")
    assert island.moe_stats and all(
        v == 0 for st in island.moe_stats for v in st["dropped"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_island_records_once(arch):
    """With remat the backward runs the island again; ``moe_stats`` holds
    the forward's calls only, and the grads equal those without remat."""
    out = []
    for remat in (False, True):
        _, island = lm_pair(lm_cfg(arch, "nap", remat=remat))
        island.moe_stats = []
        out.append(loss_and_grads(island, lm_batch(island.cfg.vocab)))
        n_moe = island.cfg.n_layers - island.cfg.first_dense_layers
        assert len(island.moe_stats) == n_moe
    assert torch.equal(out[0][0], out[1][0])
    for path, g in out[0][1].items():
        assert torch.equal(out[1][1][path], g), path


# ---------------------------------------------------------------------------
# the island's gradient against the reference's jax.grad
# ---------------------------------------------------------------------------

_REFERENCE_GRADS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path.insert(0, sys.argv[2])
    import test_torch_moe as t
    import test_torch_moe_train as tt
    from repro.compat import make_mesh, set_mesh
    from repro.models.moe import EPInfo, moe_apply_sharded, moe_init
    mesh = make_mesh(t.ISLAND_MESH, ("pod", "model"))
    ep = EPInfo(inner_axis="model", pod_axis="pod")
    x = jnp.asarray(t.island_x())
    out = {}
    runs = [(s, cf, m, "f32") for s in (0, 1) for cf in tt.GRAD_CFS
            for m in tt.GRAD_MODES] + [(0, 8.0, m, "bf16") for m in ("flat", "nap")]
    for shared, cf, mode, wd in runs:
        cfg = t.island_cfg("ref", n_shared_experts=shared, capacity_factor=cf,
                           moe_dispatch=mode, wire_dtype=wd)
        params = moe_init(jax.random.key(0), cfg, jnp.float32)
        def loss(p, xx):
            return (moe_apply_sharded(p, cfg, xx, ep, mesh) ** 2).sum()
        with set_mesh(mesh):
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
        key = f"{shared}/{cf}/{mode}/{wd}"
        out[key + "/x"] = np.asarray(gx)
        for k, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
            out[key + "/" + "/".join(p.key for p in k)] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")

GRAD_RUNS = [(s, cf, m) for s in (0, 1) for cf in GRAD_CFS for m in GRAD_MODES]


@pytest.fixture(scope="module")
def reference_grads(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_grad_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_GRADS, str(out),
                           str(ROOT / "tests")], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def ref_tree(arrays, key):
    """The reference's gradient (or weight) tree under ``key`` as nested
    dicts of numpy arrays."""
    tree = {}
    for k, v in arrays.items():
        if not k.startswith(key + "/") or k == key + "/x":
            continue
        *path, leaf = k[len(key) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def island_inputs(shared, **kw):
    """(cfg, the reference's weights for it as the port's trainable tree,
    x requiring grad): ``test_torch_moe``'s island inputs."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import moe_init
    from test_torch_moe import island_cfg, island_x
    from repro_torch.models.convert import moe_params_from_jax
    cfg = island_cfg(n_shared_experts=shared, **kw)
    tree = jax.device_get(moe_init(jax.random.key(0), island_cfg(
        "ref", n_shared_experts=shared, **kw), jnp.float32))
    p = moe_params_from_jax(tree)
    for _, t in tree_leaves_with_path(p):
        t.requires_grad_(True)
    return cfg, p, torch.from_numpy(island_x()).requires_grad_(True)


def island_grads(cfg, p, x, topo=(2, 4)):
    from repro_torch.moe.dispatch import moe_apply_sharded
    leaves = list(tree_leaves_with_path(p))
    loss = (moe_apply_sharded(p, cfg, x, EPInfo("model", "pod"),
                              Topology(*topo)) ** 2).sum()
    grads = torch.autograd.grad(loss, [t for _, t in leaves] + [x])
    return {"/".join(path): g for (path, _), g in zip(leaves, grads)}, grads[-1]


@pytest.mark.parametrize("run", GRAD_RUNS,
                         ids=["shared{}-cf{}-{}".format(*r) for r in GRAD_RUNS])
def test_island_grads_match_reference(reference_grads, run):
    shared, cf, mode = run
    cfg, p, x = island_inputs(shared, capacity_factor=cf, moe_dispatch=mode)
    got, gx = island_grads(cfg, p, x)
    key = f"{shared}/{cf}/{mode}/f32"
    want = {"/".join(path): w for path, w in tree_leaves_with_path(
        ref_tree(reference_grads, key))}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{key} {name}")
    np.testing.assert_allclose(gx.numpy(), reference_grads[key + "/x"],
                               rtol=1e-5, atol=1e-6, err_msg=f"{key} x")


@pytest.mark.parametrize("mode", ["flat", "nap"])
def test_narrow_wire_grads(reference_grads, mode):
    """The reference's gradient through a bf16 wire is zero on every island
    leaf and on x (its words cross through a bitcast); the port raises
    under grad on both narrow wires and still runs them without grad."""
    key = f"0/8.0/{mode}/bf16"
    leaves = [k for k in reference_grads if k.startswith(key + "/")]
    assert len(leaves) == 5                # router, w_gate, w_up, w_down, x
    for k in leaves:
        assert not reference_grads[k].any(), k
    for wd in ("bf16", "fp8_e4m3"):
        cfg, p, x = island_inputs(0, moe_dispatch=mode, wire_dtype=wd)
        with pytest.raises(ValueError, match=f"{wd} wire"):
            island_grads(cfg, p, x)
        with torch.no_grad():
            from repro_torch.moe.dispatch import moe_apply_sharded
            out = moe_apply_sharded(p, cfg, x, EPInfo("model", "pod"), Topology(2, 4))
        assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the exchanges' adjoints and counted bytes
# ---------------------------------------------------------------------------

def _exchanges(topo):
    """(name, exchange, payload shape) of the island's three exchanges on
    ``topo``'s rank-batched buffers."""
    from repro_torch.mesh.comm import node_all_to_all, proc_all_to_all, rank_all_to_all
    P, nn, ppn = topo.n_procs, topo.n_nodes, topo.ppn
    return [("flat", lambda w, lab: rank_all_to_all(w, None, topo=topo, label=lab),
             (P, P, 2, 3)),
            ("pod", lambda w, lab: node_all_to_all(w, topo, None, label=lab),
             (P, nn, 2, 3)),
            ("inner", lambda w, lab: proc_all_to_all(w, ppn), (P, ppn, 2, 3))]


@pytest.mark.parametrize("name", ["flat", "pod", "inner"])
def test_exchange_adjoints(name):
    from repro_torch.moe.dispatch import _Exchange, _MetaExchange
    topo = Topology(3, 2)
    _, ex, shape = next(e for e in _exchanges(topo) if e[0] == name)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(shape, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: _Exchange.apply(t, ex, "t"), (x,))
    y = torch.randn(shape, dtype=torch.float64, generator=gen)
    ax = _Exchange.apply(x, ex, "t")
    (aty,) = torch.autograd.grad(ax, x, y)
    # self-adjoint: A^T y = A y, and <A x, y> = <x, A^T y>
    assert torch.equal(aty, _Exchange.apply(y, ex, "t"))
    np.testing.assert_allclose(float((ax * y).sum()), float((x.detach() * aty).sum()),
                               rtol=1e-14)
    # the meta exchange: ids pass, the weights' adjoint is the exchange
    ids = torch.randint(0, 8, shape, generator=gen)
    w = torch.rand(shape, generator=gen).requires_grad_(True)
    r_ids, r_w = _MetaExchange.apply(ids, w, ex, "m")
    assert torch.equal(r_ids, _Exchange.apply(ids, ex, "m"))
    assert torch.equal(r_w, _Exchange.apply(w.detach(), ex, "m"))
    gy = torch.rand(shape, generator=gen)
    (atw,) = torch.autograd.grad(r_w, w, gy)
    assert torch.equal(atw, _Exchange.apply(gy, ex, "m"))


@pytest.mark.parametrize("mode", ["flat", "nap"])
def test_backward_bytes_counted_apart(mode):
    """The forward's counted inter-pod bytes are those of a forward alone;
    the backward's go under ``:grad``: the tokens' and the combine's
    gradients as many bytes as their payloads, the meta's the weights
    only (half the ids-and-weights payload)."""
    from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
    from repro_torch.moe.dispatch import moe_apply_sharded
    cfg, p, x = island_inputs(0, capacity_factor=1.0, moe_dispatch=mode)
    axis = "nodexproc" if mode == "flat" else "node"
    reset_inter_node_bytes()
    with torch.no_grad():
        moe_apply_sharded(p, cfg, x, EPInfo("model", "pod"), Topology(2, 4))
    fwd = inter_node_bytes()
    reset_inter_node_bytes()
    island_grads(cfg, p, x)
    both = inter_node_bytes()
    for k in ("tokens", "meta", "combine"):
        assert both[f"{axis}:{k}"] == fwd[f"{axis}:{k}"] > 0
    assert both[f"{axis}:tokens:grad"] == fwd[f"{axis}:tokens"]
    assert both[f"{axis}:combine:grad"] == fwd[f"{axis}:combine"]
    assert 2 * both[f"{axis}:meta:grad"] == fwd[f"{axis}:meta"]


# ---------------------------------------------------------------------------
# the train step and the driver
# ---------------------------------------------------------------------------

def _steps(model, dtype, n=3):
    """``n`` steps of 4 x 16 bigram tokens: the losses and the state."""
    ds = SyntheticLM(model.cfg.vocab, 16, seed=3)
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10, state_dtype=dtype)
    state = adamw_init(model.param_tree(), opt)
    step = make_train_step(model, opt)
    return [float(step(state, train.to_device(ds.batch(i, 4), "cpu"))[0])
            for i in range(n)], state


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_on_island_match_local(arch, dtype):
    """Three ``make_train_step`` steps on the island (Topology(2, 2), nap)
    against the same steps on the local LM: losses rtol 1e-5, parameters
    within 2 lr steps (AdamW moves an element by about +-lr wherever its
    gradient sits at round-off level) and 99% of them within 1e-6 of max
    |p|."""
    cfg = lm_cfg(arch, "nap", opt_state_dtype=dtype)
    local, island = lm_pair(cfg)
    want, _ = _steps(local, dtype)
    got, state = _steps(island, dtype)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert state["step"] == 3
    ref = dict(tree_leaves_with_path(local.param_tree()))
    scale = max(float(t.detach().abs().max()) for t in ref.values())
    diffs = []
    for path, t in tree_leaves_with_path(island.param_tree()):
        diffs.append((t.detach() - ref[path].detach()).abs().reshape(-1))
        assert float(diffs[-1].max()) <= 2 * 3e-3 * 3, path
    assert float((torch.cat(diffs) <= 1e-6 * scale).float().mean()) >= 0.99


def test_grad_accum_on_island():
    """Two microbatches of 2 over the 2 pods of Topology(2, 2) give the
    local LM's grads; over the 4 pods of Topology(4, 1) a microbatch of 2
    raises the island's own error before any compute."""
    arch = ARCHS[0]
    cfg = lm_cfg(arch, "flat", grad_accum=2)
    local, island = lm_pair(cfg)
    batch = lm_batch(cfg.vocab)
    want = make_train_step(local, AdamWConfig()).loss_and_grad(batch)
    got = make_train_step(island, AdamWConfig()).loss_and_grad(batch)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    assert_grads_close(dict(tree_leaves_with_path(got[1])),
                       dict(tree_leaves_with_path(want[1])), 1e-5, "grad_accum 2")
    _, four = lm_pair(cfg, mesh=Topology(4, 1))

    def no_compute(*_):
        raise AssertionError("the model ran")

    four.hidden = no_compute
    with pytest.raises(ValueError, match="batch 2 must split over the 4 pods"):
        make_train_step(four, AdamWConfig()).loss_and_grad(batch)


def test_narrow_wire_lm_raises_under_grad():
    """A bf16-wire island LM raises in ``loss`` under grad, naming the
    wire; its prefill (no grad) runs."""
    cfg = lm_cfg(ARCHS[0], "nap", wire_dtype="bf16")
    _, island = lm_pair(cfg)
    batch = lm_batch(cfg.vocab)
    with pytest.raises(ValueError, match="bf16 wire"):
        island.loss(batch)
    logits, _ = island.prefill(batch["tokens"])
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="bf16 wire"):
        train.train(cfg, steps=1, batch=4, seq=16, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_moe_on_cpu(arch, capsys):
    """The driver trains a MoE arch through a one-chip island (the
    reference's one-chip mesh) and its loss decreases."""
    run = train.main(["--arch", arch, "--device", "cpu", "--steps", "12", "--batch",
                      "4", "--seq", "32", "--lr", "3e-3", "--log-every", "4"])
    assert run.model.mesh == Topology(1, 1) and run.model.ep.pod_axis is None
    assert len(run.losses) == 12 and np.isfinite(run.grad_norms).all()
    n = max(3, len(run.losses) // 10)
    assert np.mean(run.losses[-n:]) < np.mean(run.losses[:n])
    assert "MoE blocks on the island" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------

PROC_RUNS = [(arch, mode) for arch in ARCHS for mode in ("flat", "nap")]


def child(out_dir):
    from repro_torch.mesh import attach, detach, mesh_for
    torch.set_num_threads(1)
    info = attach(verbose=True)
    pid, world = info["process_id"], info["num_processes"]
    mesh = mesh_for(Topology(*LM_TOPO))
    results = {}
    for arch, mode in PROC_RUNS:
        cfg = lm_cfg(arch, mode)
        _, island = lm_pair(cfg, mesh=mesh)
        batch = lm_batch(cfg.vocab)
        shard = LM_BATCH[0] // world
        mine = {k: v[pid * shard:(pid + 1) * shard] for k, v in batch.items()}
        # every label counts, so the whole batch's mean is the mean of the
        # shards' means
        loss, grads = loss_and_grads(island, mine, scale=1.0 / world)
        results[f"{arch}/{mode}/loss"] = loss.numpy()
        for path, g in grads.items():
            results[f"{arch}/{mode}/" + "/".join(map(str, path))] = g.numpy()
    np.savez(Path(out_dir) / f"grads_{pid}.npz", **results)
    (Path(out_dir) / f"stats_{pid}.json").write_text(json.dumps(
        {k: v for k, v in mesh.stats.items()}))
    detach()
    print(f"CHILD {pid} OK", flush=True)


@pytest.fixture(scope="module")
def proc_run(tmp_path_factory):
    from repro_torch.mesh import launch
    out = tmp_path_factory.mktemp("moe_train_mesh")
    res = launch(__file__, N_PROC, args=["child", str(out)], local_devices=1,
                 env={"JAX_PLATFORMS": "cpu", "REPRO_MESH_BACKEND": "gloo"},
                 timeout_s=600)
    runs = []
    for pid in range(N_PROC):
        assert f"CHILD {pid} OK" in res.output(pid), res.output(pid)
        with np.load(out / f"grads_{pid}.npz") as z:
            grads = {k: z[k] for k in z.files}
        runs.append((grads, json.loads((out / f"stats_{pid}.json").read_text())))
    return runs


@pytest.mark.parametrize("run", PROC_RUNS, ids=["{}-{}".format(*r) for r in PROC_RUNS])
def test_two_processes_grads_sum_to_one(proc_run, run):
    arch, mode = run
    cfg = lm_cfg(arch, mode)
    _, island = lm_pair(cfg)
    loss, want = loss_and_grads(island, lm_batch(cfg.vocab))
    got = sum(float(g[f"{arch}/{mode}/loss"]) for g, _ in proc_run)
    np.testing.assert_allclose(got, float(loss), rtol=1e-6)
    for path, w in want.items():
        key = f"{arch}/{mode}/" + "/".join(map(str, path))
        total = sum(g[key] for g, _ in proc_run)
        err = np.abs(total - w.numpy()).max()
        assert err <= 1e-6 * float(w.abs().max()), (key, err)
    # the backward's exchanges crossed the processes too
    for _, stats in proc_run:
        assert stats["sent_bytes_nodexproc:tokens:grad"] > 0
        assert stats["sent_bytes_node:tokens:grad"] > 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "child":
        child(sys.argv[2])
    else:
        sys.exit("usage: test_torch_moe_train.py child OUT_DIR (under launch())")
