"""The port's checkpoints, fault runtime and ``survivor_partition``
against the JAX package.

The checkpoint, heartbeat, straggler and elastic cases of
``tests/test_substrates.py`` run on the port (torch tensors in the
tree, bfloat16 included).  A checkpoint written by ``repro.checkpoint``
loads in the port bit for bit and the reverse; both packages write the
same manifest for the same tree (the shard digests aside, which cover
the npz files' timestamps); torn and corrupt shards behave as in the
reference.  ``survivor_partition`` gives the reference's owner array.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.core.partition as ref_partition
from repro.core.integrity import IntegrityError as RefIntegrityError
from repro.runtime import ElasticPolicy as RefElasticPolicy

import repro_torch.core.partition as port_partition
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core.integrity import IntegrityError
from repro_torch.runtime import (ElasticPolicy, HeartbeatMonitor,
                                 StragglerDetector)


# --------------------------- checkpoint ------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "nested": {"b": torch.ones((3, 4), dtype=torch.bfloat16)},
            "step": torch.tensor(7)}
    save_checkpoint(str(tmp_path), 7, tree, extra={"data_step": 123})
    out, extra = load_checkpoint(str(tmp_path), target=tree)
    assert extra["data_step"] == 123
    np.testing.assert_array_equal(np.asarray(out["a"]), np.arange(10))
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    on_dev, _ = load_checkpoint(str(tmp_path), target=tree, device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in
               (on_dev["a"], on_dev["nested"]["b"], on_dev["step"]))
    assert torch.equal(on_dev["a"], tree["a"]) and int(on_dev["step"]) == 7


def test_checkpoint_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros((4,))}
    for s in (1, 2, 3):
        mgr.save(s, tree, block=True)
    steps = sorted(p.name for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == ["step_00000002", "step_00000003"]
    out, _ = mgr.restore(target=tree)
    assert out["w"].shape == (4,)


def test_manager_snapshots_before_the_writer_runs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.zeros(4)
    mgr.save(1, {"w": w})
    w += 1.0                      # the in-flight save must not see this
    mgr.wait()
    out, _ = mgr.restore()
    np.testing.assert_array_equal(out["w"], np.zeros(4, np.float32))


def test_checkpoint_uncommitted_is_ignored(tmp_path):
    tree = {"w": torch.zeros((4,))}
    save_checkpoint(str(tmp_path), 1, tree)
    p = pathlib.Path(tmp_path) / "step_00000002"
    p.mkdir()
    (p / "manifest.json").write_text("{}")
    out, _ = load_checkpoint(str(tmp_path), target=tree)
    assert out["w"].shape == (4,)


def _tree_np(seed=0):
    """A tree with unsorted dict keys, lists, tuples, a None and scalars."""
    rng = np.random.default_rng(seed)
    return {"z": rng.standard_normal(5),
            "a": [rng.integers(0, 9, (2, 3)).astype(np.int32), None,
                  (np.float32(1.5), {"q": rng.standard_normal(3).astype(np.float32)})],
            "m": {"y": np.arange(4, dtype=np.int64), "b": np.zeros((0,))}}


def _bf16_bits():
    return np.random.default_rng(1).integers(0, 1 << 15, (3, 4)).astype(np.uint16)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_reference_checkpoint_loads_in_port(tmp_path):
    tree = _tree_np()
    tree["m"]["h"] = jnp.asarray(_bf16_bits()).view(jnp.bfloat16)
    ref_ckpt.save_checkpoint(str(tmp_path), 3, tree, extra={"it": 3})
    got, extra = load_checkpoint(str(tmp_path))
    want, ref_extra = ref_ckpt.load_checkpoint(str(tmp_path))
    assert extra == ref_extra == {"it": 3}
    assert list(got) == list(want)
    for name in want:
        if name == "m/h":
            assert got[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))
        else:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])


def test_port_checkpoint_loads_in_reference(tmp_path):
    tree = _tree_np()
    tree["t"] = torch.from_numpy(np.arange(6, dtype=np.float32))
    tree["m"]["h"] = torch.from_numpy(_bf16_bits().view(np.int16)).view(torch.bfloat16)
    save_checkpoint(str(tmp_path), 4, tree, extra={"it": 4})
    want = {"z": tree["z"], "a/0": tree["a"][0], "a/2/0": tree["a"][2][0],
            "a/2/1/q": tree["a"][2][1]["q"], "m/b": tree["m"]["b"],
            "m/y": tree["m"]["y"], "t": tree["t"].numpy()}
    got, extra = ref_ckpt.load_checkpoint(str(tmp_path))
    assert extra == {"it": 4}
    assert sorted(got) == sorted(list(want) + ["m/h"])
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(v))
        assert got[name].dtype == np.asarray(v).dtype
    np.testing.assert_array_equal(_bits(got["m/h"]), _bf16_bits())
    # and back through the reference's target path
    out, _ = ref_ckpt.load_checkpoint(str(tmp_path),
                                      target=jax_target(tree))
    np.testing.assert_array_equal(np.asarray(out["t"]), tree["t"].numpy())


def jax_target(tree):
    """The tree with torch leaves as numpy (jax's tree utilities do not
    know torch tensors; only the structure matters for a target)."""
    if isinstance(tree, dict):
        return {k: jax_target(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_target(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return np.zeros(tuple(tree.shape))
    return tree


def test_manifests_equal(tmp_path):
    tree = _tree_np(2)
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 9, tree, extra={"k": 1},
                             shard_mb=0)      # one leaf per shard
    save_checkpoint(str(tmp_path / "port"), 9, tree, extra={"k": 1}, shard_mb=0)
    manifests = [json.loads((tmp_path / side / "step_00000009" /
                             "manifest.json").read_text())
                 for side in ("ref", "port")]
    digests = [m.pop("shard_digests") for m in manifests]
    assert manifests[0] == manifests[1]
    assert sorted(digests[0]) == sorted(digests[1])
    assert manifests[0]["shards"] == 6


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_torn_and_corrupt_shards_as_reference(tmp_path, writer):
    save = {"ref": ref_ckpt.save_checkpoint, "port": save_checkpoint}[writer]
    save(str(tmp_path), 1, {"x": np.arange(6.0)}, extra={"it": 1})

    def tear():
        raise OSError("torn")
    with pytest.raises(OSError):
        save(str(tmp_path), 2, {"x": np.arange(6.0) * 2}, extra={"it": 2},
             on_before_commit=tear)
    for load in (load_checkpoint, ref_ckpt.load_checkpoint):
        out, extra = load(str(tmp_path))         # the committed step stands
        assert extra == {"it": 1}
        np.testing.assert_array_equal(out["x"], np.arange(6.0))
        with pytest.raises(FileNotFoundError, match="not committed"):
            load(str(tmp_path), step=2)
    shard = tmp_path / "step_00000001" / "shard_0.npz"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    shard.write_bytes(bytes(raw))
    msgs = []
    for load, err in ((load_checkpoint, IntegrityError),
                      (ref_ckpt.load_checkpoint, RefIntegrityError)):
        with pytest.raises(err, match="shard_0.npz is corrupt") as ei:
            load(str(tmp_path))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    shard.unlink()
    with pytest.raises(FileNotFoundError, match="it held 1 leaves"):
        load_checkpoint(str(tmp_path))


# --------------------------- runtime ---------------------------------------

def test_heartbeat_detects_dead_node():
    t = [0.0]
    mon = HeartbeatMonitor(["n0", "n1"], timeout=10.0, clock=lambda: t[0])
    t[0] = 5.0
    mon.beat("n0")
    t[0] = 12.0
    assert mon.dead_nodes() == ["n1"]
    mon.beat("n1")
    assert mon.healthy()


def test_straggler_zscore():
    det = StragglerDetector(window=8, z_thresh=2.0, rel_floor=1.3)
    for step in range(8):
        for n in range(6):
            det.record(f"n{n}", 1.0 + 0.01 * n)
        det.record("slow", 3.0)
    assert det.stragglers() == ["slow"]


def test_elastic_policy_shrinks_data_axis():
    pol = ElasticPolicy()
    out = pol.propose((16, 16), ("data", "model"), n_dead_nodes=2,
                      chips_per_node=4)
    assert out is not None
    shape, names = out
    assert names == ("data", "model")
    assert shape == (15, 16)


def test_elastic_policy_drops_pod_when_needed():
    pol = ElasticPolicy(min_data=14)
    out = pol.propose((2, 16, 16), ("pod", "data", "model"), n_dead_nodes=16,
                      chips_per_node=4)
    assert out is not None
    shape, _ = out
    assert shape == (1, 16, 16)
    assert ElasticPolicy(min_data=16).propose((16, 16), ("data", "model"), 2) is None


@pytest.mark.parametrize("args", [
    ((16, 16), ("data", "model"), 2, 4), ((2, 16, 16), ("pod", "data", "model"), 16, 4),
    ((8, 4), ("data", "model"), 3, 2), ((4,), ("data",), 9, 1)])
def test_elastic_policy_matches_reference(args):
    for min_data in (1, 3, 14):
        assert (ElasticPolicy(min_data=min_data).propose(*args)
                == RefElasticPolicy(min_data=min_data).propose(*args))
    for gb, old, new in ((96, 8, 6), (64, 16, 4), (30, 5, 3)):
        assert (ElasticPolicy().global_batch_plan(gb, old, new)
                == RefElasticPolicy().global_batch_plan(gb, old, new))


# --------------------------- survivor_partition -----------------------------

@pytest.mark.parametrize("layout", [
    ("contiguous", 40, 4, [1]), ("contiguous", 4096, 16, [4, 5, 6, 7]),
    ("strided", 97, 6, [0, 5]), ("contiguous", 10, 8, [3, 3, 6]),
    ("owner", 300, 12, [2, 11])])
def test_survivor_partition_matches_reference(layout):
    kind, n, n_procs, dead = layout
    if kind == "owner":
        owner = np.random.default_rng(n).integers(0, n_procs, size=n)
        owner[owner == 1] = 0
        ref = ref_partition._from_owner(owner, n_procs, "owner")
        port = port_partition.partition_from_owner(owner, n_procs)
    else:
        ref = getattr(ref_partition, f"{kind}_partition")(n, n_procs)
        port = getattr(port_partition, f"{kind}_partition")(n, n_procs)
    got = port_partition.survivor_partition(port, dead)
    want = ref_partition.survivor_partition(ref, dead)
    assert got.kind == want.kind == "elastic" and got.n_procs == want.n_procs
    for f in ("owner", "perm", "first"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
