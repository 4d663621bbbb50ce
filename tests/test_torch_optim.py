"""The port's data pipeline and AdamW against the JAX package's on the CPU.

Batches, the prefetch order and the bigram entropy are bit-equal.  The
optimizer runs on identical trees and grads in both packages: the
schedule within one ulp (plus the one ulp by which XLA's float32 cos may
differ from the correctly rounded one, carried through the schedule), the
int8 codes of the block codecs within +-1 on at most 0.1% of entries,
the linear scales equal and the log domain's within an ulp of float32's
log, and 1 and 5 ``adamw_update`` calls within 1e-6
of max |p| (float32 parameters, and the float32 masters of bfloat16 ones;
a bfloat16 parameter within one bfloat16 ulp).  With int8 moments a code
off by one moves its element by up to ~lr a step: every element within
2 lr x steps, and at least 99% of them within 1e-6 of max |p|.  An update
of large leaves a slice of rows at a time is bit-equal to the whole-leaf
update.  The reference's own
quadratic, round-trip and schedule-shape checks
(``tests/test_substrates.py``) run again on the port.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JaxSyntheticLM
from repro.data import make_batch_iterator as jax_batch_iterator
from repro.optim import adamw as ref

from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.models.convert import opt_state_from_jax
from repro_torch.optim import adamw as port
from repro_torch.optim.adamw import tree_at, tree_leaves_with_path


# --------------------------- data ------------------------------------------

@pytest.mark.parametrize("vocab,seq,seed", [(512, 16, 7), (8192, 33, 0),
                                            (256_000, 8, 3)])
def test_batches_and_entropy_bit_equal(vocab, seq, seed):
    mine, theirs = SyntheticLM(vocab, seq, seed), JaxSyntheticLM(vocab, seq, seed)
    np.testing.assert_array_equal(mine.successors, theirs.successors)
    for step, bsz, shard, n_shards in [(0, 4, 0, 1), (3, 8, 1, 2), (17, 6, 2, 3)]:
        a = mine.batch(step, bsz, shard, n_shards)
        b = theirs.batch(step, bsz, shard, n_shards)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.bigram_entropy() == theirs.bigram_entropy()


def test_iterator_order_bit_equal():
    mine, theirs = SyntheticLM(128, 8, 1), JaxSyntheticLM(128, 8, 1)
    it_m = make_batch_iterator(mine, 4, start_step=5, prefetch=2)
    it_t = jax_batch_iterator(theirs, 4, start_step=5, prefetch=2)
    for step in range(5, 10):
        a, b = next(it_m), next(it_t)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["tokens"], mine.batch(step, 4)["tokens"])
    it_m.close()
    it_t.close()


def test_synthetic_data_deterministic_and_sharded():
    """The reference's own check, on the port."""
    ds = SyntheticLM(vocab=512, seq_len=16, seed=7)
    b1 = ds.batch(step=3, batch_size=8, shard=0, n_shards=2)
    np.testing.assert_array_equal(b1["tokens"], ds.batch(3, 8, 0, 2)["tokens"])
    assert not np.array_equal(b1["tokens"], ds.batch(3, 8, 1, 2)["tokens"])
    assert b1["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert 0 < ds.bigram_entropy() < np.log(512)


# --------------------------- schedule --------------------------------------

def _ulps(a, b):
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 100, 10_000), (1.0, 10, 100),
                                             (1e-3, 20, 300), (0.05, 5, 300),
                                             (3e-4, 1, 8)])
def test_cosine_schedule_within_one_ulp(lr, warmup, total):
    cfg_r = ref.AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=total)
    cfg_p = port.AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=total)
    steps = sorted(set(range(0, min(total + 5, 600))) | {total // 2, total, 2 * total})
    for step in steps:
        want = np.float32(ref.cosine_schedule(cfg_r, jnp.asarray(step)))
        got = np.float32(port.cosine_schedule(cfg_p, step))
        t = np.clip((np.float32(step) - warmup) / np.float32(max(total - warmup, 1)), 0, 1)
        warm = min(step / max(warmup, 1), 1.0)
        cos = np.float32(math.cos(np.float32(np.pi) * t))
        # one ulp of the result, plus one ulp of cos through lr*warm*0.45*cos
        tol = np.spacing(want) + np.float32(lr * warm * 0.45) * np.spacing(abs(cos))
        assert abs(float(got) - float(want)) <= 1.5 * tol, (step, got, want, _ulps(got, want))
    for step in range(1, 300):
        for b in (0.9, 0.95):
            want = np.float32(1 - b ** jnp.asarray(step).astype(jnp.float32))
            assert np.float32(port._bias_correction(b, step)) == want


def test_cosine_schedule_shape():
    """The reference's own check, on the port."""
    cfg = port.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [port.cosine_schedule(cfg, s) for s in [0, 5, 10, 55, 100, 200]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5, abs=0.02)
    assert lrs[2] == pytest.approx(1.0, abs=0.02)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, abs=0.02)
    assert lrs[5] == pytest.approx(0.1, abs=0.02)


# --------------------------- int8 codecs -------------------------------------

def _close_codes(got, want, what, share=1e-3):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"{what}: code off by {diff.max()}"
    assert (diff > 0).mean() <= share, f"{what}: {(diff > 0).mean():.2%} codes off by one"


@pytest.mark.parametrize("shape", [(513,), (3, 512), (2, 64, 48), (256_000 // 64,), ()])
def test_q8_codecs_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    v = (rng.standard_normal(shape) ** 2 * 1e-6).astype(np.float32)
    if v.ndim:
        v.reshape(-1)[:7] = 0.0
    rq, pq = jax.device_get(ref._q8_quant(jnp.asarray(x))), port._q8_quant(torch.tensor(x))
    _close_codes(pq["q"].numpy(), rq["q"], "m codes")
    np.testing.assert_array_equal(pq["s"].numpy(), rq["s"])
    rl, pl = jax.device_get(ref._q8l_quant(jnp.asarray(v))), port._q8l_quant(torch.tensor(v))
    _close_codes(pl["q"].numpy(), rl["q"], "v codes")
    # the log domain's scales: XLA's float32 log and torch's differ by an ulp
    np.testing.assert_allclose(pl["lo"].numpy(), rl["lo"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(pl["st"].numpy(), rl["st"], rtol=1e-5, atol=0)
    # dequantizing the reference's codes
    back = port._q8_dequant({k: torch.tensor(np.asarray(a)) for k, a in rq.items()})
    np.testing.assert_allclose(back.numpy(), np.asarray(ref._q8_dequant(rq)), rtol=1e-6)
    back = port._q8l_dequant({k: torch.tensor(np.asarray(a)) for k, a in rl.items()})
    np.testing.assert_allclose(back.numpy(), np.asarray(ref._q8l_dequant(rl)),
                               rtol=1e-5, atol=0)


def test_q8_roundtrip_accuracy():
    """The reference's own check, on the port."""
    x = torch.tensor(np.random.default_rng(0).standard_normal((513,)) * 0.01,
                     dtype=torch.float32)
    back = port._q8_dequant(port._q8_quant(x))
    assert float((back - x).abs().max() / x.abs().max()) < 0.02


def test_block_of_matches_reference():
    for n in (1, 7, 16, 64, 128, 256, 513, 2304, 4096, 9216, 128_256, 256_000):
        assert port._block_of(n) == ref._block_of(n)


# --------------------------- adamw_update ---------------------------------------

def _tree(rng):
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"embed": mk(40, 24), "final_norm": mk(24),
              "layers": [{"attn": {"wq": mk(24, 32)}, "norm1": mk(24)}
                         for _ in range(2)]}
    grads = [port.tree_map(lambda a: mk(*a.shape) * 0.3, params) for _ in range(5)]
    return params, grads


def _to_torch(tree, dtype):
    return port.tree_map(lambda a: torch.tensor(a).to(dtype), tree)


def _to_jax(tree, dtype):
    """The reference's layout: the layer list stacked on a leading axis."""
    out = {k: jnp.asarray(v, dtype) for k, v in tree.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *a: jnp.stack([jnp.asarray(x, dtype) for x in a]),
                                 *tree["layers"])
    return out


def _layer(tree_j, path):
    """The port's leaf at ``path`` from the reference's stacked tree (an
    int8 state's path ends in its part, "q", "s", ...)."""
    if path[0] == "layers":
        return np.asarray(tree_at(tree_j["layers"], path[2:])[path[1]])
    return np.asarray(tree_at(tree_j, path))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _params_close(got, want, scale, state_dtype, moved, what):
    """float32 moments: within 1e-6 of max |p|.  int8 moments: an int8 code
    off by one moves its element's update by up to ~lr a step, so every
    element within 2 lr x steps and at least 99% within 1e-6 of max |p|."""
    if state_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale, err_msg=what)
        return
    diff = np.abs(got - want)
    assert diff.max() <= 2 * moved, (what, diff.max())
    assert (diff <= 1e-6 * scale).mean() >= 0.99, (what, (diff > 1e-6 * scale).mean())


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("dtype,master", [("float32", True), ("bfloat16", True),
                                          ("bfloat16", False)])
def test_adamw_update_matches_reference(state_dtype, dtype, master):
    rng = np.random.default_rng(4)
    params, grads = _tree(rng)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    kw = dict(lr=3e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype,
              master_fp32=master, clip_norm=4.0)
    cfg_r, cfg_p = ref.AdamWConfig(**kw), port.AdamWConfig(**kw)
    pj = _to_jax(params, jdt)
    sj = ref.adamw_init(pj, cfg_r)
    pt = _to_torch(params, tdt)
    st = port.adamw_init(pt, cfg_p)
    assert ("master" in st) == ("master" in sj)
    upd = jax.jit(lambda g, p, s: ref.adamw_update(g, p, s, cfg_r))
    for n, g in enumerate(grads, 1):
        pj, sj = upd(_to_jax(g, jdt), pj, sj)
        gn = port.adamw_update(_to_torch(g, tdt), pt, st, cfg_p)
        want_gn = float(ref.global_norm(_to_jax(g, jdt)))
        assert float(gn) == pytest.approx(want_gn, rel=1e-5)
        if n not in (1, 5):
            continue
        assert st["step"] == int(sj["step"]) == n
        scale = max(float(np.abs(np.asarray(x, np.float32)).max())
                    for x in jax.tree.leaves(pj))
        for path, p in tree_leaves_with_path(pt):
            want = _layer(pj, path).astype(np.float32)
            close = (lambda got, ref_, what: _params_close(  # noqa: E731
                got, ref_, scale, state_dtype, kw["lr"] * n, what))
            if dtype == "float32":
                close(_np(p), want, f"{path} after {n}")
            elif state_dtype == "float32":   # one bf16 ulp where f32 values round apart
                np.testing.assert_allclose(_np(p), want, rtol=2 ** -8, atol=0,
                                           err_msg=f"{path} after {n}")
            if "master" in st:
                close(_np(tree_at(st["master"], path)), _layer(sj["master"], path),
                      f"master {path} after {n}")
            for key in ("m", "v"):
                for sub, got in tree_leaves_with_path(tree_at(st[key], path)):
                    want = _layer(sj[key], path + sub)
                    if sub == ("q",):   # flips compound over steps: 1%
                        _close_codes(got.numpy(), want, f"{key} {path}", share=1e-2)
                    else:
                        np.testing.assert_allclose(
                            got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                            err_msg=f"{key} {path}{sub}")


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_minimizes_quadratic(state_dtype):
    """The reference's own check, on the port."""
    cfg = port.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=5,
                           total_steps=300, state_dtype=state_dtype)
    params = {"w": torch.tensor(np.random.default_rng(0).standard_normal(64),
                                dtype=torch.float32),
              "b": torch.zeros((8,), dtype=torch.float32)}
    state = port.adamw_init(params, cfg)

    def loss_fn():
        return sum(((p - 0.5) ** 2).sum() for p in params.values())

    l0 = float(loss_fn())
    for _ in range(200):
        leaves = {k: p.requires_grad_(True) for k, p in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss_fn(), list(leaves.values()))))
        for p in params.values():
            p.requires_grad_(False)
        port.adamw_update(grads, params, state, cfg)
    assert float(loss_fn()) < l0 * 1e-3


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_opt_state_from_jax_slices_layers(state_dtype):
    """The reference's stacked state, converted, is the port's per-layer
    state: every array a layer's slice, the step a host int."""
    rng = np.random.default_rng(5)
    params, grads = _tree(rng)
    cfg = ref.AdamWConfig(state_dtype=state_dtype, lr=1e-2, warmup_steps=1)
    pj = _to_jax(params, jnp.bfloat16)
    sj = ref.adamw_init(pj, cfg)
    _, sj = ref.adamw_update(_to_jax(grads[0], jnp.bfloat16), pj, sj, cfg)
    sj = jax.device_get(sj)
    st = opt_state_from_jax(sj)
    assert st["step"] == 1 and isinstance(st["step"], int)
    assert set(st) == {"step", "m", "v", "master"}
    fresh = port.adamw_init(_to_torch(params, torch.bfloat16),
                            port.AdamWConfig(state_dtype=state_dtype))
    for key in ("m", "v", "master"):
        got = dict(tree_leaves_with_path(st[key]))
        shapes = {p: (t.shape, t.dtype) for p, t in tree_leaves_with_path(fresh[key])}
        assert {p: (t.shape, t.dtype) for p, t in got.items()} == shapes
        for path, t in got.items():
            np.testing.assert_array_equal(t.numpy(), _layer(sj[key], path))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_update_bit_equal_to_whole(monkeypatch, state_dtype, dtype):
    """3 updates with every leaf of more than 1000 elements in slices of
    rows against the same updates whole: parameters, masters and moments
    (int8 codes and their scales) bit-equal."""
    gen = torch.Generator().manual_seed(0)
    shapes = {"a": (300, 64), "b": (64,), "c": (), "d": (7, 5, 32), "e": (3, 700)}
    params = {k: torch.randn(s, generator=gen).to(dtype) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen).to(dtype) for k, s in shapes.items()}
             for _ in range(3)]
    cfg = port.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                           state_dtype=state_dtype)
    runs = []
    for limit in (port.UPDATE_SLICE, 1000):
        monkeypatch.setattr(port, "UPDATE_SLICE", limit)
        p = {k: v.clone() for k, v in params.items()}
        state = port.adamw_init(p, cfg)
        for g in grads:
            port.adamw_update(g, p, state, cfg)
        runs.append((p, state))
    assert len(port._update_slices(shapes["a"])) == 20
    assert port._update_slices(shapes["e"]) == [slice(0, 1), slice(1, 2), slice(2, 3)]
    (pa, sa), (pb, sb) = runs
    for (path, a), (_, b) in zip(tree_leaves_with_path((pa, sa)),
                                 tree_leaves_with_path((pb, sb))):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
