"""The port's kernel wrappers (plain versions on CPU tensors) against the
JAX package's Pallas kernels in interpret mode.

Inputs come from a seeded numpy generator and go to both.  Tolerance:
rtol 1e-6 and atol 1e-6 * max|out| — the same f32 products, summed over
slots in possibly another order.
"""
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spmv.fused import (fused_bsr_spmm as ref_bsr_concat,
                                          fused_bsr_spmm_packed as ref_bsr_packed)
from repro.kernels.ell_spmv.kernel import ell_spmm_packed as ref_ell

from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.bsr_spmv import (fused_bsr_spmm, fused_bsr_spmm_packed,
                                          fused_bsr_spmm_packed_ref,
                                          fused_bsr_spmm_ref)
from repro_torch.kernels.ell_spmv import ell_spmm_packed, ell_spmm_packed_ref

N_RANKS = 2


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * scale)


def _ell_case(seed, seg_lens, nv, n_rows=16, kmax=5):
    """Per-rank ELL with padding slots (col -1, val 0) and whole padded rows."""
    rng = np.random.default_rng(seed)
    n_x = sum(seg_lens)
    cols = rng.integers(0, n_x, size=(N_RANKS, n_rows, kmax)).astype(np.int32)
    vals = rng.standard_normal((N_RANKS, n_rows, kmax)).astype(np.float32)
    pad = rng.random((N_RANKS, n_rows, kmax)) < 0.3
    pad[:, -2:] = True
    cols[pad], vals[pad] = -1, 0.0
    xs = [rng.standard_normal((N_RANKS, L, nv)).astype(np.float32)
          for L in seg_lens]
    return cols, vals, xs


@pytest.mark.parametrize("nv", [1, 3, 130])
@pytest.mark.parametrize("seg_lens", [(24,), (16, 8), (16, 8, 8)],
                         ids=["1seg", "2seg", "3seg"])
def test_ell_plain_matches_pallas(seg_lens, nv):
    cols, vals, xs = _ell_case(len(seg_lens) * 10 + nv, seg_lens, nv)
    t = [torch.from_numpy(x) for x in xs]
    got = ell_spmm_packed(torch.from_numpy(cols), torch.from_numpy(vals), t)
    assert got.shape == (N_RANKS, cols.shape[1], nv) and got.dtype == torch.float32
    for r in range(N_RANKS):
        want = ref_ell(cols[r], vals[r], tuple(x[r] for x in xs), interpret=True)
        _close(got[r], want)


def _bsr_case(seed, seg_bcols, nv, n_brows=3, ktot=4, bm=8, bn=16):
    """Per-rank padded-uniform BSR; the last slot of every block row and a
    random share of the others are padding (col -1, zero block)."""
    rng = np.random.default_rng(seed)
    n_bc = sum(seg_bcols)
    cols = np.sort(rng.integers(0, n_bc, size=(N_RANKS, n_brows, ktot)),
                   axis=-1).astype(np.int32)
    blocks = rng.standard_normal((N_RANKS, n_brows, ktot, bm, bn)).astype(np.float32)
    pad = rng.random((N_RANKS, n_brows, ktot)) < 0.25
    pad[..., -1] = True
    cols[pad] = -1
    blocks[pad] = 0.0
    xs = [rng.standard_normal((N_RANKS, nb, bn, nv)).astype(np.float32)
          for nb in seg_bcols]
    return cols, blocks, xs


@pytest.mark.parametrize("nv", [1, 3, 130])
@pytest.mark.parametrize("seg_bcols", [(5,), (3, 2), (2, 2, 1)],
                         ids=["1seg", "2seg", "3seg"])
def test_bsr_plain_matches_pallas(seg_bcols, nv):
    cols, blocks, xs = _bsr_case(len(seg_bcols) * 10 + nv, seg_bcols, nv)
    tc, tb = torch.from_numpy(cols), torch.from_numpy(blocks)
    txs = [torch.from_numpy(x) for x in xs]
    packed = fused_bsr_spmm_packed(tc, tb, txs)
    concat = fused_bsr_spmm(tc, tb, torch.cat(txs, dim=1))
    assert packed.shape == (N_RANKS, cols.shape[1], blocks.shape[3], nv)
    # the port's packed and concatenated paths are bit-equal
    assert torch.equal(packed, concat)
    for r in range(N_RANKS):
        seg = tuple(x[r] for x in xs)
        _close(packed[r], ref_bsr_packed(cols[r], blocks[r], seg, interpret=True))
        _close(concat[r], ref_bsr_concat(cols[r], blocks[r],
                                         np.concatenate(seg), interpret=True))


def test_cpu_wrappers_use_plain_versions_and_launch_nothing():
    reset_launches()
    cols, vals, xs = _ell_case(0, (8, 8), 2)
    tc, tv = torch.from_numpy(cols), torch.from_numpy(vals)
    txs = [torch.from_numpy(x) for x in xs]
    assert torch.equal(ell_spmm_packed(tc, tv, txs),
                       ell_spmm_packed_ref(tc, tv, txs))
    bc, bb, bxs = _bsr_case(0, (2, 2), 2)
    tbc, tbb = torch.from_numpy(bc), torch.from_numpy(bb)
    tbx = [torch.from_numpy(x) for x in bxs]
    assert torch.equal(fused_bsr_spmm_packed(tbc, tbb, tbx),
                       fused_bsr_spmm_packed_ref(tbc, tbb, tbx))
    assert torch.equal(fused_bsr_spmm(tbc, tbb, torch.cat(tbx, 1)),
                       fused_bsr_spmm_ref(tbc, tbb, torch.cat(tbx, 1)))
    assert sum(launches.values()) == 0


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    k = next(k for k in range(4) if (buf.data_ptr() + k * t.element_size()) % 16)
    out = buf[k:k + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("bad", ["dtype", "shape", "segments", "contiguous",
                                 "bsr_blocks_misaligned", "bsr_x_misaligned",
                                 "padded_blocks_misaligned", "padded_x_misaligned"])
def test_wrappers_reject_bad_operands(bad):
    if bad.startswith("bsr_"):
        cols, blocks, xs = _bsr_case(1, (2, 2), 2)
        tc, tb = torch.from_numpy(cols), torch.from_numpy(blocks)
        txs = [torch.from_numpy(x) for x in xs]
        if bad == "bsr_blocks_misaligned":
            tb = _misaligned(tb)
        else:
            txs[1] = _misaligned(txs[1])
        with pytest.raises(ValueError, match="16-byte"):
            fused_bsr_spmm_packed(tc, tb, txs)
        with pytest.raises(ValueError, match="16-byte"):
            fused_bsr_spmm(tc, tb, txs[1] if bad == "bsr_x_misaligned" else txs[0])
        return
    if bad.startswith("padded_"):
        rng = np.random.default_rng(4)
        tc = torch.from_numpy(rng.integers(-1, 4, size=(3, 2)).astype(np.int32))
        tb = torch.zeros((3, 2, 8, 16))
        tx = torch.zeros((4, 16, 1))
        if bad == "padded_blocks_misaligned":
            tb = _misaligned(tb)
        else:
            tx = _misaligned(tx)
        with pytest.raises(ValueError, match="16-byte"):
            bsr_spmm_padded(tc, tb, tx)
        return
    cols, vals, xs = _ell_case(1, (8, 8), 2)
    tc, tv = torch.from_numpy(cols), torch.from_numpy(vals)
    txs = [torch.from_numpy(x) for x in xs]
    if bad == "dtype":
        tc = tc.long()
    elif bad == "shape":
        txs[1] = txs[1][..., :1]
    elif bad == "segments":
        txs = txs * 2
    else:
        tv = tv.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        ell_spmm_packed(tc, tv, txs)


def _interior_padding_case(seed, seg_bcols, nv, n_brows=4, ktot=6, bm=8, bn=16):
    """Padded-uniform BSR whose padding slots sit inside the rows: slots
    1 and 3 are padding in every block row, block row 0 is all padding
    and block row 2 has only its last slot live."""
    cols, blocks, xs = _bsr_case(seed, seg_bcols, nv, n_brows=n_brows, ktot=ktot,
                                 bm=bm, bn=bn)
    rng = np.random.default_rng(seed + 1)
    cols[...] = rng.integers(0, sum(seg_bcols), size=cols.shape)
    blocks[...] = rng.standard_normal(blocks.shape)
    pad = np.zeros(cols.shape, dtype=bool)
    pad[..., [1, 3]] = True
    pad[:, 0] = True
    pad[:, 2, :-1] = True
    cols[pad] = -1
    blocks[pad] = 0.0
    return cols, blocks, xs


@pytest.mark.parametrize("nv", [1, 3, 8])
@pytest.mark.parametrize("entry", ["packed_3seg", "concat", "padded"])
def test_bsr_interior_padding_matches_pallas(entry, nv):
    """Padding slots in the middle of a block row (the contract marks a
    zero block by col -1 anywhere): each BSR wrapper's plain version
    against its Pallas kernel in interpret mode."""
    seg_bcols = (2, 2, 1) if entry == "packed_3seg" else (5,)
    cols, blocks, xs = _interior_padding_case(7 * nv + len(entry), seg_bcols, nv)
    assert (cols[..., 1] < 0).all() and (cols[..., -1] >= 0).any()
    tc, tb = torch.from_numpy(cols), torch.from_numpy(blocks)
    txs = [torch.from_numpy(x) for x in xs]
    for r in range(N_RANKS):
        if entry == "packed_3seg":
            got = fused_bsr_spmm_packed(tc, tb, txs)[r]
            want = ref_bsr_packed(cols[r], blocks[r], tuple(x[r] for x in xs),
                                  interpret=True)
        elif entry == "concat":
            got = fused_bsr_spmm(tc, tb, txs[0])[r]
            want = ref_bsr_concat(cols[r], blocks[r], xs[0][r], interpret=True)
        else:
            got = bsr_spmm_padded(tc[r].contiguous(), tb[r].contiguous(), txs[0][r])
            want = ref_padded(jnp.asarray(cols[r]), jnp.asarray(blocks[r]),
                              jnp.asarray(xs[0][r]), interpret=True)
        _close(got, want)
        assert np.abs(np.asarray(want)[2]).max() > 0  # the row with one live slot
        np.testing.assert_array_equal(np.asarray(got)[0], 0.0)  # all padding


# ---------------------------------------------------------------------------
# Padded-uniform BSR SpMM of one matrix (bsr_spmm_padded) and its ops
# ---------------------------------------------------------------------------

import jax.numpy as jnp  # noqa: E402

import repro.kernels.bsr_spmv.ops as ref_ops  # noqa: E402
import repro.sparse as ref_sparse  # noqa: E402
from repro.kernels.bsr_spmv.kernel import bsr_spmm_padded as ref_padded  # noqa: E402

import repro_torch.sparse as port_sparse  # noqa: E402
from repro_torch.kernels.bsr_spmv import (bsr_spmm, bsr_spmm_padded,  # noqa: E402
                                          bsr_spmm_padded_ref, bsr_spmv,
                                          bsr_spmv_ref)


@pytest.mark.parametrize("bm,bn,nv", [(8, 8, 1), (8, 16, 4), (16, 8, 8),
                                      (32, 32, 16), (8, 128, 128)])
def test_bsr_padded_plain_matches_pallas(bm, bn, nv):
    """Padding slots (col -1, zero block) included, as in the reference's
    own sweep."""
    rng = np.random.default_rng(bm * 1000 + bn * 10 + nv)
    nbr, nbc, kmax = 3, 4, 3
    cols = rng.integers(-1, nbc, size=(nbr, kmax)).astype(np.int32)
    cols[0, -1] = -1
    blocks = rng.standard_normal((nbr, kmax, bm, bn)).astype(np.float32)
    blocks[cols < 0] = 0.0
    x = rng.standard_normal((nbc, bn, nv)).astype(np.float32)
    got = bsr_spmm_padded(torch.from_numpy(cols), torch.from_numpy(blocks),
                          torch.from_numpy(x))
    assert got.shape == (nbr, bm, nv) and got.dtype == torch.float32
    _close(got, ref_padded(jnp.asarray(cols), jnp.asarray(blocks),
                           jnp.asarray(x), interpret=True))
    assert torch.equal(got, bsr_spmm_padded_ref(torch.from_numpy(cols),
                                                torch.from_numpy(blocks),
                                                torch.from_numpy(x)))


BSR_MATRICES = [("poisson_12_8x8", ("poisson_2d", (12,)), (8, 8)),
                ("random_64_16x16", ("random_fixed_nnz", (64, 5)), (16, 16))]


@pytest.mark.parametrize("case", BSR_MATRICES, ids=[c[0] for c in BSR_MATRICES])
def test_bsr_ops_match_reference(case):
    _, (gen, args), (bm, bn) = case
    a_ref = getattr(ref_sparse, gen)(*args)
    a_port = getattr(port_sparse, gen)(*args)
    b_ref = ref_sparse.BSR.from_csr(a_ref, bm=bm, bn=bn)
    b_port = port_sparse.BSR.from_csr(a_port, bm=bm, bn=bn)
    for f in ("indptr", "indices", "data"):
        assert getattr(b_port, f).dtype == getattr(b_ref, f).dtype, f
        np.testing.assert_array_equal(getattr(b_port, f), getattr(b_ref, f))
    assert b_port.shape == b_ref.shape and b_port.density == b_ref.density
    np.testing.assert_array_equal(b_port.to_dense(), b_ref.to_dense())
    rng = np.random.default_rng(len(args) + bm)
    v = rng.standard_normal(b_port.shape[1])
    x = rng.standard_normal((a_port.shape[1], 3))  # unpadded: ops pad it
    np.testing.assert_allclose(b_port.matvec(v), b_ref.matvec(v), rtol=1e-12)
    w = bsr_spmv(b_port, v, device="cpu")
    assert w.device.type == "cpu" and w.shape == (b_port.shape[0],)
    _close(w, ref_ops.bsr_spmv(b_ref, v, interpret=True))
    _close(bsr_spmv_ref(b_port, v), ref_ops.bsr_spmv(b_ref, v, interpret=True))
    wm = bsr_spmm(b_port, x, device="cpu")
    assert wm.shape == (b_port.shape[0], 3)
    _close(wm, ref_ops.bsr_spmm(b_ref, x, interpret=True))
    np.testing.assert_allclose(w.numpy()[: a_port.shape[0]],
                               a_port.matvec(v[: a_port.shape[1]]),
                               rtol=1e-4, atol=1e-5)


def test_bsr_padded_on_cpu_launches_nothing():
    reset_launches()
    b = port_sparse.BSR.from_csr(port_sparse.poisson_2d(12), bm=8, bn=8)
    bsr_spmv(b, np.ones(b.shape[1]), device="cpu")
    assert sum(launches.values()) == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "bn", "contiguous"])
def test_bsr_padded_rejects_bad_operands(bad):
    rng = np.random.default_rng(3)
    cols = torch.from_numpy(rng.integers(-1, 4, size=(3, 2)).astype(np.int32))
    blocks = torch.zeros((3, 2, 8, 16))
    x = torch.zeros((4, 16, 2))
    if bad == "dtype":
        blocks = blocks.double()
    elif bad == "shape":
        cols = cols[:2].contiguous()
    elif bad == "bn":
        x = x[:, :8].contiguous()
    else:
        x = x.transpose(0, 2).contiguous().transpose(0, 2)
    with pytest.raises((TypeError, ValueError)):
        bsr_spmm_padded(cols, blocks, x)


@pytest.mark.parametrize("n_rows_pad, kmax", [(0, 0), (40, 7)])
def test_ell_spmv_ref_matches_reference(n_rows_pad, kmax):
    """``ell_spmv_ref`` over one ELL container, as the reference's (same
    container arrays, the same f32 products summed over the slots)."""
    import repro.sparse as ref_sparse
    from repro.kernels.ell_spmv import ell_spmv_ref as ref_ell_spmv
    import repro_torch.sparse as port_sparse
    from repro_torch.kernels.ell_spmv import ell_spmv_ref
    a_ref = ref_sparse.random_fixed_nnz(36, 5, seed=3)
    a_port = port_sparse.random_fixed_nnz(36, 5, seed=3)
    e_ref = ref_sparse.ELL.from_csr(a_ref, n_rows_pad=n_rows_pad, kmax=kmax)
    e_port = port_sparse.ELL.from_csr(a_port, n_rows_pad=n_rows_pad, kmax=kmax)
    np.testing.assert_array_equal(e_port.cols, e_ref.cols)
    np.testing.assert_array_equal(e_port.vals, e_ref.vals)
    v = np.random.default_rng(4).standard_normal(36).astype(np.float32)
    want = np.asarray(ref_ell_spmv(e_ref, v))
    got = ell_spmv_ref(e_port, torch.from_numpy(v))
    assert got.shape == want.shape == (e_ref.n_rows,)
    _close(got.numpy(), want)
    _close(ell_spmv_ref(e_port, v).numpy(), want)
