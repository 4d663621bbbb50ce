"""The frozen generators give the program's matrices, entry for entry."""
import numpy as np
import pytest

from benchport.problems import random_fixed_nnz, rotated_anisotropic_2d
from repro_torch.sparse import generators


def same(frozen, csr):
    indptr, indices, data, shape = frozen
    assert shape == csr.shape
    assert indptr.dtype == csr.indptr.dtype and indices.dtype == csr.indices.dtype
    assert data.dtype == csr.data.dtype
    assert np.array_equal(indptr, csr.indptr)
    assert np.array_equal(indices, csr.indices)
    assert np.array_equal(data, csr.data)


@pytest.mark.parametrize("n", [1, 2, 3, 16, 45])
@pytest.mark.parametrize("eps, theta", [(0.001, np.pi / 6), (1.0, 0.0), (0.1, 1.0)])
def test_rotated_anisotropic_2d(n, eps, theta):
    same(rotated_anisotropic_2d.build(n, eps, theta),
         generators.rotated_anisotropic_2d(n, eps, theta))


@pytest.mark.parametrize("n_rows, k, seed", [
    (10, 5, 0), (64, 50, 3), (500, 25, 2 ** 31 + 5), (200, 100, 7), (40, 40, 11)])
def test_random_fixed_nnz(n_rows, k, seed):
    same(random_fixed_nnz.build(n_rows, k, seed),
         generators.random_fixed_nnz(n_rows, k, seed))


def test_seeded_flags():
    assert random_fixed_nnz.SEEDED and not rotated_anisotropic_2d.SEEDED


def test_fixed_pattern_keeps_the_plan_and_draws_values_from_the_seed():
    a = random_fixed_nnz.build(300, 20, seed=5, pattern_seed=99)
    b = random_fixed_nnz.build(300, 20, seed=6, pattern_seed=99)
    c = random_fixed_nnz.build(300, 20, seed=99)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1])
    assert not np.array_equal(a[2], b[2])
    same(random_fixed_nnz.build(300, 20, seed=5, pattern_seed=5),
         generators.random_fixed_nnz(300, 20, 5))
