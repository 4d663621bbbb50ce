"""The benchmark's arithmetic against counts made by hand."""
import math

import pytest

from benchport import yardstick
from benchport.problems import rotated_anisotropic_2d


def test_flops_by_hand():
    # aniso2d-2024: (3 x 2024 - 2)^2 = 36,844,900 nonzeros
    assert yardstick.apply_flops(36_844_900, 1) == 73_689_800
    # block8: forward and transpose at nv = 8 a request
    assert 2 * yardstick.apply_flops(36_844_900, 8) == 1_179_036_800


def test_byte_floor_by_hand():
    # 8 B a nonzero (value, column), 4 B a row offset, x and y at 4 B
    n, nnz = 4_096_576, 36_844_900
    assert yardstick.apply_floor_bytes(n, n, nnz, 1) == (
        294_759_200 + 16_386_308 + 32_772_608) == 343_918_116
    assert yardstick.floor_seconds(343_918_116) == pytest.approx(1.02662e-4, rel=1e-5)
    assert yardstick.apply_floor_bytes(n, n, nnz, 8) == 343_918_116 + 7 * 32_772_608
    # random50-512k, 25,598,768 nonzeros in the issue's draw
    assert yardstick.apply_floor_bytes(512_000, 512_000, 25_598_768, 1) == (
        204_790_144 + 2_048_004 + 4_096_000)


def test_floor_of_a_small_stencil_by_hand():
    indptr, indices, _, (n, _) = rotated_anisotropic_2d.build(3, 0.001, math.pi / 6)
    # 9 rows: 4 corners of 4, 4 edges of 6, 1 centre of 9
    assert indices.size == 49 == (3 * 3 - 2) ** 2
    assert yardstick.apply_floor_bytes(n, n, indices.size, 1) == 49 * 8 + 10 * 4 + 18 * 4
    assert yardstick.floor_seconds(0, 67e12) == 1.0


@pytest.mark.parametrize("values, q, want", [
    (list(range(1, 101)), 95, 95),
    (list(range(20, 0, -1)), 95, 19),
    ([7.5], 95, 7.5),
    ([3, 1, 2], 50, 2),
    ([1] * 94 + [50] * 6, 95, 50),
])
def test_percentile_over_all_requests(values, q, want):
    assert yardstick.percentile(values, q) == want


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)

