"""Row partitions of an N x N system across n_p ranks (Sec. 2, Eq. 2; Sec. 5).

* ``contiguous`` — Eq. (2): rank r owns a contiguous run of rows (the
  remainder rows go to the leading ranks).
* ``strided``    — row i lives on rank ``i mod n_p``.
* :func:`partition_from_owner` — any ownership map, e.g. one that leaves
  ranks empty.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Ownership map of N global rows over n_p ranks.

    ``owner[i]`` — rank owning global row i.
    ``perm``     — global rows sorted by (owner, row): the local storage
                   order; ``perm[first[r]:first[r+1]]`` are rank r's rows.
    ``first``    — offsets into ``perm`` per rank (len n_p + 1).
    """

    n_rows: int
    n_procs: int
    owner: np.ndarray
    perm: np.ndarray
    first: np.ndarray
    kind: str = "contiguous"

    def rows_of(self, rank: int) -> np.ndarray:
        """R(r): global rows stored on ``rank`` (ascending)."""
        return self.perm[self.first[rank] : self.first[rank + 1]]

    def counts(self) -> np.ndarray:
        return np.diff(self.first)

    def local_index(self) -> np.ndarray:
        """global row -> index within its owner's local block."""
        loc = np.empty(self.n_rows, dtype=np.int64)
        loc[self.perm] = (np.arange(self.n_rows, dtype=np.int64)
                          - np.repeat(self.first[:-1], self.counts()))
        return loc

    def validate(self) -> None:
        assert self.owner.shape == (self.n_rows,)
        assert self.first.shape == (self.n_procs + 1,)
        assert self.first[0] == 0 and self.first[-1] == self.n_rows
        assert np.array_equal(np.sort(self.perm), np.arange(self.n_rows)), \
            "perm must be a permutation"
        assert np.array_equal(self.owner[self.perm],
                              np.repeat(np.arange(self.n_procs), self.counts()))


def partition_from_owner(owner: np.ndarray, n_procs: int,
                         kind: str = "owner") -> RowPartition:
    """Partition from an explicit ``owner[i]`` map (ranks may own no row)."""
    owner = np.asarray(owner)
    perm = np.argsort(owner, kind="stable").astype(np.int64)
    counts = np.bincount(owner, minlength=n_procs)
    first = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    part = RowPartition(n_rows=owner.shape[0], n_procs=n_procs,
                        owner=owner.astype(np.int64), perm=perm, first=first,
                        kind=kind)
    part.validate()
    return part


def contiguous_partition(n_rows: int, n_procs: int) -> RowPartition:
    """Eq. (2) with remainder rows distributed over the leading ranks."""
    base, extra = divmod(n_rows, n_procs)
    counts = np.full(n_procs, base, dtype=np.int64)
    counts[:extra] += 1
    return partition_from_owner(np.repeat(np.arange(n_procs), counts),
                                n_procs, "contiguous")


def strided_partition(n_rows: int, n_procs: int) -> RowPartition:
    """Sec. 5: row i on process i mod n_p."""
    return partition_from_owner(np.arange(n_rows, dtype=np.int64) % n_procs,
                                n_procs, "strided")
