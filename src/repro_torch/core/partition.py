"""Row partitions of an N x N system across n_p ranks (Sec. 2, Eq. 2; Sec. 5).

* ``contiguous`` — Eq. (2): rank r owns a contiguous run of rows (the
  remainder rows go to the leading ranks).
* ``strided``    — row i lives on rank ``i mod n_p``.
* ``balanced``   — graph-partitioned surrogate for PT-Scotch: recursive
  min-cut bisection over the matrix adjacency graph.
* :func:`partition_from_owner` — any ownership map, e.g. one that leaves
  ranks empty.
* :func:`survivor_partition` — ``elastic``: the survivors of a rank loss
  keep their rows and take the orphans in a waterfill.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


def balanced_partition(indptr: np.ndarray, indices: np.ndarray, n_procs: int,
                       seed: int = 0, max_iters: int = 8) -> RowPartition:
    """Greedy KL-flavoured recursive bisection (PT-Scotch stand-in).

    Splits the row set in halves minimising cut edges, recursively, until
    n_procs parts exist (n_procs must be a power of two for the recursion;
    otherwise falls back to contiguous on the remainder split).
    """
    n_rows = len(indptr) - 1
    rng = np.random.default_rng(seed)
    owner = np.zeros(n_rows, dtype=np.int64)

    def bisect(rows: np.ndarray, lo: int, hi: int) -> None:
        nparts = hi - lo
        if nparts == 1 or rows.size == 0:
            owner[rows] = lo
            return
        half = nparts // 2
        target_left = rows.size * half // nparts
        # BFS growth from a peripheral seed gives a contiguous-ish half.
        in_set = np.zeros(n_rows, dtype=bool)
        in_set[rows] = True
        side = np.full(n_rows, -1, dtype=np.int8)  # 0 = left, 1 = right
        start = rows[rng.integers(rows.size)]
        frontier = [start]
        side[rows] = 1
        taken = 0
        seen = np.zeros(n_rows, dtype=bool)
        seen[start] = True
        while frontier and taken < target_left:
            nxt = []
            for u in frontier:
                if taken >= target_left:
                    break
                side[u] = 0
                taken += 1
                for v in indices[indptr[u] : indptr[u + 1]]:
                    if in_set[v] and not seen[v]:
                        seen[v] = True
                        nxt.append(v)
            frontier = nxt
        if taken < target_left:  # disconnected: top up arbitrarily
            rest = rows[side[rows] == 1]
            need = target_left - taken
            side[rest[:need]] = 0
        # one pass of boundary refinement (move vertices that reduce cut, keep balance)
        for _ in range(max_iters):
            moved = 0
            for u in rows:
                s = side[u]
                nbr = indices[indptr[u] : indptr[u + 1]]
                nbr = nbr[in_set[nbr]]
                if nbr.size == 0:
                    continue
                same = int(np.sum(side[nbr] == s))
                other = nbr.size - same
                if other > same:
                    cnt_left = int(np.sum(side[rows] == 0))
                    if s == 0 and cnt_left - 1 >= target_left - rows.size // (4 * nparts):
                        side[u] = 1
                        moved += 1
                    elif s == 1 and cnt_left + 1 <= target_left + rows.size // (4 * nparts):
                        side[u] = 0
                        moved += 1
            if moved == 0:
                break
        left = rows[side[rows] == 0]
        right = rows[side[rows] == 1]
        bisect(left, lo, lo + half)
        bisect(right, lo + half, hi)

    bisect(np.arange(n_rows, dtype=np.int64), 0, n_procs)
    return partition_from_owner(owner, n_procs, "balanced")


def survivor_partition(part: RowPartition, dead_ranks) -> RowPartition:
    """Repartition after rank loss (the serve layer's elastic rebuild).

    Surviving ranks KEEP every row they own, so only the dead ranks'
    orphaned rows move.  Each survivor's intake comes from a waterfill
    (top up the lightest survivor, ties to the lowest new rank), then the
    orphans are dealt out in ascending global order in runs of those
    counts: deterministic.  Ranks renumber compactly in surviving order,
    matching ``ElasticPolicy.survivor_topology``'s shrunken topology.
    """
    dead = sorted({int(r) for r in dead_ranks})
    for r in dead:
        if not 0 <= r < part.n_procs:
            raise ValueError(f"dead rank {r} outside [0, {part.n_procs})")
    survivors = [r for r in range(part.n_procs) if r not in set(dead)]
    if not survivors:
        raise ValueError("no surviving ranks to repartition onto")
    n_new = len(survivors)
    remap = np.full(part.n_procs, -1, dtype=np.int64)
    remap[survivors] = np.arange(n_new)
    mapped = remap[part.owner]
    alive = mapped >= 0
    owner = np.empty(part.n_rows, dtype=np.int64)
    owner[alive] = mapped[alive]
    orphans = np.flatnonzero(~alive)
    loads = np.bincount(mapped[alive], minlength=n_new).astype(np.int64)
    add = np.zeros(n_new, dtype=np.int64)
    for _ in range(orphans.size):
        i = int(np.argmin(loads + add))
        add[i] += 1
    owner[orphans] = np.repeat(np.arange(n_new), add)
    return partition_from_owner(owner, n_new, "elastic")


def make_partition(kind: str, n_rows: int, n_procs: int,
                   indptr: Optional[np.ndarray] = None,
                   indices: Optional[np.ndarray] = None, seed: int = 0) -> RowPartition:
    if kind == "contiguous":
        return contiguous_partition(n_rows, n_procs)
    if kind == "strided":
        return strided_partition(n_rows, n_procs)
    if kind == "balanced":
        if indptr is None or indices is None:
            raise ValueError("balanced partition needs the matrix structure")
        return balanced_partition(indptr, indices, n_procs, seed=seed)
    raise ValueError(f"unknown partition kind {kind!r}")
