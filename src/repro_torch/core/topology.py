"""Process/node topology: the paper's rank <-> (p, n) machinery (Sec. 2).

A rank r in [0, n_p) is the tuple (p, n) with ``p = r % ppn`` the local
process id and ``n = r // ppn`` the node id (SMP-style ordering).  On one
GPU the ranks are the leading batch axis of every plan tensor, in this
order, so a ``[n_procs, ...]`` tensor views as ``[n_nodes, ppn, ...]``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """An SMP-ordered machine of ``n_nodes`` nodes with ``ppn`` processes each."""

    n_nodes: int
    ppn: int

    def __post_init__(self) -> None:
        if self.n_nodes < 1 or self.ppn < 1:
            raise ValueError(f"bad topology ({self.n_nodes} nodes x {self.ppn} ppn)")

    @property
    def n_procs(self) -> int:
        return self.n_nodes * self.ppn

    def proc_node(self, rank: int) -> Tuple[int, int]:
        """``rank -> (p, n)``, Sec. 2: ``(rank mod ppn, rank // ppn)``."""
        if not 0 <= rank < self.n_procs:
            raise ValueError(f"rank {rank} out of range [0, {self.n_procs})")
        return rank % self.ppn, rank // self.ppn

    def rank(self, p: int, n: int) -> int:
        if not (0 <= p < self.ppn and 0 <= n < self.n_nodes):
            raise ValueError(f"({p},{n}) outside ({self.ppn} ppn, {self.n_nodes} nodes)")
        return n * self.ppn + p

    def node_of(self, rank: int) -> int:
        return rank // self.ppn

    def local_of(self, rank: int) -> int:
        return rank % self.ppn

    def ranks_on_node(self, n: int) -> range:
        return range(n * self.ppn, (n + 1) * self.ppn)

    def same_node(self, r: int, t: int) -> bool:
        return self.node_of(r) == self.node_of(t)

    def iter_ranks(self) -> Iterator[int]:
        return iter(range(self.n_procs))

    def node_of_array(self, ranks: np.ndarray) -> np.ndarray:
        return np.asarray(ranks) // self.ppn

    def local_of_array(self, ranks: np.ndarray) -> np.ndarray:
        return np.asarray(ranks) % self.ppn


def paper_example_topology() -> Topology:
    """Example 2.1: six processes across three nodes (ppn = 2)."""
    return Topology(n_nodes=3, ppn=2)
