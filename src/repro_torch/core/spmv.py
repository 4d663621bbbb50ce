"""Rank-local block splitting (Eqs. 4-7).

Each rank's rows split into on-process / on-node / off-node *column*
blocks, the three ``local_spmv`` operands of Algorithm 3; each block's
columns are renumbered into the buffer it multiplies against.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.partition import RowPartition
from repro_torch.core.topology import Topology
from repro_torch.sparse.csr import CSR


@dataclasses.dataclass
class LocalBlocks:
    """Rank-local matrix split by column class, with buffer-slot column maps.

    ``rows`` come from the ROW partition (output ownership), ``x_rows``
    from the COLUMN partition (x ownership).
    """

    rank: int
    rows: np.ndarray                 # global rows R(r), ascending
    on_proc: CSR                     # cols -> local x index on this rank
    on_node: CSR                     # cols -> slot in the on-node buffer
    off_node: CSR                    # cols -> slot in the off-node buffer
    on_node_cols: np.ndarray         # global col ids, buffer order (ascending)
    off_node_cols: np.ndarray
    x_rows: np.ndarray               # global x indices owned here, ascending


def split_local_blocks(a: CSR, part: RowPartition, topo: Topology, rank: int,
                       col_part: Optional[RowPartition] = None) -> LocalBlocks:
    cpart = part if col_part is None else col_part
    rows = part.rows_of(rank)
    x_rows = cpart.rows_of(rank)
    local = a.select_rows(rows)
    g_rows, g_cols, vals = local.to_coo()  # g_rows are positions within `rows`
    col_owner = cpart.owner[g_cols]
    col_node = topo.node_of_array(col_owner)
    me_node = topo.node_of(rank)

    on_proc_m = col_owner == rank
    on_node_m = (col_owner != rank) & (col_node == me_node)
    off_node_m = col_node != me_node

    # masked subsets of a row-major COO stay row-major: no re-sort
    op_cols = np.searchsorted(x_rows, g_cols[on_proc_m])
    on_proc = CSR.from_coo(g_rows[on_proc_m], op_cols, vals[on_proc_m],
                           (rows.size, x_rows.size), sum_duplicates=False,
                           assume_sorted=True)

    def buffer_block(mask: np.ndarray) -> Tuple[CSR, np.ndarray]:
        cols = np.unique(g_cols[mask])
        bc = np.searchsorted(cols, g_cols[mask])  # slot in ascending buffer
        blk = CSR.from_coo(g_rows[mask], bc, vals[mask],
                           (rows.size, max(int(cols.size), 1)),
                           sum_duplicates=False, assume_sorted=True)
        return blk, cols

    on_node, on_node_cols = buffer_block(on_node_m)
    off_node, off_node_cols = buffer_block(off_node_m)
    return LocalBlocks(rank=rank, rows=rows, on_proc=on_proc, on_node=on_node,
                       off_node=off_node, on_node_cols=on_node_cols,
                       off_node_cols=off_node_cols, x_rows=x_rows)


def split_all_blocks(a: CSR, part: RowPartition, topo: Topology,
                     col_part: Optional[RowPartition] = None) -> List[LocalBlocks]:
    return [split_local_blocks(a, part, topo, r, col_part=col_part)
            for r in range(topo.n_procs)]
