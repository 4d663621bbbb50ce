"""Galerkin triple products (RAP) over the distributed SpGEMM.

The AMG setup's dominant communication is the coarse-grid construction
``A_c = R (A P)`` (Bienz et al., arXiv:1904.05838).  This module maps it
onto two node-aware SpGEMMs:

* ``AP = A @ P``: row partition = fine (A's rows), mid partition = fine
  (P's rows == A's columns);
* ``A_c = R @ AP``: row partition = coarse (R's rows), mid partition =
  fine (AP's rows == R's columns).

``galerkin_rap`` runs one triple product; ``distributed_rap`` returns a
``rap(r, a, p) -> CSR`` callable for
:func:`repro_torch.amg.hierarchy.smoothed_aggregation_hierarchy`, so
every level's coarse matrix assembles through the distributed path.
``cross_check=True`` holds each triple product against the host
:func:`repro_torch.amg.matmul.csr_matmul` (the simulate backend must
match it bit for bit).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.partition import RowPartition, contiguous_partition
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike
from repro_torch.sparse.csr import CSR
from repro_torch.spgemm.spgemm_torch import distributed_spgemm


def assert_matches_host(c: CSR, want: CSR, backend: str, label: str,
                        rtol: float = 5e-5) -> None:
    """Assert a distributed product matches the host ``csr_matmul``
    result: identical structure always; values bit for bit on the float64
    ``simulate`` backend, to ``rtol`` (float32 round-off) on the device
    backend, whose callers chaining products level to level scale
    ``rtol`` with the chain depth."""
    assert c.shape == want.shape, (label, c.shape, want.shape)
    assert np.array_equal(c.indptr, want.indptr) and \
        np.array_equal(c.indices, want.indices), \
        f"{label}: distributed SpGEMM structure diverged from host csr_matmul"
    if backend == "simulate":
        assert np.array_equal(c.data, want.data), \
            f"{label}: float64 simulate SpGEMM must be bit-for-bit equal " \
            f"to host csr_matmul"
    else:
        np.testing.assert_allclose(
            c.data, want.data, rtol=rtol,
            atol=0.1 * rtol * max(1.0, float(np.abs(want.data).max(initial=0.0))),
            err_msg=f"{label}: device SpGEMM values off vs host oracle")


def galerkin_rap(r: CSR, a: CSR, p: CSR, fine_part: RowPartition,
                 coarse_part: RowPartition, topo: Topology, *,
                 method: str = "nap", backend: str = "torch",
                 device: DeviceLike = None, dtype=None,
                 cross_check: bool = False) -> CSR:
    """Distributed ``A_c = R @ A @ P`` on (fine, coarse) partitions.

    ``backend="torch"`` (default) runs both products through the device
    program on ``device`` (CUDA unless ``device="cpu"``) in ``dtype``
    payloads; ``"simulate"`` is the exact float64 host path, bit for bit
    the host product.
    """
    if a.shape != (fine_part.n_rows, fine_part.n_rows):
        raise ValueError(f"A {a.shape} does not match the fine partition "
                         f"({fine_part.n_rows} rows)")
    if p.shape != (fine_part.n_rows, coarse_part.n_rows) or \
            r.shape != (coarse_part.n_rows, fine_part.n_rows):
        raise ValueError(f"P {p.shape} / R {r.shape} do not match "
                         f"fine={fine_part.n_rows}, "
                         f"coarse={coarse_part.n_rows}")
    kw = dict(method=method, backend=backend, device=device, dtype=dtype)
    ap = distributed_spgemm(a, p, fine_part, fine_part, topo, **kw)
    a_c = distributed_spgemm(r, ap, coarse_part, fine_part, topo, **kw)
    if cross_check:
        from repro_torch.amg.matmul import csr_matmul
        assert_matches_host(a_c, csr_matmul(r, csr_matmul(a, p)),
                            backend, "RAP")
    return a_c


def distributed_rap(topo: Topology, *, method: str = "nap",
                    backend: str = "torch", device: DeviceLike = None,
                    dtype=None, cross_check: bool = False,
                    make_part: Optional[Callable[[int], RowPartition]] = None
                    ) -> Callable[[CSR, CSR, CSR], CSR]:
    """A ``rap(r, a, p) -> CSR`` callable for the hierarchy builder.

    Each call derives the fine and coarse partitions from the operand
    shapes (``make_part(n)``, by default ``contiguous_partition(n,
    topo.n_procs)``: coarse levels smaller than the machine get empty
    ranks) and runs the two-product Galerkin chain through the
    distributed SpGEMM (``backend``, ``device``, ``dtype`` as in
    :func:`galerkin_rap`).  ``smoothed_aggregation_hierarchy(...,
    rap=distributed_rap(topo))`` makes the whole AMG setup node-aware.
    """
    mk = make_part or (lambda n: contiguous_partition(n, topo.n_procs))

    def rap(r: CSR, a: CSR, p: CSR) -> CSR:
        return galerkin_rap(r, a, p, mk(a.shape[0]), mk(p.shape[1]), topo,
                            method=method, backend=backend, device=device,
                            dtype=dtype, cross_check=cross_check)

    return rap
