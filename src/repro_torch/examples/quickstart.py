"""Quickstart: node-aware SpMV through the port's operator API.

Builds a 2D anisotropic diffusion matrix, distributes it over a
(4 nodes x 4 processes) machine, and runs forward AND transpose SpMV
through one operator on both backends: the exact float64
message-passing simulator on the host and the rank-batched device
program (CUDA, or the CPU with ``--device cpu``); then prints the
communication win.  The flow is five lines::

    import repro_torch.api as nap
    op = nap.operator(a, Topology(n_nodes=4, ppn=4))
    w = op @ v         # forward SpMV (multi-RHS: v of shape [n, nv])
    z = op.T @ v       # transpose SpMV, same compiled plan reversed
    op.stats(); op.cost(BLUE_WATERS); op.autotune_report()

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
from typing import Optional, Sequence

import numpy as np

import repro_torch.api as nap
from repro_torch.core.cost_model import BLUE_WATERS
from repro_torch.core.topology import Topology
from repro_torch.sparse import random_fixed_nnz, rotated_anisotropic_2d


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="device of the device backend (default: CUDA)")
    args = ap.parse_args(argv)

    # -- problem + machine ----------------------------------------------------
    a = rotated_anisotropic_2d(32, eps=0.01, theta=np.pi / 6)
    topo = Topology(n_nodes=4, ppn=4)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(a.shape[0])
    want = a.matvec(v)
    want_t = a.transpose().matvec(v)

    # -- exact message-passing simulation through the operator ----------------
    for method in ("standard", "nap"):
        op = nap.operator(a, topo, method=method, backend="simulate")
        np.testing.assert_allclose(op @ v, want, rtol=1e-12)
        np.testing.assert_allclose(op.T @ v, want_t, rtol=1e-12)
    print("exactness: standard & NAP simulators match A@v and A.T@v")

    # -- communication statistics (the paper's Figs. 11/12 in miniature) ------
    # unstructured matrices are where the node-level dedup wins: many ranks
    # of one node need the same remote value, and NAP injects it once.
    ar = random_fixed_nnz(4096, 50, seed=0)
    op_std = nap.operator(ar, topo, method="standard", backend="simulate")
    op_nap = nap.operator(ar, topo, method="nap", backend="simulate")
    v0 = rng.standard_normal(4096)
    np.testing.assert_allclose(op_nap @ v0, ar.matvec(v0), rtol=1e-9, atol=1e-12)
    s, n = op_std.stats(), op_nap.stats()
    print("\nrandom 4096x4096, 50 nnz/row (the paper's unstructured case):")
    print(f"inter-node messages: standard {s['messages_inter'].total_msgs:4d}  "
          f"nap {n['messages_inter'].total_msgs:4d}")
    print(f"inter-node bytes:    standard {s['messages_inter'].total_bytes:6d}  "
          f"nap {n['messages_inter'].total_bytes:6d}")
    print(f"intra-node bytes:    standard {s['messages_intra'].total_bytes:6d}  "
          f"nap {n['messages_intra'].total_bytes:6d}   (cheap traffic grows)")
    ts = op_std.cost(BLUE_WATERS)["total"]
    tn = op_nap.cost(BLUE_WATERS)["total"]
    print(f"modeled comm time:   standard {ts:.2e}s  nap {tn:.2e}s  "
          f"({ts / tn:.2f}x)")

    # -- the same plan on the device: the rank-batched program ----------------
    op = nap.operator(a, topo, method="nap", device=args.device)
    np.testing.assert_allclose(op @ v, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(op.T @ v, want_t, rtol=1e-4, atol=1e-5)
    print(f"\nautotuned local compute: {op.local_compute} "
          f"(see op.autotune_report())")
    print(f"device NAPSpMV matches on {op.topo.n_procs} ranks batched on "
          f"{args.device or 'cuda'}")


if __name__ == "__main__":
    main()
