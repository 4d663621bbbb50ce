"""The paper's own experiment configuration (Sec. 5 defaults).

Not an LM architecture: it configures the node-aware SpMV experiments
(problem generators, topology, partitions) after the Blue Waters runs,
at the scale of a simulation on one machine.  Field for field the JAX
package's ``SpMVExperimentConfig``.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SpMVExperimentConfig:
    n_nodes: int = 32
    ppn: int = 16                       # Blue Waters XE: 16 cores/node
    pairing: str = "balanced"           # the paper's T/U rule
    bytes_per_val: int = 8              # f64 payloads, as MPI would send
    machine: str = "blue_waters"        # cost-model parameter set
    # problem families (Sec. 5)
    anisotropic_grid: int = 96          # rotated anisotropic 2D
    elasticity_grid: int = 48           # Q1 linear elasticity (2 dof/node)
    random_rows_per_proc: int = 1000    # weak scaling rows/process
    random_nnz_per_row: Tuple[int, ...] = (25, 50, 100)
    strong_scale_rows: int = 64_000     # scaled down from the paper's 4.096M


CONFIG = SpMVExperimentConfig()
