"""Smoothed-aggregation AMG on the host, solved through the port's
distributed operators on the device."""
from repro_torch.amg.hierarchy import Level, smoothed_aggregation_hierarchy
from repro_torch.amg.matmul import csr_matmul
from repro_torch.amg.solve import (LevelOperators, amg_vcycle, bicgstab_solve,
                                   cg_solve, jacobi, level_operators)

__all__ = ["Level", "LevelOperators", "smoothed_aggregation_hierarchy",
           "csr_matmul", "amg_vcycle", "bicgstab_solve", "cg_solve", "jacobi",
           "level_operators"]
