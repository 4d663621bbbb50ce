from repro_torch.sparse.bsr import BSR
from repro_torch.sparse.csr import CSR, expand_positions
from repro_torch.sparse.ell import ELL, stack_ell
from repro_torch.sparse.generators import (linear_elasticity_2d, poisson_2d,
                                           random_fixed_nnz,
                                           rotated_anisotropic_2d)

__all__ = ["CSR", "BSR", "ELL", "stack_ell", "expand_positions",
           "linear_elasticity_2d", "poisson_2d", "random_fixed_nnz",
           "rotated_anisotropic_2d"]
