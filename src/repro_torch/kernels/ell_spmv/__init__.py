from repro_torch.kernels.ell_spmv.kernel import ell_spmm_packed
from repro_torch.kernels.ell_spmv.ref import ell_spmm_packed_ref, ell_spmv_ref

__all__ = ["ell_spmm_packed", "ell_spmm_packed_ref", "ell_spmv_ref"]
