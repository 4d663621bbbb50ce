from repro_torch.kernels.bsr_spmv.fused import (fused_bsr_spmm,
                                                fused_bsr_spmm_packed)
from repro_torch.kernels.bsr_spmv.kernel import bsr_spmm_padded
from repro_torch.kernels.bsr_spmv.ops import bsr_spmm, bsr_spmv
from repro_torch.kernels.bsr_spmv.ref import (bsr_spmm_padded_ref, bsr_spmv_ref,
                                              fused_bsr_spmm_packed_ref,
                                              fused_bsr_spmm_ref)

__all__ = ["fused_bsr_spmm", "fused_bsr_spmm_packed", "bsr_spmm_padded",
           "bsr_spmm", "bsr_spmv", "fused_bsr_spmm_ref",
           "fused_bsr_spmm_packed_ref", "bsr_spmm_padded_ref", "bsr_spmv_ref"]
