from repro_torch.kernels.bsr_spmv.fused import (fused_bsr_spmm,
                                                fused_bsr_spmm_packed)
from repro_torch.kernels.bsr_spmv.ref import (fused_bsr_spmm_packed_ref,
                                              fused_bsr_spmm_ref)

__all__ = ["fused_bsr_spmm", "fused_bsr_spmm_packed",
           "fused_bsr_spmm_ref", "fused_bsr_spmm_packed_ref"]
