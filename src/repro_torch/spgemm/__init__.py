"""Node-aware distributed SpGEMM: ``C = A @ B`` over independent row
partitions, routed through the paper's three-step exchange with
row-block payloads, on one device (:mod:`.spgemm_torch`) or in the
float64 simulators (:mod:`.simulate`)."""
from repro_torch.spgemm.plan import SpGemmPlan, build_spgemm_plan
from repro_torch.spgemm.rap import (assert_matches_host, distributed_rap,
                                    galerkin_rap)
from repro_torch.spgemm.simulate import (simulate_nap_spgemm, simulate_spgemm,
                                         simulate_standard_spgemm)
from repro_torch.spgemm.spgemm_torch import (CompiledSpGemm, clear_spgemm_cache,
                                             compile_spgemm, distributed_spgemm,
                                             pack_b_values, spgemm_program,
                                             torch_spgemm_runs, unpack_c_values)

__all__ = [
    "SpGemmPlan", "build_spgemm_plan",
    "simulate_nap_spgemm", "simulate_standard_spgemm", "simulate_spgemm",
    "CompiledSpGemm", "compile_spgemm", "spgemm_program",
    "distributed_spgemm", "pack_b_values", "unpack_c_values",
    "clear_spgemm_cache", "torch_spgemm_runs",
    "galerkin_rap", "distributed_rap", "assert_matches_host",
]
