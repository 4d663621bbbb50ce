"""Exchange strategies of the distributed SpMV: the multi-step plan, its
traffic model, the strategy registry, the per-direction chooser and the
float64 multi-step simulators."""
from repro_torch.comm.autotune import (PREFERENCE, build_candidate_plans,
                                       choose_comm, comm_verdict)
from repro_torch.comm.cost import planned_traffic
from repro_torch.comm.multistep import (AUTO_THRESHOLD, MultistepPlan,
                                        build_multistep_plan,
                                        duplication_counts, multistep_stats,
                                        resolve_threshold)
from repro_torch.comm.simulate import (simulate_multistep_spmv,
                                       simulate_multistep_spmv_transpose)
from repro_torch.comm.strategies import (COMM_CHOICES, COMM_STRATEGIES,
                                         CommStrategy, available_strategies,
                                         get_strategy)

__all__ = [
    "AUTO_THRESHOLD", "COMM_CHOICES", "COMM_STRATEGIES", "CommStrategy",
    "MultistepPlan", "PREFERENCE", "available_strategies",
    "build_candidate_plans",
    "build_multistep_plan", "choose_comm", "comm_verdict",
    "duplication_counts", "get_strategy", "multistep_stats",
    "planned_traffic", "resolve_threshold", "simulate_multistep_spmv",
    "simulate_multistep_spmv_transpose",
]
