"""The host layout's build in set-up: ``api.operator``, the plan
(``compile_nap``, ``core/comm_graph.py``) and the ELL layouts of both
directions (``ensure_ell``, ``ensure_ell_t``), by the host clock."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
LAYER = "host layout"
MOVES = "setup_s"


def read(record):
    return record["plan_build_s"]
