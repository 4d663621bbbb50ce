"""SpMV rate over the window: 2 x nnz x nv for every apply completed,
forward and transpose alike, over the window's seconds (host clock; the
window ends at its last request's sync)."""
from benchport import yardstick

UNIT, BETTER, SOURCE = "GFLOP/s", "higher", "host_clock"


def read(record):
    w = record["window"]
    return yardstick.apply_flops(record["nnz"], record["nv"]) * w["applies"] \
        / w["seconds"] / 1e9
