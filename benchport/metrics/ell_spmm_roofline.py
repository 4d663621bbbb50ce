"""The ELL kernel's share of its roofline: an apply's floor (the CSR,
operand and result once at 3.35 TB/s, or its operations at the float32
rate, whichever is longer) over the kernel's device time an apply that
launched it, in the traced stretch.  Applies whose local product takes
another form (the random family's transpose runs COO) do not count."""
from benchport import yardstick

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "spmv_gflop_s"
KERNEL = "ell_spmm"


def read(record):
    t = record.get("trace")
    ops = [o for o in (t["ops"] if t else [])
           if o["owner"] == "benchport.program" and KERNEL in o["name"]]
    us = sum(o["dur"] for o in ops)
    if us <= 0:
        return None
    applies = len({o["call"] for o in ops})
    floor = yardstick.floor_seconds(
        yardstick.apply_floor_bytes(record["n"], record["n"], record["nnz"], record["nv"]),
        yardstick.apply_flops(record["nnz"], record["nv"]))
    return 100.0 * floor / (us / 1e6 / applies)
