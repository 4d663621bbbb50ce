"""The device program's share of its roofline: the request's floor (each
apply's CSR, operand and result once at 3.35 TB/s, or its operations at
the float32 rate, whichever is longer) over the device time a request of
the operations that the program launched (``benchport.program``), taken
as the union of their intervals in the traced stretch, so that
operations that overlap count once.  The host's launches and the gaps
between the program's operations are not in it."""
from benchport import yardstick

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "device program"
MOVES = "spmv_gflop_s"
OWNER = "benchport.program"


def read(record):
    t = record.get("trace")
    if not t or not t["requests"]:
        return None
    spans = sorted((o["start"], o["start"] + o["dur"]) for o in t["ops"]
                   if o["owner"] == OWNER)
    busy_us, cursor = 0.0, None
    for start, end in spans:
        if cursor is None or start > cursor:
            busy_us += end - start
            cursor = end
        elif end > cursor:
            busy_us += end - cursor
            cursor = end
    if busy_us <= 0:
        return None
    floor = record["applies_per_request"] * yardstick.floor_seconds(
        yardstick.apply_floor_bytes(record["n"], record["n"], record["nnz"], record["nv"]),
        yardstick.apply_flops(record["nnz"], record["nv"]))
    return 100.0 * floor / (busy_us / 1e6 / t["requests"])
