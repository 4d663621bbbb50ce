"""Device ms a request of everything the program launches except its
local product: the exchanges' gathers, copies and all-to-alls, the
transpose's scatter-adds, and the padding's fills (traced stretch)."""
UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "device program"
MOVES = "spmv_gflop_s"
#: kernel names that carry the local product (the ELL kernel of csrc/ell_spmm.cu)
LOCAL_PRODUCT = ("ell_spmm",)


def read(record):
    t = record.get("trace")
    if not t or not t["requests"]:
        return None
    ops = [o for o in t["ops"] if o["owner"] == "benchport.program"]
    if not ops:
        return None
    us = sum(o["dur"] for o in ops
             if not any(k in o["name"] for k in LOCAL_PRODUCT))
    return us / 1e3 / t["requests"]
