"""The share of the traced stretch (first request's start to last
request's end) in which no operation runs on the card."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "request_p95_ms"


def read(record):
    t = record.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
