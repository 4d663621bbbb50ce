"""The 95th percentile (nearest rank) of all the window's requests, each
timed on the host from its issue to the sync that ends it."""
from benchport import yardstick

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(record):
    return yardstick.percentile(record["window"]["latencies_s"], 95) * 1e3
