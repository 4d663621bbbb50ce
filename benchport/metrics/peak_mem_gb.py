"""The card's peak of allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), in GB of 10^9 bytes."""
UNIT, BETTER, SOURCE = "GB", "lower", "device_trace"


def read(record):
    return record["peak_bytes"] / 1e9 if record["peak_bytes"] else None
