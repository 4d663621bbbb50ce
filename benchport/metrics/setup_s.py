"""Set-up seconds: from the start of the run's process to the start of
the window (imports, the card's start, the matrix, the program's plan,
staging and warm-up; in the checkout's first run also the kernels'
build)."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(record):
    return record["setup_s"]
