"""idle_pct.train4: share of a step's time with no operation on rank 0's
card, read as idle_pct.train reads it. An NCCL kernel that waits for a
slower rank counts as busy."""
from benchmark import harness


def read(record):
    return harness.reader("idle_pct.train")(record)
