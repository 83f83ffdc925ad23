"""allreduce_busy_ms.train4: device busy ms a traced step, on rank 0, of the
operations launched inside the span gaot.train.allreduce (the gradients'
all-reduce, one flat buffer), by launch correlation (stages.py)."""
from benchmark import stages


def read(record):
    return stages.busy_ms(record, "gaot.train.allreduce")
