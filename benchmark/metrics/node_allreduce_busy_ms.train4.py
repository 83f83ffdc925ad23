"""node_allreduce_busy_ms.train4: device busy ms a traced step, on rank 0, of
the operations launched inside the span gaot.node_allreduce (the forward's
all-reduces: the encoder's accumulator, the loss's valid count and the
global loss), by launch correlation (stages.py). None for a program without
the span."""
from benchmark import stages


def read(record):
    return stages.busy_ms(record, "gaot.node_allreduce")
