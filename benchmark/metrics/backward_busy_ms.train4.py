"""backward_busy_ms.train4: device busy ms a traced step, on rank 0, of the
operations launched inside the span gaot.train.backward (autograd's
backward), read as backward_busy_ms.train reads it."""
from benchmark import harness


def read(record):
    return harness.reader("backward_busy_ms.train")(record)
