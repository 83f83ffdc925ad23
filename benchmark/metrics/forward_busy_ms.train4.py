"""forward_busy_ms.train4: device busy ms a traced step, on rank 0, of the
operations launched inside the span gaot.train.forward (the forward and
masked MSE), read as forward_busy_ms.train reads it."""
from benchmark import harness


def read(record):
    return harness.reader("forward_busy_ms.train")(record)
