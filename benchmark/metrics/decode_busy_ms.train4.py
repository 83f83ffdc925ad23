"""decode_busy_ms.train4: device busy ms a traced step, on rank 0, of the
operations launched inside the span gaot.decode (the MAGNO decoder over the
rank's rows), read as decode_busy_ms.serve reads it."""
from benchmark import harness


def read(record):
    return harness.reader("decode_busy_ms.serve")(record)
