"""encode_busy_ms.train4: device busy ms a traced step, on rank 0, of the
operations launched inside the span gaot.encode (the MAGNO encoder over the
rank's slots, its all-reduce included), read as encode_busy_ms.serve reads
it."""
from benchmark import harness


def read(record):
    return harness.reader("encode_busy_ms.serve")(record)
