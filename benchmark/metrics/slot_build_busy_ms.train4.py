"""slot_build_busy_ms.train4: device busy ms a traced step, on rank 0, of the
operations launched inside the span gaot.slot_build (the slots the forward
builds from the rank's rows), read as slot_build_busy_ms.serve reads it."""
from benchmark import harness


def read(record):
    return harness.reader("slot_build_busy_ms.serve")(record)
