"""slot_build_busy_ms.serve: device busy ms a traced request of the operations
launched inside the span gaot.slot_build (the slots the forward builds on the
card: the stencil window and compact_slots' sort), by launch correlation
(stages.py)."""
from benchmark import stages


def read(record):
    return stages.busy_ms(record, "gaot.slot_build")
