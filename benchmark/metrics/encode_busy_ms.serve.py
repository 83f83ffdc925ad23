"""encode_busy_ms.serve: device busy ms a traced request of the operations
launched inside the span gaot.encode (the MAGNO encoder over the built
slots), by launch correlation (stages.py)."""
from benchmark import stages


def read(record):
    return stages.busy_ms(record, "gaot.encode")
