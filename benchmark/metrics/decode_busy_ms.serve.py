"""decode_busy_ms.serve: device busy ms a traced request of the operations
launched inside the span gaot.decode (the MAGNO decoder over every node), by
launch correlation (stages.py)."""
from benchmark import stages


def read(record):
    return stages.busy_ms(record, "gaot.decode")
