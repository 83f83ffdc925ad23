"""optimizer_busy_ms.train: device busy ms a traced step of the operations
launched inside the span gaot.train.optimizer (the gradient norm and
AdamW's step), by launch correlation (stages.py)."""
from benchmark import stages


def read(record):
    return stages.busy_ms(record, "gaot.train.optimizer")
