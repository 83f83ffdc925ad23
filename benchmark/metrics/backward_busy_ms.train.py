"""backward_busy_ms.train: device busy ms a traced step of the operations
launched inside the span gaot.train.backward (autograd's backward, launched
from its own thread while the step waits in .backward()), by launch
correlation (stages.py)."""
from benchmark import stages


def read(record):
    return stages.busy_ms(record, "gaot.train.backward")
