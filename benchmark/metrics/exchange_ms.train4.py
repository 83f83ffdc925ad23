"""exchange_ms.train4: device ms a traced step of the NCCL kernels (the
all-reduces of a node-sharded step: the encoder's accumulator and its
cotangent, the loss's count and value, the gradients), by kernel name, on
rank 0. An NCCL kernel runs from its launch until every rank has joined, so
this holds the wait for the slowest rank too."""


def read(record):
    tr = record.trace
    if tr is None or not tr.cuda or not tr.items:
        return None
    seconds, launches = tr.kernel_seconds("nccl")
    if launches == 0:
        return None
    return 1e3 * seconds / tr.items
