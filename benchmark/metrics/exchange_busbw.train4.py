"""exchange_busbw.train4: the exchange's share of its roofline on rank 0: the
bus bytes a traced step, the bytes the program counts as all-reduced
(parallel/sharding.py `all_reduce_.bytes`) times 2(n - 1)/n for a ring
all-reduce over n ranks, over the NCCL kernels' device time a step
(exchange_ms.train4), against NVLINK_BYTES. None for a program that does
not count the bytes."""
from benchmark import harness

NVLINK_BYTES = 450e9  # H100 SXM, NVLink 4: 18 links of 25 GB/s, one direction


def read(record):
    nbytes, n = record.counts.get("exchanged_bytes"), record.counts.get("chips")
    ms = harness.reader("exchange_ms.train4")(record)
    if not nbytes or not n or not ms:
        return None
    return 100.0 * nbytes * 2 * (n - 1) / n / (1e-3 * ms) / NVLINK_BYTES
