"""attn_roofline.train: the least time of a step's attention kernels (K1 with
dropout and K2; counting.attention_train at the bf16 peak and HBM rate) over
their device time by kernel name in the traced steps."""
from benchmark import counting


def read(record):
    tr = record.trace
    if tr is None or "attention" not in record.counts:
        return None
    seconds, launches = tr.kernel_seconds("flash_fwd", "flash_bwd")
    if launches == 0 or seconds <= 0:
        return None
    least = counting.least_seconds(*record.counts["attention"]) * tr.items
    return 100.0 * least / seconds
