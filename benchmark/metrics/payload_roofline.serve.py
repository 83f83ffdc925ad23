"""payload_roofline.serve: the least time of the encoder payload kernel K5
over the traced requests (counting.payload: its kernel MLP's products on each
traced request's valid edges at the peak of its body's precision, its bytes at the
HBM rate) over K5's device time by kernel name."""
from benchmark import counting


def read(record):
    tr = record.trace
    if tr is None or "payload" not in record.counts:
        return None
    seconds, launches = tr.kernel_seconds("encoder_accumulate")
    if launches == 0 or seconds <= 0:
        return None
    least = sum(counting.least_seconds(f, b, rate) for f, b, rate in record.counts["payload"])
    return 100.0 * least / seconds
