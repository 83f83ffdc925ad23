"""k5b_roofline.train4: the least time of the encoder payload's backward
kernel K5b over rank 0's traced steps (counting_backward.payload_backward:
its products on rank 0's valid edges of each traced mesh at the peak of its
body's precision, its bytes at the HBM rate) over K5b's device time by
kernel name."""
from benchmark import counting


def read(record):
    tr = record.trace
    if tr is None or not tr.cuda or "payload_backward" not in record.counts:
        return None
    seconds, launches = tr.kernel_seconds("encoder_backward")
    if launches == 0 or seconds <= 0:
        return None
    least = sum(counting.least_seconds(f, b, rate)
                for f, b, rate in record.counts["payload_backward"])
    return 100.0 * least / seconds
