"""mfu.serve: model operations of one forward (matrix products over the
ring's valid edges, counting.forward_flops) over the window's wall time a
request, as a share of the H100's dense bf16 peak."""
from benchmark import peaks


def read(record):
    flops = record.counts.get("forward_flops")
    if not flops or not record.items or record.trace is None or not record.trace.cuda:
        return None
    return 100.0 * flops / (record.window_s / record.items) / peaks.BF16_FLOPS
