"""mfu.train: model operations of a training step (three forwards' matrix
products over the ring's valid edges, counting.train_step_flops) over the
window's time a step, as a share of the H100's dense bf16 peak."""
from benchmark import peaks


def read(record):
    flops = record.counts.get("step_flops")
    if not flops or not record.items or record.trace is None or not record.trace.cuda:
        return None
    return 100.0 * flops / (record.window_s / record.items) / peaks.BF16_FLOPS
