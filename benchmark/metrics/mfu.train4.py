"""mfu.train4: model operations of the global step (counting.train_step_flops
over the held shards' points and valid edges, the processor counted once
though every rank runs it) over the window's time a step, as a share of the
dense bf16 peak of every chip the step runs on."""
from benchmark import peaks


def read(record):
    flops, chips = record.counts.get("step_flops"), record.counts.get("chips")
    if not flops or not chips or not record.items or record.trace is None \
            or not record.trace.cuda:
        return None
    return 100.0 * flops / (record.window_s / record.items) / (chips * peaks.BF16_FLOPS)
