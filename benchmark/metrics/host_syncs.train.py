"""host_syncs.train: the runtime calls that block the host on the card
(stream, event or device synchronize, a synchronous copy; stages.SYNCS) whose
host start lies inside the span gaot.train.step, on any thread, over the
traced steps. Read from the profiler's trace, so a blocking read that no one
annotated counts too. None without a CUDA trace or without the span."""
from benchmark import stages


def read(record):
    return stages.host_syncs(record, "gaot.train.step")
