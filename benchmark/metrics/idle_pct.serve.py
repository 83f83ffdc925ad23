"""idle_pct.serve: share of a request's time with no operation on the card: the
device busy time (torch.profiler, the union of device operations) a traced
request, over the unprofiled window's time a request. Not over the traced
segment's own wall time: the profiler slows the host that launches the
work, and the card waits on it."""


def read(record):
    tr = record.trace
    if tr is None or not tr.device or not tr.items or not record.items:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.items) / (record.window_s / record.items))
