"""slot_build_idle_pct.serve: share of the slot build's extent on the device
timeline (its first operation's start to its last one's end, a request) with
none of its operations running: the card waiting on the host that launches
the build's chunk loop. Read under the profiler, so it compares a run only
with a run of the same benchmark."""
from benchmark import stages


def read(record):
    return stages.idle_pct(record, "gaot.slot_build")
