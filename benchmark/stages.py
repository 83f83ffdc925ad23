"""Per-stage readings of a traced segment: the device operations that each of
the program's spans (`gaot3d_tpu_torch/tracing.py`, names `gaot.*`) launched,
and the runtime calls inside them that blocked the host on the device, read
again from the torch.profiler session of `trace.Trace`.

Attribution is by launch: a device operation and the runtime call that
launched it (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaMemcpyAsync`, ...)
share a correlation id, and the operation belongs to every occurrence of a
span whose host range holds the start of that call, on any thread (the
backward's kernels are launched by autograd's own thread while the step's
thread is inside `gaot.train.backward`). The device-side ranges the profiler
lays for each host range are annotations, as `Trace` reads them, and are not
used: they follow only the launches of the range's own thread.

A stage's busy time is the union of its operations' device time; its extent,
for each occurrence, runs from its first operation's start to its last one's
end. A host sync is a runtime call that returns only when the device has
caught up (`SYNCS`: a `.item()`, `.tolist()`, `bool()` of a device tensor or
a boolean index each make one stream synchronize), counted where its start
lies inside the span, on any thread. Every reader returns None without a
CUDA trace, or when the span is not in it (a program without these spans).
The session is read once a record, however many readers ask."""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import torch

RUNTIME = "cu"  # the calls that launch device work: cudaLaunchKernel, cuLaunchKernel, ...
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
                   "cuEventSynchronize", "cuMemcpyDtoH", "cuMemcpyDtoH_v2"))


class Stages:
    """The device operations of one profiler session, each with the host time
    of its launch; the host start of each blocking runtime call; and the
    host ranges of the program's spans."""

    def __init__(self, events):
        dev = torch.autograd.DeviceType.CUDA
        launch: Dict[int, float] = {}
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.syncs: List[float] = []
        ops = []
        for e in events:
            if e.device_type == dev:
                if not getattr(e, "is_user_annotation", False):
                    ops.append((e.id, e.time_range.start, e.time_range.end))
            elif e.name.startswith("gaot."):
                self.spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
            elif e.name.startswith(RUNTIME):
                launch.setdefault(e.id, e.time_range.start)
                if e.name in SYNCS:
                    self.syncs.append(e.time_range.start)
        self.ops = sorted(((launch[i], a, b) for i, a, b in ops if i in launch),
                          key=lambda o: o[0])
        self.starts = [o[0] for o in self.ops]
        for ranges in self.spans.values():
            ranges.sort()

    def occurrences(self, name: str) -> Optional[List[List[Tuple[float, float]]]]:
        """The device intervals (us) launched inside each occurrence of span
        `name`, or None when the session holds no such span."""
        ranges = self.spans.get(name)
        if not ranges:
            return None
        out = []
        for a, b in ranges:
            lo, hi = bisect.bisect_left(self.starts, a), bisect.bisect_right(self.starts, b)
            out.append(sorted((s, e) for _, s, e in self.ops[lo:hi]))
        return out

    def sync_count(self, name: str) -> Optional[int]:
        """Blocking runtime calls that start inside some occurrence of span
        `name`, or None when the session holds no such span."""
        ranges = self.spans.get(name)
        if not ranges:
            return None
        return sum(1 for t in self.syncs if any(a <= t <= b for a, b in ranges))


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of sorted intervals."""
    total, end = 0.0, float("-inf")
    for a, b in intervals:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def stages(record) -> Optional[Stages]:
    """The record's traced session read by stage (once, then kept on the
    trace), or None without a CUDA trace."""
    tr = record.trace
    if tr is None or not tr.cuda or not tr.items:
        return None
    st = getattr(tr, "_stages", None)
    if st is None:
        st = tr._stages = Stages(tr.prof.events())
    return st


def busy_ms(record, name: str) -> Optional[float]:
    """Device busy ms a traced item of the operations span `name` launched."""
    st = stages(record)
    occ = st.occurrences(name) if st is not None else None
    if occ is None:
        return None
    return 1e-3 * sum(union_us(o) for o in occ) / record.trace.items


def idle_pct(record, name: str) -> Optional[float]:
    """Share of span `name`'s extent on the device timeline with none of its
    operations running, over every occurrence that launched any."""
    st = stages(record)
    occ = st.occurrences(name) if st is not None else None
    if occ is None:
        return None
    busy = sum(union_us(o) for o in occ if o)
    extent = sum(max(e for _, e in o) - o[0][0] for o in occ if o)
    if extent <= 0:
        return None
    return 100.0 * (1.0 - busy / extent)


def host_syncs(record, name: str) -> Optional[float]:
    """Blocking runtime calls a traced item inside span `name`."""
    st = stages(record)
    n = st.sync_count(name) if st is not None else None
    if n is None:
        return None
    return n / record.trace.items
