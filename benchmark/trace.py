"""The benchmark's spans (host clock, and CUDA events around the forward)
and its reading of a torch.profiler trace: device busy time, device time by
kernel name, the top device operations and the longest idle gaps with what
the host was doing in each."""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch


class Spans:
    """Host-clock spans by name (seconds), recorded for every item of the
    window, and the same names as torch.profiler ranges."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def mean_ms(self, *names: str) -> Optional[float]:
        """Mean over items of the summed spans `names`, in ms."""
        rows = [self.seconds.get(n, []) for n in names]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            return None
        return 1e3 * sum(sum(r) for r in rows) / len(rows[0])


class DeviceTimer:
    """CUDA events around a region of each item; `mean_ms` once synchronized.
    On the CPU the host clock stands in."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs: list = []

    @contextmanager
    def region(self):
        if self.cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self.pairs.append((a, b))
        else:
            t0 = time.perf_counter()
            yield
            self.pairs.append(1e3 * (time.perf_counter() - t0))

    def mean_ms(self) -> Optional[float]:
        if not self.pairs:
            return None
        ms = [p if isinstance(p, float) else p[0].elapsed_time(p[1]) for p in self.pairs]
        return sum(ms) / len(ms)


WINDOW = "traced_window"


class Trace:
    """One torch.profiler session over a traced segment of items. The
    profiler also lays the host ranges (`record_function`, the spans of
    `spans`) on the device timeline as annotations; those are no device
    operation and are left out."""

    def __init__(self, device, spans: Optional[Spans] = None):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = spans
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = 0.0
        self.items = 0

    @contextmanager
    def segment(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.start()
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield
            if self.cuda:
                torch.cuda.synchronize()
        self.window_s = time.perf_counter() - t0
        self.prof.stop()
        self._read()

    def _read(self) -> None:
        dev = torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        ranges = {WINDOW} | (set(self.spans.seconds) if self.spans is not None else set())
        self.device = sorted(((e.name, e.time_range.start, e.time_range.end) for e in events
                              if e.device_type == dev and e.name not in ranges
                              and not getattr(e, "is_user_annotation", False)),
                             key=lambda r: r[1])
        self.host = [(e.name, e.time_range.start, e.time_range.end) for e in events
                     if e.device_type != dev]
        win = [h for h in self.host if h[0] == WINDOW]
        self.bounds = (win[0][1], win[0][2]) if win else None

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        total, end = 0.0, float("-inf")
        for _, a, b in self.device:
            if b > end:
                total += b - max(a, end)
                end = b
        return total * 1e-6

    def kernel_seconds(self, *keys: str) -> Tuple[float, int]:
        """(seconds, launches) of device operations whose name holds a key."""
        rows = [b - a for n, a, b in self.device if any(k in n for k in keys)]
        return sum(rows) * 1e-6, len(rows)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            by[name] += (b - a) * 1e-6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The `n` longest spans of the traced window with no device
        operation, each named by the innermost host range around its middle."""
        if self.bounds is None:
            return []
        start, stop = self.bounds
        gaps, end = [], start
        for _, a, b in self.device:
            if a > end:
                gaps.append((a - end, end, a))
            end = max(end, b)
        if stop > end:
            gaps.append((stop - end, end, stop))
        out = []
        for length, a, b in sorted(gaps, reverse=True)[:n]:
            mid = 0.5 * (a + b)
            around = [h for h in self.host if h[1] <= mid <= h[2] and h[0] != WINDOW]
            name = min(around, key=lambda h: h[2] - h[1])[0] if around else "host outside any range"
            out.append([name[:120], length * 1e-6])
        return out
