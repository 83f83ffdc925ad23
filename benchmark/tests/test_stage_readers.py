"""The per-stage readers (stages.py and the metrics that use it) on records
built by hand: device operations, the runtime calls that launched them, the
device-side ranges the profiler lays for host ranges, and the host ranges of
the program's spans, and blocking runtime calls inside and outside them,
over two traced items. And None where there is nothing to read."""
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, stages
from benchmark.trace import WINDOW

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, device, start, end, id=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def launched(k, at, start, end, name="kernel", api="cudaLaunchKernel"):
    """A device operation and the runtime call that launched it at `at`."""
    return [ev(api, CPU, at, at + 2, id=k), ev(name, CUDA, start, end, id=k)]


def train_events():
    """Two steps (us). Step 1: forward [0, 40] launches two operations that
    abut (busy 40), backward [40, 70] one, launched from another thread while
    the step waits (30), the optimizer [70, 100] two with a gap (busy 3 of an
    extent 6). Step 2 from 200: forward's two overlap (union 20), backward's
    one (10), the optimizer's one (busy 4, extent 4). A copy launched after
    each step belongs to no stage. Step 1 syncs twice (one stream synchronize
in the forward, one in the optimizer), step 2 once, in the forward; the
synchronize after each step and the event record inside it block nothing
the step waits on."""
    host = [ev(WINDOW, CPU, -5, 400)]
    for off in (0, 200):
        host += [ev("gaot.train.step", CPU, off, off + 100),
                 ev("gaot.train.forward", CPU, off, off + 40),
                 ev("gaot.encode", CPU, off + 2, off + 30),
                 ev("gaot.train.backward", CPU, off + 40, off + 70),
                 ev("gaot.train.optimizer", CPU, off + 70, off + 100)]
    ops = (launched(1, 5, 20, 50) + launched(2, 10, 50, 60) + launched(3, 45, 60, 90)
           + launched(4, 75, 95, 97) + launched(5, 80, 100, 101)
           + launched(6, 105, 110, 120, "Memcpy HtoD", "cudaMemcpyAsync")
           + launched(7, 205, 220, 230) + launched(8, 210, 225, 240, api="cuLaunchKernel")
           + launched(9, 250, 250, 260) + launched(10, 280, 300, 304)
           + launched(11, 305, 310, 320, "Memcpy DtoH", "cudaMemcpyAsync"))
    # what the profiler adds: device-side ranges of host ranges, flagged as
    # annotations, and a host operation whose id equals a kernel's correlation id
    extra = [ev("gaot.train.forward", CUDA, 20, 60, annotation=True),
             ev("gaot.train.optimizer", CUDA, 95, 101, annotation=True),
             ev(WINDOW, CUDA, 20, 320, annotation=True),
             ev("aten::mm", CPU, 150, 190, id=3)]
    syncs = [ev("cudaStreamSynchronize", CPU, 35, 39, id=20),
             ev("cudaStreamSynchronize", CPU, 90, 95, id=21),
             ev("cudaEventRecordWithFlags", CPU, 92, 93, id=22),
             ev("cudaDeviceSynchronize", CPU, 130, 140, id=23),
             ev("cudaStreamSynchronize", CPU, 231, 236, id=24),
             ev("cudaDeviceSynchronize", CPU, 330, 340, id=25)]
    return host + ops + extra + syncs


def record(events, items=2, cuda=True):
    prof = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(trace=SimpleNamespace(cuda=cuda, items=items, prof=prof))


def test_busy_ms_and_idle_pct_by_hand():
    rec = record(train_events())
    assert stages.busy_ms(rec, "gaot.train.forward") == pytest.approx(1e-3 * (40 + 20) / 2)
    assert stages.busy_ms(rec, "gaot.train.backward") == pytest.approx(1e-3 * (30 + 10) / 2)
    assert stages.busy_ms(rec, "gaot.train.optimizer") == pytest.approx(1e-3 * (3 + 4) / 2)
    assert stages.busy_ms(rec, "gaot.train.step") == pytest.approx(1e-3 * (73 + 34) / 2)
    assert stages.busy_ms(rec, "gaot.encode") == pytest.approx(1e-3 * (40 + 20) / 2)
    assert stages.idle_pct(rec, "gaot.train.optimizer") == pytest.approx(100 * (1 - 7 / 10))
    assert stages.idle_pct(rec, "gaot.train.backward") == pytest.approx(0.0)


def test_the_metric_files_read_the_stages():
    rec = record(train_events())
    want = {"forward_busy_ms.train": 0.03, "backward_busy_ms.train": 0.02,
            "optimizer_busy_ms.train": 0.0035, "host_syncs.train": 1.5}
    for name, value in want.items():
        assert harness.reader(name)(rec) == pytest.approx(value), name
    assert harness.reader("encode_busy_ms.serve")(rec) == pytest.approx(0.03)
    for name in ("slot_build_busy_ms.serve", "slot_build_idle_pct.serve",
                 "process_busy_ms.serve", "decode_busy_ms.serve"):
        assert harness.reader(name)(rec) is None, name  # no such span in the session


def test_none_without_a_cuda_trace_or_the_span():
    assert stages.busy_ms(SimpleNamespace(trace=None), "gaot.train.forward") is None
    cpu = record(train_events(), cuda=False)
    assert stages.busy_ms(cpu, "gaot.train.forward") is None
    assert stages.idle_pct(cpu, "gaot.train.optimizer") is None
    assert harness.reader("host_syncs.train")(cpu) is None
    no_spans = record([e for e in train_events() if not e.name.startswith("gaot.")])
    assert stages.busy_ms(no_spans, "gaot.train.forward") is None
    assert stages.idle_pct(no_spans, "gaot.slot_build") is None
    # a span whose operations all ran nowhere: busy 0, no extent to be idle in
    empty = record([ev("gaot.slot_build", CPU, 0, 10)])
    assert stages.busy_ms(empty, "gaot.slot_build") == 0.0
    assert stages.idle_pct(empty, "gaot.slot_build") is None


def test_host_syncs_and_the_session_read_once():
    """Syncs count by span from the trace; the session is read once a record,
    however many readers ask."""
    calls = []
    events = train_events()

    def read():
        calls.append(1)
        return events

    rec = SimpleNamespace(trace=SimpleNamespace(cuda=True, items=2,
                                                prof=SimpleNamespace(events=read)))
    assert stages.host_syncs(rec, "gaot.train.step") == pytest.approx(1.5)
    assert stages.host_syncs(rec, "gaot.train.forward") == pytest.approx(1.0)
    assert stages.host_syncs(rec, "gaot.train.optimizer") == pytest.approx(0.5)
    assert stages.host_syncs(rec, "gaot.train.backward") == 0.0
    assert stages.host_syncs(rec, "gaot.slot_build") is None
    assert harness.reader("forward_busy_ms.train")(rec) == pytest.approx(0.03)
    assert len(calls) == 1
