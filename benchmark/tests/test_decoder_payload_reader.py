"""decoder_payload_ms.serve on traces built by hand: K9's device ms a traced
request by kernel name, and None where no K9 ran (a program without it) or
there is no CUDA trace."""
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.trace import WINDOW, Trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
K9 = "void (anonymous namespace)::decoder_payload_kernel<64, 32>(float const*, float const*)"
K5 = "void (anonymous namespace)::encoder_accumulate_kernel<64, 32>(float const*)"


def ev(name, device, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=0, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def traced(device_ops, items=2):
    """A Trace read from a session of `device_ops` [(name, start, end)] (us)
    inside the traced window, with the decode span laid on the device as an
    annotation, as the profiler lays it."""
    events = [ev(WINDOW, CPU, 0, 1000), ev("gaot.decode", CUDA, 0, 900, annotation=True)]
    events += [ev(n, CUDA, a, b) for n, a, b in device_ops]
    tr = Trace.__new__(Trace)
    tr.spans, tr.items, tr.cuda = None, items, True
    tr.prof = SimpleNamespace(events=lambda: events)
    tr._read()
    return SimpleNamespace(trace=tr)


def test_reads_k9_ms_a_request():
    rec = traced([(K5, 0, 300), (K9, 310, 324), ("Memcpy DtoH", 330, 400), (K9, 500, 512.5)])
    assert harness.reader("decoder_payload_ms.serve")(rec) == pytest.approx(1e-3 * 26.5 / 2)
    # K9 is not read as K5, whose name payload_roofline.serve matches
    assert rec.trace.kernel_seconds("encoder_accumulate") == (pytest.approx(300e-6), 1)


@pytest.mark.parametrize("rec", [
    SimpleNamespace(trace=None),
    traced([(K5, 0, 300), ("Memcpy DtoH", 330, 400)]),  # the parent: no K9
    traced([(K9, 310, 324)], items=0),
])
def test_none_without_a_k9_launch(rec):
    assert harness.reader("decoder_payload_ms.serve")(rec) is None
