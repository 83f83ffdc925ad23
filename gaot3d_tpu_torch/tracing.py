"""The port's spans, on the clock of a torch.profiler session.

A span names a stage of the train step, the forward or the loader. Inside a
profiler session it is a `torch.profiler.record_function` range: the
profiler holds it in memory, nests it by time on its thread and lays it on
the same clock as the device operations and the runtime calls, so each
operation, and each call that blocks the host on the device, can be put down
to the stage that made it, and each idle gap of the card to the stage the
host was in. Outside a session `span` hands back one shared null context
after a flag check (a fraction of a microsecond) and records nothing.

Two sessions read them: the benchmark's `--trace 1` segment and the
trainer's `setup.profile_dir` Chrome trace. Nothing here starts one.

Span names (a child lies inside its parent):
  gaot.train.step       train/step.py train_step
    gaot.train.forward    forward and masked MSE (the neural-field draw too)
    gaot.train.backward   .backward()
    gaot.train.allreduce  the gradients' all-reduce of a sharded step
    gaot.train.optimizer  the gradient norm and optimizer.step()
  gaot.serve.forward    one served forward with slots built on the device
                        (serve.py make_device_edge_model)
  gaot.check_edges      validation of call-time edges (models/gaot3d.py)
  gaot.slot_build       the slots a forward builds, both sides
  gaot.encode, gaot.process, gaot.decode   the forward's three stages
  gaot.loader.load, gaot.loader.put   the prefetch thread's load and upload
  gaot.loader.wait      the step loop's wait on the prefetch queue
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.autograd import _profiler_enabled
from torch.autograd import profiler as _autograd_profiler

_NULL = nullcontext()


def span(name: str):
    """A context manager: the profiler range `name` inside a session, else
    the shared null context. A session runs where this thread's profiler
    state says so, or where torch.profiler's process-wide flag does (a
    thread the session did not start, such as the loader's, has no state of
    its own)."""
    if _autograd_profiler._is_profiler_enabled or _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
