"""The node-sharded training cell drivaerml-train-4chip: its configuration,
traffic, driver and limits found by their names; its controls and its fault
(a rank that keeps its own encoder accumulator) judged not correct at a
tiny size on the CPU, four gloo ranks; its per-layer readers on a traced
step built by hand, and None where a program lacks what they read. The
`cuda` test runs the fault at the cell's own size on four cards and prints
its numbers, the readings of benchmark/limits/drivaerml-train-4chip.json:

    python -m pytest benchmark/tests/test_sharded_cell.py -m cuda -s
"""
import json
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.control import judged_correct
from benchmark.control_sharded import control_checks
from benchmark.correctness import load_limits
from benchmark.tests.tiny import SEED, TINY
from benchmark.trace import WINDOW, Trace

CELL = "drivaerml-train-4chip"
TRAFFIC = {"meshes": 3}
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _metrics():
    return [m for m in harness.load_benchmark()["per_layer"] if CELL in m.get("workloads", [])]


def test_the_cell_is_found_by_its_names():
    bench = harness.load_benchmark()
    work, cfg, tr = harness.cell_parts(bench, CELL)
    assert work["chips"] == 4 and tr["driver"] == "train_sharded"
    assert os.path.exists(os.path.join(harness.HERE, "drivers", "train_sharded.py"))
    _, base, _ = harness.cell_parts(bench, "drivaerml-serve")
    for key in ("model", "optimizer", "dataset", "setup", "nodes", "input_channels",
                "output_channels"):
        assert cfg[key] == base[key], key  # the published recipe, as drivaerml-serve runs it
    assert cfg["setup"]["node_shards"] == 8 and cfg["node_shards_held"] == 4
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    assert entry["reduced"] == cfg["reduced"] == ["node_shards_held", "attention_dtype"]
    assert set(load_limits(CELL)) == {"loss_gap", "grad_gap", "change_gap", "gno_gap",
                                      "enc_gap", "dec_gap", "over_budget", "launches_off",
                                      "ranks_apart"}
    e2e = {m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert e2e == {"setup_s", "train_step_ms"}
    for m in _metrics():
        assert os.path.exists(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
        assert m["moves"] == "train_step_ms"


def _run(**config):
    torch.set_num_threads(2)
    return harness.run_cell(CELL, SEED, 0.5, False, "cpu", config_over={**TINY, **config},
                            traffic_over=TRAFFIC)


@pytest.fixture
def one_rank_keeps_its_own_accumulator(monkeypatch):
    """In this process, rank 0: parallel/sharding.py's all_reduce_sum, as
    the encoder calls it on its accumulator, still runs its all-reduce, so
    the other ranks do not wait, but rank 0 goes on with its own sums."""
    from gaot3d_tpu_torch.models import fused_encoder
    from gaot3d_tpu_torch.parallel import sharding

    def keep_own(x, group):
        return sharding.all_reduce_sum(x, group) * 0.0 + x
    monkeypatch.setattr(fused_encoder, "all_reduce_sum", keep_own)


@pytest.mark.usefixtures("one_rank_keeps_its_own_accumulator")
def test_a_rank_that_keeps_its_own_accumulator(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    r = _run()
    assert r["correct"] is False
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.usefixtures("one_rank_keeps_its_own_accumulator")
def test_a_rank_that_keeps_its_own_accumulator_at_the_cells_size():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = harness.run_cell(CELL, 2 ** 31 + 4242, 2.0, False, "cuda")
    print(json.dumps({"reading": "fault one rank keeps its own accumulator",
                      "checks": {k: c["value"] for k, c in r["checks"].items()},
                      "correct": r["correct"]}), flush=True)
    assert r["correct"] is False


@pytest.mark.parametrize("kind", ["tf32", "fp8"])
def test_the_control_fails(kind):
    """At this size the control reads at least three times what the program
    reads in one number, and the cell's limits judge it not correct."""
    torch.set_num_threads(2)
    checks = control_checks(CELL, SEED, kind, "cpu", TINY, TRAFFIC)
    program = _run()["checks"]
    assert any(v > 3 * (program[k]["value"] or 0.0) for k, v in checks.items()), checks
    assert not judged_correct(CELL, checks), checks


# --- the readers on a traced step built by hand --------------------------------

NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
K5B = "void (anonymous namespace)::encoder_backward_kernel<64, 32, 2>(float const*)"


def ev(name, device, start, end, id=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def step_events(spans=True):
    """Two steps (us) from 0 and 1000. In each: the forward's node all-reduce
    span [10, 20] launches an NCCL kernel that runs [30, 42]; the backward
    [100, 400] launches K5b [150, 350] and the cotangent's NCCL kernel
    [360, 366]; the gradients' all-reduce span [500, 510] launches one that
    runs [520, 600]."""
    events = [ev(WINDOW, CPU, -5, 2000)]
    k = 0
    for off in (0, 1000):
        host = [("gaot.train.step", 0, 700), ("gaot.train.forward", 0, 90),
                ("gaot.train.backward", 100, 400), ("gaot.train.allreduce", 500, 510)]
        if spans:
            host.append(("gaot.node_allreduce", 10, 20))
        events += [ev(n, CPU, off + a, off + b) for n, a, b in host]
        for at, name, a, b in ((12, NCCL, 30, 42), (120, K5B, 150, 350), (355, NCCL, 360, 366),
                               (505, NCCL, 520, 600)):
            k += 1
            events += [ev("cuLaunchKernelEx", CPU, off + at, off + at + 1, id=k),
                       ev(name, CUDA, off + a, off + b, id=k)]
    return events


def record(events, counts, items=2):
    tr = Trace.__new__(Trace)
    tr.spans, tr.items, tr.cuda = None, items, True
    tr.prof = SimpleNamespace(events=lambda: events)
    tr._read()
    return SimpleNamespace(trace=tr, counts=counts, items=10, window_s=2.5)


COUNTS = {"exchanged_bytes": 2.7e6, "chips": 4, "step_flops": 2.0e12,
          "payload_backward": [(1.0e9, 1.0e7, 495e12), (1.0e9, 1.0e7, 495e12)]}


def test_the_readers_on_a_traced_step():
    rec = record(step_events(), COUNTS)
    read = {m["name"]: harness.reader(m["name"])(rec) for m in _metrics()}
    assert read["exchange_ms.train4"] == pytest.approx(1e-3 * (12 + 6 + 80))
    # 2.7 MB x 2 (4 - 1) / 4 in 98 us, against 450 GB/s
    assert read["exchange_busbw.train4"] == pytest.approx(
        100 * 2.7e6 * 1.5 / 98e-6 / 450e9)
    assert read["node_allreduce_busy_ms.train4"] == pytest.approx(0.012)
    assert read["allreduce_busy_ms.train4"] == pytest.approx(0.080)
    assert read["backward_busy_ms.train4"] == pytest.approx(0.206)
    least = 2 * max(1.0e9 / 495e12, 1.0e7 / 3.35e12)
    assert read["k5b_roofline.train4"] == pytest.approx(100 * least / 400e-6)
    assert read["mfu.train4"] == pytest.approx(100 * 2.0e12 / 0.25 / (4 * 989e12))
    assert read["forward_busy_ms.train4"] == pytest.approx(0.012)
    for name in ("slot_build_busy_ms.train4", "encode_busy_ms.train4",
                 "decode_busy_ms.train4"):
        assert read[name] is None, name  # no such span in this session


def test_none_where_the_program_lacks_the_span_or_the_counter():
    """The parent of the change that added them: no gaot.node_allreduce, no
    byte counter."""
    parent = record(step_events(spans=False), {k: v for k, v in COUNTS.items()
                                                if k != "exchanged_bytes"})
    assert harness.reader("node_allreduce_busy_ms.train4")(parent) is None
    assert harness.reader("exchange_busbw.train4")(parent) is None
    assert harness.reader("exchange_ms.train4")(parent) == pytest.approx(0.098)
    for m in _metrics():
        assert harness.reader(m["name"])(SimpleNamespace(trace=None, counts={}, items=0,
                                                         window_s=0.0)) is None
