"""The control and the faults a cell can have come out as not correct, at a
tiny size on the CPU: the reference at a precision below the configuration's
in the program's place, and a run with its timed path broken underneath (a
step that leaves the state unchanged; half of the batch left out of the loss,
the mean taken over the rest; an answer altered where it is produced). The
cells run on one chip, so no exchange between chips can be left out.
The same control runs on the card at the cells' own sizes through
`python3 benchmark/control.py`."""
import pytest
import torch

from benchmark import harness
from benchmark.control import control_checks, judged_correct
from benchmark.tests.tiny import SEED, TINY, TRAFFIC

CONTROLS = [(w["name"], kind) for w in harness.load_benchmark()["workloads"]
            for kind in ("tf32", "fp8")] + [("drivaerml-serve", "bf16_kernel")]


@pytest.mark.parametrize("cell,kind", CONTROLS)
def test_the_control_fails(cell, kind):
    """At this size the control reads at least three times what the program
    reads (the separation the limits are set in), and the card's limits
    judge it not correct. fp8 lowers only attention in drivaerml-serve,
    whose f32 stages do not see it; there fp8 attention alone reads 1.3e-3
    to 4e-3 at this size, under the card's pred_gap limit, and the TF32 and
    bf16 controls are the configuration's."""
    torch.set_num_threads(4)
    checks = control_checks(cell, SEED, kind, "cpu", TINY, TRAFFIC[cell])
    program = _run(cell)["checks"]
    assert any(v > 3 * (program[k]["value"] or 0.0) for k, v in checks.items()
               if k in program), (checks, program)
    if (cell, kind) != ("drivaerml-serve", "fp8"):
        assert not judged_correct(cell, checks), checks


def _run(cell, **config):
    torch.set_num_threads(4)
    return harness.run_cell(cell, SEED, 0.5, False, "cpu", config_over={**TINY, **config},
                            traffic_over=TRAFFIC[cell])


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from gaot3d_tpu_torch.train import schedule

    def no_update(self):
        self.count += 1
    monkeypatch.setattr(schedule.ScheduledOptimizer, "step", no_update)
    assert _run("drivaernet-train")["correct"] is False


def test_half_the_batch_left_out(monkeypatch):
    from gaot3d_tpu_torch.train import step
    full = step.masked_mse

    def half(pred, target, mask):
        keep = mask.clone()
        keep[:, keep.shape[1] // 2:] = False
        return full(pred, target, keep)
    monkeypatch.setattr(step, "masked_mse", half)
    r = _run("drivaernet-train")
    assert r["correct"] is False and r["checks"]["loss_gap"]["value"] > \
        r["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("edges", ["device", "host_sections"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, edges):
    """On both of the serve driver's paths: slots built on the card, and
    slots built and sectioned on the host, the prediction put back into the
    client's order."""
    from gaot3d_tpu_torch import serve

    def altered(make):
        def wrap(model):
            infer = make(model)

            def call(*args):
                out = infer(*args).clone()
                out[0, 7] += 1.0
                return out
            return call
        return wrap
    monkeypatch.setattr(serve, "make_edge_arg_model", altered(serve.make_edge_arg_model))
    monkeypatch.setattr(serve, "make_device_edge_model", altered(serve.make_device_edge_model))
    assert _run("drivaerml-serve", edges=edges)["correct"] is False
