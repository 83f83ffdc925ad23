"""The port's spans (gaot3d_tpu_torch/tracing.py) on the CPU, at a tiny size:
nothing is recorded outside a profiler session; inside one the train step,
the forward, the served forward with slots built on the device and the
loader open their `gaot.*` ranges, nested as documented; the numbers are the
same bits with and without a session."""
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaot3d_tpu_torch import tracing
from gaot3d_tpu_torch.data.host_graph import build_edge_slots_host, section_slots_by_degree_np
from gaot3d_tpu_torch.data.pipeline import prefetch_to_device
from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig,
                                     TransformerConfig, init_model)
from gaot3d_tpu_torch.ops.grid_graph import LatentGrid, SectionedEdgeSlots
from gaot3d_tpu_torch.serve import (BucketedInference, make_device_edge_model,
                                    make_edge_arg_model)
from gaot3d_tpu_torch.train import OptimizerargsConfig, TrainBatch, make_optimizer, train_step
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

GRID = LatentGrid(dims=(4, 4, 4))
RADIUS = 0.6
N = 320
FORWARD = ["gaot.encode", "gaot.process", "gaot.decode"]


def _model():
    magno = MAGNOConfig(lifting_channels=8, gno_radius=RADIUS, neighbor_strategy="bidirectional",
                        projection_channels=16, in_gno_channel_mlp_hidden_layers=[16, 16],
                        out_gno_channel_mlp_hidden_layers=[16], use_geoembed=[True, False],
                        mlp_type="linear", slot_budget=27, edge_chunk_size=128)
    attn = TransformerConfig(patch_size=2, hidden_size=64, num_layers=2,
                             positional_embedding="rope",
                             attn_config=AttentionConfig(hidden_size=64, num_heads=2,
                                                         num_kv_heads=2, atten_dropout=0.1,
                                                         attention_dtype="float32"),
                             ffn_config=FFNConfig(hidden_size=128))
    return init_model(3, 1, "gaot_3d", magno, attn, latent_tokens=GRID.dims, grid=GRID,
                      generator=torch.Generator().manual_seed(5), device="cpu")


def _cloud(seed=0, n=N):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    return pos, rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 1)).astype(
        np.float32)


@pytest.fixture(scope="module")
def setup():
    """(model, optimizer, a batch over degree-sectioned slots built on the host)."""
    pos, feats, target = _cloud()
    lat, msk = build_edge_slots_host(pos, GRID, RADIUS, strategy="bidirectional", budget=27)
    perm, secs = section_slots_by_degree_np(lat, msk, 64)
    slots = SectionedEdgeSlots.from_numpy([(la[None], ma[None]) for la, ma in secs])
    assert len(slots.sections) > 1
    t = torch.from_numpy
    batch = TrainBatch(t(pos[perm])[None], t(feats[perm])[None], t(target[perm])[None],
                       torch.ones((1, N), dtype=torch.bool), slots, slots)
    model = _model()
    opt = make_optimizer("adamw", model.parameters(), OptimizerargsConfig(), 10)
    return model, opt, batch


def _step(setup, seed=3):
    """A train step on fresh copies of the model and optimizer: (loss, grad
    norm, the model after)."""
    model, opt, batch = setup
    model, opt = copy.deepcopy((model, opt))
    loss, norm = train_step(model, opt, batch, torch.Generator().manual_seed(seed))
    return loss, norm, model


def _ranges(prof):
    """{name: [(start, end), ...]} of the session's gaot.* host ranges."""
    out = {}
    for e in prof.events():
        if e.name.startswith("gaot."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_outside_a_session_nothing_is_recorded(setup, monkeypatch):
    assert tracing.span("gaot.encode") is tracing.span("gaot.decode")
    with tracing.span("gaot.encode") as entered:
        assert entered is None

    def opened(name):
        raise AssertionError(f"{name} opened a profiler range outside a session")

    monkeypatch.setattr(tracing.torch.profiler, "record_function", opened)
    _step(setup)


def test_train_step_spans_nest(setup):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(setup)
    r = _ranges(prof)
    names = ["gaot.train.step", "gaot.train.forward", "gaot.check_edges", *FORWARD,
             "gaot.train.backward", "gaot.train.optimizer"]
    assert sorted(r) == sorted(names)  # no slot build, no all-reduce
    assert all(len(v) == 1 for v in r.values())
    (step,), (fwd,), (bwd,), (opt,) = (r[f"gaot.train.{n}"] for n in
                                       ("step", "forward", "backward", "optimizer"))
    assert all(_inside(s, step) for s in (fwd, bwd, opt))
    assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
    inner = [r[n][0] for n in ("gaot.check_edges", *FORWARD)]
    assert all(_inside(s, fwd) for s in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


def test_the_session_changes_no_bit(setup):
    loss, norm, model = _step(setup)
    with profile(activities=[ProfilerActivity.CPU]):
        loss2, norm2, model2 = _step(setup)
    assert torch.equal(loss, loss2) and torch.equal(norm, norm2)
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), k


def test_served_forwards(setup):
    model, _, batch = setup
    model = copy.deepcopy(model).eval()
    pos, feats, _ = _cloud(seed=1, n=N - 40)
    p, f = torch.from_numpy(pos)[None], torch.from_numpy(feats)[None]
    mask = torch.ones(p.shape[:2], dtype=torch.bool)
    built, edge_arg = make_device_edge_model(model), make_edge_arg_model(model)
    buckets = BucketedInference(built, [N])
    plain = (built(p, f, mask), buckets(p, f, mask),
             edge_arg(batch.pos, batch.feats, batch.node_mask, batch.enc_slots, batch.dec_slots))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = built(p, f, mask)
    r = _ranges(prof)
    assert sorted(r) == sorted(["gaot.serve.forward", "gaot.slot_build", *FORWARD])
    (fwd,) = r["gaot.serve.forward"]
    stages = [r[n][0] for n in ("gaot.slot_build", *FORWARD)]
    assert all(_inside(s, fwd) for s in stages)
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced_bucket = buckets(p, f, mask)
        traced_edges = edge_arg(batch.pos, batch.feats, batch.node_mask, batch.enc_slots,
                                batch.dec_slots)
    r = _ranges(prof)  # the dispatcher and the edge-argument forward add no span
    (fwd,), (check,) = r["gaot.serve.forward"], r["gaot.check_edges"]
    assert sorted(r) == sorted(["gaot.serve.forward", "gaot.check_edges", "gaot.slot_build",
                                *FORWARD])
    assert fwd[1] <= check[0] and all(len(r[n]) == 2 for n in FORWARD)
    assert all(_inside(s, fwd) for s in [r["gaot.slot_build"][0]] + [r[n][0] for n in FORWARD])
    assert all(check[1] <= r[n][1][0] for n in FORWARD)
    for a, b in zip(plain, (traced, traced_bucket, traced_edges)):
        assert torch.equal(a, b)


def test_loader_spans_on_both_threads():
    """The step loop waits in gaot.loader.wait; the prefetch thread's load and
    upload show in a session that records every thread."""
    from torch._C._profiler import _ExperimentalConfig

    stats = {}
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        got = list(prefetch_to_device(iter(range(3)), lambda x: x * 2, stats=stats))
    assert got == [0, 2, 4] and stats["gets"] == 4
    r = _ranges(prof)
    assert len(r["gaot.loader.wait"]) == 4
    assert len(r["gaot.loader.load"]) == 4 and len(r["gaot.loader.put"]) == 3
    assert stats["wait_s"] >= stats["first_wait_s"] >= 0.0
