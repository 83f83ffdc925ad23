"""The reference against gaot3d_tpu_torch at a tiny size on the CPU (the
port's plain versions): the graph, the dropout bits, the eval forward over
slots built on the device and over host sections, and one train step's loss
and gradients."""
import pytest
import torch

from benchmark import correctness, program, traffic
from benchmark.harness import merge, cell_parts, load_benchmark
from benchmark.reference import model as ref
from benchmark.reference import philox
from benchmark.tests.tiny import SEED, TINY

SURFACE = {"bump": 0.3, "frequencies": [3.0, 2.0], "jitter": 0.1}


def tiny(cell, **magno):
    _, cfg, _ = cell_parts(load_benchmark(), cell)
    return merge(cfg, merge(TINY, {"model": {"magno": magno}}))


def test_dropout_bits_match_the_port():
    from gaot3d_tpu_torch.kernels.dropout_bits import dropout_bits_reference, keep_multiplier
    seed = 0x9E3779B97F4A7C15
    bits = dropout_bits_reference(seed, 3, 10, 14, bh_offset=5)
    want = keep_multiplier(bits, 0.1) > 0
    got = philox.keep_rows(seed, 0.1, 3, 0, 10, 14, "cpu", bh0=5)
    assert torch.equal(got, want)
    assert torch.equal(philox.keep_rows(seed, 0.1, 3, 4, 10, 14, "cpu", bh0=5), want[:, 4:])


@pytest.mark.parametrize("budget", [3, 8])
def test_graph_matches_the_device_build(budget):
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid, build_budgeted_slots
    cfg = tiny("drivaerml-serve", slot_budget=budget)
    spec = ref.Spec.from_config(cfg)
    mesh = traffic.make_mesh(4096, SEED, 0, SURFACE, "cpu")
    cells, valid = ref.graph(spec, mesh.pos)
    s = build_budgeted_slots(mesh.pos[None], LatentGrid(tuple(cfg["model"]["latent_tokens"])),
                             spec.radius, 1, "bidirectional", None, budget, 512)
    got = torch.where(s.mask[0], s.lat_idx[0].long(), -1)
    assert torch.equal(got, torch.where(valid, cells, -1))


@pytest.mark.parametrize("cell,kernel", [("drivaerml-serve", "float32"),
                                         ("drivaernet-train", "bfloat16")])
def test_forward_matches_the_port(cell, kernel):
    from gaot3d_tpu_torch.serve import make_device_edge_model
    cfg = tiny(cell, kernel_dtype=kernel)
    model = program.build_model(cfg, SEED, "cpu").eval()
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mesh = traffic.make_mesh(4096, SEED, 1, SURFACE, "cpu")
    got = make_device_edge_model(model)(mesh.pos[None], mesh.feats[None],
                                        torch.ones(1, 4096, dtype=torch.bool))[0]
    spec = ref.Spec.from_config(cfg)
    with torch.no_grad():
        want = ref.forward(w0, spec, mesh.pos, mesh.feats, *ref.graph(spec, mesh.pos))
    # bf16 attention turns f32 reorderings upstream into bf16 rounding flips
    assert correctness.rel_l2(got, want) < 1e-3
    spec.control = "fp8"
    with torch.no_grad():
        low = ref.forward(w0, spec, mesh.pos, mesh.feats, *ref.graph(spec, mesh.pos))
    assert correctness.rel_l2(low, want) > 3 * correctness.rel_l2(got, want)


def test_train_step_matches_the_port():
    from gaot3d_tpu_torch.train import (OptimizerargsConfig, TrainBatch, make_optimizer,
                                        train_step)
    cfg = tiny("drivaernet-train")
    model = program.build_model(cfg, SEED, "cpu")
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mesh = traffic.make_mesh(4096, SEED, 2, SURFACE, "cpu")
    spec = ref.Spec.from_config(cfg)
    cells, valid = ref.graph(spec, mesh.pos)
    from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots
    slots = EdgeSlots(torch.where(valid, cells, 0).int()[None], valid[None])
    opt = make_optimizer("adamw", model.parameters(),
                         OptimizerargsConfig(**cfg["optimizer"]["args"]), 10)
    batch = TrainBatch(mesh.pos[None], mesh.feats[None], mesh.target[None],
                       torch.ones(1, 4096, dtype=torch.bool), slots, slots)
    loss, _ = train_step(model, opt, batch, torch.Generator().manual_seed(7))
    grads = {n: (opt.optimizer.state[p]["exp_avg"] / 0.1) for n, p in model.named_parameters()}
    from benchmark.reference import optim as ref_optim
    seeds = [ref.layer_seeds(torch.Generator().manual_seed(7), spec.layers)]
    losses, ref_grad, _ = ref_optim.train_steps(
        w0, spec, [(mesh.pos, mesh.feats, mesh.target, cells, valid)], seeds,
        cfg["optimizer"]["args"], 10)
    assert abs(float(loss) - losses[0]) <= 1e-5 * losses[0]
    assert correctness.leaf_norm_gap(grads, ref_grad, list(ref_grad)) < 1e-2
    worst = max(correctness.rel_l2(grads[k], g) for k, g in ref_grad.items()
                if float(g.norm()) > 0)
    assert worst < 5e-2
