"""Closed loop of the port's training step: `train.step.train_step` on one
mesh a step (batch 1), AdamW with the configuration's schedule, over a ring
of seeded meshes whose degree-sectioned slots the host builds at set-up and
which stay on the card, as the trainer's device cache keeps them. Each step
ends in a synchronize.

Set-up builds the model and its optimizer once and drives them through the
first `checked_steps` steps (meshes 0, 1, 2), then once over the rest of the
ring; the same objects then run the window. After the window the reference
follows the checked steps from the same initial weights, meshes and dropout
generator: each step's loss, the first gradient as the optimizer holds it
(its first moment over 1 - beta1) and each leaf's change over the checked
steps are compared leaf by leaf (correctness.train_gaps); the first step's
encoder output and decoder, which hooks on the model hold by reference, are
compared as a served forward's are (correctness.stage_gaps). The window's
own steps are checked only for a finite loss.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import correctness, counting, program, traffic
from benchmark.harness import Outcome, RunRecord, log
from benchmark.reference import model as ref
from benchmark.reference import optim as ref_optim
from benchmark.trace import Trace


def sectioned_batch(cfg: dict, mesh: traffic.Mesh, device):
    """The mesh as the trainer feeds it: host-built slots, degree-sectioned,
    the node arrays in the sections' order. -> (TrainBatch, sections)."""
    from gaot3d_tpu_torch.data.host_graph import (build_edge_slots_host,
                                                  section_slots_by_degree_np)
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid, SectionedEdgeSlots
    from gaot3d_tpu_torch.train import TrainBatch

    magno = cfg["model"]["magno"]
    grid = LatentGrid(dims=tuple(cfg["model"]["latent_tokens"]))
    lat, msk = build_edge_slots_host(mesh.pos.cpu().numpy(), grid, float(magno["gno_radius"]),
                                     strategy=magno["neighbor_strategy"],
                                     budget=int(magno["slot_budget"]))
    perm, secs = section_slots_by_degree_np(lat, msk, int(cfg["section_chunk"]))
    if not np.array_equal(np.sort(perm), np.arange(len(perm))):
        raise RuntimeError("the sections' node order is not a permutation")
    p = torch.from_numpy(perm).to(device)
    slots = SectionedEdgeSlots.from_numpy([(la[None], ma[None]) for la, ma in secs],
                                          device=device)
    mask = torch.ones((1, len(perm)), dtype=torch.bool, device=device)
    batch = TrainBatch(mesh.pos[p][None], mesh.feats[p][None], mesh.target[p][None], mask,
                       slots, slots)
    return batch, len(secs), p


def expected_launches(cfg: dict, sections: int, cuda: bool) -> dict:
    """A training step's launches: K1 and K2 once a processor block, K5 and
    K5b once a section (their bf16 bodies under kernel_dtype bfloat16)."""
    if not cuda:  # the plain versions run on the CPU and launch nothing
        return dict.fromkeys(program.launches(), 0)
    layers = int(cfg["model"]["transformer"]["num_layers"])
    bf16 = cfg["model"]["magno"].get("kernel_dtype", "float32") == "bfloat16"
    return {"k1": layers, "k2": layers, "k3": 0, "k5": sections,
            "k5_bf16": sections if bf16 else 0, "k5b": sections,
            "k5b_bf16": sections if bf16 else 0}


def run(ctx) -> Outcome:
    from gaot3d_tpu_torch.train import OptimizerargsConfig, make_optimizer, train_step

    cfg, tr, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    record = RunRecord(ctx.cell, cfg, ctx.device)
    ring = int(tr["meshes"])
    checked = int(tr["checked_steps"])

    log("program imported")
    model = program.build_model(cfg, ctx.seed, dev)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    log("model made")
    opt_cfg = cfg["optimizer"]
    steps_per_epoch = int(cfg["dataset"]["train_size"]) // int(cfg["dataset"]["batch_size"])
    optimizer = make_optimizer(opt_cfg["name"], model.parameters(),
                               OptimizerargsConfig(**opt_cfg["args"]), steps_per_epoch)
    log("optimizer made")
    meshes = [traffic.make_mesh(int(cfg["nodes"]), ctx.seed, i, tr["surface"], dev)
              for i in range(ring)]
    log("model, optimizer and meshes made")
    fed = [sectioned_batch(cfg, m, dev) for m in meshes]
    log(f"{ring} meshes made and sectioned: {[nsec for _, nsec, _ in fed]} sections")
    dropout = torch.Generator().manual_seed(traffic.stream_seed(ctx.seed, 3))
    losses, want = [], dict.fromkeys(program.launches(), 0)
    start = program.launches()

    def step(i):
        batch, nsec, _ = fed[i % ring]
        with record.spans.span("train_step"):
            loss, _ = train_step(model, optimizer, batch, dropout)
            if cuda:
                torch.cuda.synchronize()
        for k, v in expected_launches(cfg, nsec, cuda).items():
            want[k] += v
        losses.append(loss.detach())

    capture = program.Capture(model)
    step(0)
    first_stages = capture.take()
    capture.remove()
    perm0 = fed[0][2]
    state = optimizer.optimizer.state
    beta1 = optimizer.optimizer.param_groups[0]["betas"][0]
    first_grad = {n: (state[p]["exp_avg"] / (1 - beta1)).detach().clone() if p in state
                  else torch.zeros_like(p) for n, p in model.named_parameters()}
    for i in range(1, checked):
        step(i)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(checked, ring):
        step(i)

    ctx.setup_done()
    t0, n = time.perf_counter(), 0
    while True:
        step(ring + n)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    record.window_s = time.perf_counter() - t0
    record.items = n
    log(f"window: {n} steps in {record.window_s:.2f} s")
    window_losses = torch.stack(losses[ring:]).float()
    failed = int((~torch.isfinite(window_losses)).sum())

    if ctx.trace:
        record.trace = Trace(dev, record.spans)
        with record.trace.segment():
            for i in range(int(tr["trace_items"])):
                step(i)
        record.trace.items = int(tr["trace_items"])
    launched = program.launches_since(start)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    program_losses = [float(v) for v in losses[:checked]]
    del model, optimizer, fed, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    log("program freed; the reference follows the checked steps")
    spec = ref.Spec.from_config(cfg)
    graphs = [ref.graph(spec, m.pos) for m in meshes[:checked]]
    if ctx.trace:
        nodes = int(cfg["nodes"])
        flops = [counting.train_step_flops(cfg, nodes, ref.valid_edges(ref.graph(spec, m.pos)[1]))
                 for m in meshes]
        record.counts = {"step_flops": sum(flops) / len(flops),
                         "attention": counting.attention_train(cfg)}
    gen = torch.Generator().manual_seed(traffic.stream_seed(ctx.seed, 3))
    seeds = [ref.layer_seeds(gen, spec.layers) for _ in range(checked)]
    fed_ref = [(m.pos, m.feats, m.target, *g) for m, g in zip(meshes, graphs[:checked])]
    ref_losses, ref_grad, ref_after = ref_optim.train_steps(
        w0, spec, fed_ref, seeds, opt_cfg["args"], steps_per_epoch)
    log(f"reference done: losses {ref_losses} (program {program_losses})")
    checks = {
        **correctness.train_gaps(program_losses, ref_losses, first_grad, ref_grad, after,
                                 ref_after, w0),
        **correctness.stage_gaps(w0, spec, meshes[0].pos[perm0], meshes[0].feats[perm0],
                                 first_stages, end_to_end=False),
        "over_budget": correctness.over_budget(spec, (m.pos for m in meshes)),
        "launches_off": float(correctness.launch_mismatches(launched, want)),
    }
    e2e = {"train_step_ms": 1e3 * record.window_s / n}
    return Outcome(e2e, n, failed, checks, record, int(memory_peak))
