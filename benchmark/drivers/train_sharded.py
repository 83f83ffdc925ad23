"""Closed loop of the port's node-sharded training step, one process a node
rank, each rank on its own card, as the trainer runs it under torchrun.

The configuration's `setup.node_shards` splits every mesh's rows into equal
shards, one a chip; this host holds `node_shards_held` of them, node ranks
0 .. held - 1, one process a rank: rank 0 is the benchmark's own process,
which builds the kernels and then starts the others (this file run as a
script, `python benchmark/drivers/train_sharded.py SPEC RANK`). Each rank:
  - joins the group through `parallel.mesh.initialize_distributed` (NCCL on
    cards, gloo on the CPU; the world size, rank and coordinator address of
    its setup) and lays out a (1, held) mesh with `make_mesh`;
  - builds the model from the seed on its device, and its optimizer;
  - makes each mesh of the ring on its device, takes the held shards' rows
    as the global batch, cuts its own with `shard_point_batch(...,
    shard_nodes=True)` and keeps only those, as the trainer's device cache
    keeps a rank's rows;
  - runs `make_sharded_train_step` around `train.step.train_step`, as the
    trainer does; the model builds the rank's slots from its rows in every
    forward. Each step ends in a synchronize.
Each rank runs on its own equal share of the host's cores (`own_cores`).
Before each step rank 0 tells the others, over a gloo group of the
driver's own, whether to take it: it times the window and, with `--trace
1`, traces `trace_items` steps after it with the profiler (the others run
them untraced). Set-up drives the first `checked_steps` steps (meshes 0, 1,
2) and then the rest of the ring.

After the last step each rank reports its kernel launches, its peak memory
and its parameters after the checked steps; the others leave, and rank 0
runs the reference (reference/blocked.py) over the union of the held shards
from the same initial weights, meshes and dropout seeds: each checked
step's loss, the first gradient as rank 0's optimizer holds it (its first
moment over 1 - beta1, after the all-reduce) and each leaf's change over
the checked steps (correctness.train_gaps); the first step's GNO mean and
encoder output over every cell, and its prediction over rank 0's rows from
the decoder's input (`stage_gaps`). `ranks_apart` is the largest difference
between any rank's parameters and rank 0's after the checked steps: the
ranks apply the same reduced gradients, so it reads 0. The shards that
would lie on further chips add nothing to the encoder's sums or to the loss,
in the program and in the reference alike.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from benchmark import correctness, counting, counting_backward, program, traffic
from benchmark.harness import ROOT, Outcome, RunRecord, log
from benchmark.reference import blocked as ref_blocked
from benchmark.reference import model as ref
from benchmark.trace import Spans, Trace

TIMEOUT_S = 300  # a collective that waits longer than this ends the run


def sizes(cfg: dict):
    """(points of a mesh, points of a shard, shards held here)."""
    nodes, shards = int(cfg["nodes"]), int(cfg["setup"]["node_shards"])
    if nodes % shards:
        raise ValueError(f"{nodes} points do not split into {shards} shards")
    return nodes, nodes // shards, int(cfg["node_shards_held"])


def held_rows(cfg: dict, seed: int, index: int, surface: dict, device) -> traffic.Mesh:
    """Mesh `index` of the ring, cut to the held shards' rows (the global batch)."""
    nodes, shard, held = sizes(cfg)
    m = traffic.make_mesh(nodes, seed, index, surface, device)
    return traffic.Mesh(*(t[:shard * held].clone() for t in m))


def launches() -> dict:
    """program.launches() and K9's."""
    from gaot3d_tpu_torch.kernels.decoder_payload import decoder_payload
    return {**program.launches(), "k9": decoder_payload.launches}


def launches_since(before: dict) -> dict:
    now = launches()
    return {k: now[k] - before[k] for k in now}


def expected_launches(cfg: dict, cuda: bool) -> dict:
    """A rank's launches a step: K1 and K2 once a processor block, K5 and K5b
    once (the rank's slots built in the forward, one structure), their bf16
    bodies under kernel_dtype bfloat16, no K9 (a forward with a gradient)."""
    if not cuda:  # the plain versions run on the CPU and launch nothing
        return dict.fromkeys(launches(), 0)
    layers = int(cfg["model"]["transformer"]["num_layers"])
    bf16 = int(cfg["model"]["magno"].get("kernel_dtype", "float32") == "bfloat16")
    return {"k1": layers, "k2": layers, "k3": 0, "k5": 1, "k5_bf16": bf16, "k5b": 1,
            "k5b_bf16": bf16, "k9": 0}


def exchanged_bytes():
    """The bytes this process has all-reduced (parallel/sharding.py), or None
    for a program that does not count them."""
    from gaot3d_tpu_torch.parallel import sharding
    return getattr(getattr(sharding, "all_reduce_", None), "bytes", None)


@torch.no_grad()
def stage_gaps(w0, spec: ref.Spec, pos, feats, cells, valid, got, rows: int) -> dict:
    """gno_gap and enc_gap over the cells of the held shards' graph, dec_gap
    over rank 0's rows [0, rows), as correctness.stage_gaps reads them."""
    nodes_ok, cells_ok = ref.compared(spec, pos, cells, valid)
    want_gno, want_geo = ref.encode_parts(w0, spec, pos, feats, cells, valid)
    want_enc = ref.recover(w0, spec, want_gno, want_geo)
    ok = nodes_ok[:rows]
    want = ref.decode(w0, spec, got["dec_in"], pos[:rows], cells[:rows], valid[:rows])
    return {"gno_gap": correctness.rel_l2(got["gno"][cells_ok], want_gno[cells_ok]),
            "enc_gap": correctness.rel_l2(got["enc"][cells_ok], want_enc[cells_ok]),
            "dec_gap": correctness.rel_l2(got["pred"].to(pos.device)[ok], want[ok])}


def build_kernels(cfg: dict) -> None:
    """Build (or load) the libraries a step can reach, before any other rank
    starts: the ranks then load them and never compile one at once."""
    from gaot3d_tpu_torch.kernels import (build, decoder_payload, dropout_bits,
                                          encoder_payload, flash_attention, prefix_sum,
                                          segment_sum_sorted, tile_segment_sum)
    dtype = cfg["model"]["magno"].get("kernel_dtype", "float32")
    build.build_together([dropout_bits._library, flash_attention._library,
                          flash_attention._backward_library,
                          functools.partial(encoder_payload._library, dtype),
                          functools.partial(encoder_payload._backward_library, dtype),
                          decoder_payload._library, prefix_sum._library,
                          segment_sum_sorted._library, tile_segment_sum._library])


@contextlib.contextmanager
def own_cores(rank: int, held: int):
    """Run the body on this rank's own equal share of the process's cores,
    with torch's threads at most as many, as a launcher binds one process a
    card: the ranks' threads then never compete for a core or move between
    them."""
    cores, threads = sorted(os.sched_getaffinity(0)), torch.get_num_threads()
    share = len(cores) // held
    if share:
        os.sched_setaffinity(0, cores[rank * share:(rank + 1) * share])
        torch.set_num_threads(min(share, threads))
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(threads)


def train(spec: dict, rank: int, ctx=None):
    """One rank's part of the run. Rank 0 (given the harness's `ctx`) returns
    what the comparison and the result need; the others return None."""
    from gaot3d_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                           make_sharded_train_step, shard_point_batch)
    from gaot3d_tpu_torch.train import (OptimizerargsConfig, TrainBatch, make_optimizer,
                                        train_step)

    cfg, tr, seed = spec["config"], spec["traffic"], int(spec["seed"])
    _, shard, held = sizes(cfg)
    ring, checked = int(tr["meshes"]), int(tr["checked_steps"])
    cuda = spec["device"] == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup = SimpleNamespace(world_size=held, rank=rank, backend=None,
                            coordinator_address=f"localhost:{spec['port']}")
    initialize_distributed(setup, dev, timeout_s=TIMEOUT_S)
    mesh = make_mesh(1, held)
    ctl = dist.new_group(backend="gloo")  # the driver's own: when to stop, the last reports

    def broadcast(t):
        dist.broadcast(t, 0, group=ctl)
        return t

    spans = Spans()
    model = program.build_model(cfg, seed, dev)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()} if rank == 0 else None
    opt_cfg = cfg["optimizer"]
    steps_per_epoch = int(cfg["dataset"]["train_size"]) // int(cfg["dataset"]["batch_size"])
    optimizer = make_optimizer(opt_cfg["name"], model.parameters(),
                               OptimizerargsConfig(**opt_cfg["args"]), steps_per_epoch)
    fed = []
    for i in range(ring):
        m = held_rows(cfg, seed, i, tr["surface"], dev)
        whole = TrainBatch(m.pos[None], m.feats[None], m.target[None],
                           torch.ones((1, shard * held), dtype=torch.bool, device=dev), None, None)
        local, _ = shard_point_batch(whole, mesh, shard_nodes=True, process_local=True)
        fed.append(TrainBatch(*(t.clone() for t in (local.pos, local.feats, local.target,
                                                    local.node_mask)), None, None))
        del m, whole, local
    if rank == 0:
        log(f"rank 0: model, optimizer and {ring} shards of {shard} points made")
    sharded_step = make_sharded_train_step(train_step, mesh, process_local=True)
    dropout = torch.Generator().manual_seed(traffic.stream_seed(seed, 3))
    losses, taken = [], [0]
    start = launches()

    def step(i):
        with spans.span("train_step"):
            loss, _ = sharded_step(model, optimizer, fed[i % ring], dropout)
            if cuda:
                torch.cuda.synchronize(dev)
        losses.append(loss.detach())
        taken[0] += 1

    capture = program.Capture(model) if rank == 0 else None
    step(0)
    out = {}
    if capture is not None:
        out["first_stages"] = capture.take()
        capture.remove()
        state = optimizer.optimizer.state
        beta1 = optimizer.optimizer.param_groups[0]["betas"][0]
        out["first_grad"] = {n: (state[p]["exp_avg"] / (1 - beta1)).detach().clone()
                             if p in state else torch.zeros_like(p)
                             for n, p in model.named_parameters()}
    for i in range(1, checked):
        step(i)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(checked, ring):
        step(i)

    if ctx is not None:
        ctx.setup_done()
    t0, n = time.perf_counter(), 0
    while True:
        elapsed = time.perf_counter() - t0
        if not broadcast(torch.tensor([int(n == 0 or elapsed < float(spec["seconds"]))])):
            break
        step(ring + n)
        n += 1
    window = losses[ring:]
    if rank == 0:
        log(f"window: {n} steps in {elapsed:.2f} s")

    traced = None
    if spec["trace"]:
        traced = Trace(dev, spans) if rank == 0 else None
        before = exchanged_bytes()
        with traced.segment() if traced is not None else contextlib.nullcontext():
            for i in range(int(tr["trace_items"])):
                step(i)
        if traced is not None:
            traced.items = int(tr["trace_items"])
            if before is not None:
                out["exchanged_bytes"] = (exchanged_bytes() - before) / traced.items

    want = {k: v * taken[0] for k, v in expected_launches(cfg, cuda).items()}
    off = torch.tensor([float(correctness.launch_mismatches(launches_since(start), want))],
                       dtype=torch.float64)
    mine = torch.cat([p.reshape(-1).double().cpu() for p in after.values()])
    apart = float((mine - broadcast(mine.clone())).abs().max())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    top = torch.tensor([float(peak), apart], dtype=torch.float64)
    dist.all_reduce(off, group=ctl)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=ctl)
    dist.destroy_process_group()
    if rank != 0:
        return None
    out.update(w0=w0, after=after, losses=[float(v) for v in losses[:checked]],
               failed=int((~torch.isfinite(torch.stack(window).float())).sum()),
               items=n, window_s=elapsed, spans=spans, trace=traced,
               launches_off=float(off), memory_peak=int(top[0]), ranks_apart=float(top[1]))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _watch(procs, stopping: threading.Event) -> None:
    """End the run at once when a rank fails, rather than leave rank 0 in a
    collective until its timeout."""
    for p in procs:
        if p.wait() != 0 and not stopping.is_set():
            log(f"a rank exited with {p.returncode}; ending the run")
            for q in procs:
                if q.poll() is None:
                    q.kill()
            os._exit(3)


def run(ctx) -> Outcome:
    cfg, tr = ctx.config, ctx.traffic
    _, shard, held = sizes(cfg)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        if torch.cuda.device_count() < held:
            raise RuntimeError(f"{held} node ranks need {held} cards, one each; found "
                               f"{torch.cuda.device_count()}")
        build_kernels(cfg)
        log("kernels built")
    spec = {"cell": ctx.cell, "config": cfg, "traffic": tr, "seed": ctx.seed,
            "seconds": ctx.seconds, "trace": ctx.trace, "device": "cuda" if cuda else "cpu",
            "port": _free_port(),
            "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    stopping = threading.Event()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)],
                                  env=env, stdout=2) for r in range(1, held)]
        threading.Thread(target=_watch, args=(procs, stopping), daemon=True).start()
        try:
            with own_cores(0, held):
                out = train(spec, 0, ctx)
            for p in procs:
                p.wait(timeout=TIMEOUT_S)
        finally:
            stopping.set()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    record = RunRecord(ctx.cell, cfg, ctx.device, items=out["items"], window_s=out["window_s"],
                       spans=out["spans"], trace=out["trace"])
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    log("program done; the reference follows the checked steps over the held shards")
    spec_ref = ref.Spec.from_config(cfg)
    checked = int(tr["checked_steps"])
    fed_ref, edges, over = [], [], 0.0
    for i in range(int(tr["meshes"])):
        m = held_rows(cfg, ctx.seed, i, tr["surface"], dev)
        cells, valid = ref.graph(spec_ref, m.pos)
        edges.append((ref.valid_edges(valid), ref.valid_edges(valid[:shard])))
        over += correctness.over_budget(spec_ref, [m.pos])
        if i < checked:
            fed_ref.append((m.pos, m.feats, m.target, cells, valid))
    if ctx.trace:
        record.counts = {
            "step_flops": sum(counting.train_step_flops(cfg, shard * held, e)
                              for e, _ in edges) / len(edges),
            "chips": held,
            "payload_backward": [counting_backward.payload_backward(
                cfg, shard, edges[i % len(edges)][1]) for i in range(int(tr["trace_items"]))]}
        if "exchanged_bytes" in out:
            record.counts["exchanged_bytes"] = out["exchanged_bytes"]
    gen = torch.Generator().manual_seed(traffic.stream_seed(ctx.seed, 3))
    seeds = [ref.layer_seeds(gen, spec_ref.layers) for _ in range(checked)]
    w0 = out["w0"]
    ref_losses, ref_grad, ref_after = ref_blocked.train_steps(
        w0, spec_ref, fed_ref, seeds, cfg["optimizer"]["args"],
        int(cfg["dataset"]["train_size"]) // int(cfg["dataset"]["batch_size"]))
    log(f"reference done: losses {ref_losses} (program {out['losses']})")
    checks = {
        **correctness.train_gaps(out["losses"], ref_losses, out["first_grad"], ref_grad,
                                 out["after"], ref_after, w0),
        **stage_gaps(w0, spec_ref, *fed_ref[0][:2], *fed_ref[0][3:], out["first_stages"], shard),
        "over_budget": over,
        "launches_off": out["launches_off"],
        "ranks_apart": out["ranks_apart"],
    }
    return Outcome({"train_step_ms": 1e3 * out["window_s"] / out["items"]}, out["items"],
                   out["failed"], checks, record, out["memory_peak"])


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = spec["tf32"]
    with own_cores(int(sys.argv[2]), sizes(spec["config"])[2]):
        train(spec, int(sys.argv[2]))
