"""Closed loop with one client over the port's eval forward: each request is
the next of a ring of seeded meshes held in host memory (pageable). A request
starts when the client hands over its host arrays and ends when the
prediction of every node is back in host memory, in the client's node order.

The configuration's `edges` says how the edges are made:
  host_sections: the host builds the slots (`data/host_graph.py`
    build_edge_slots_host, native) and sections them by degree, the node
    arrays are permuted into the sections' order and uploaded with them,
    `serve.make_edge_arg_model`'s forward runs, and the prediction is put
    back into the client's order on the host;
  device: the node arrays are uploaded and `serve.make_device_edge_model`'s
    forward builds its slots on the card.
Set-up warms with `warm_requests` requests. After the window a sample of
`compare_requests` finished requests, drawn from the seed (a reservoir kept
through the window), is held against the reference (correctness.stage_gaps):
every node's prediction, and the encoder's output and the decoder's input
that forward left, which hooks on the model hold by reference.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict

import numpy as np
import torch

from benchmark import correctness, counting, program, traffic
from benchmark.harness import Outcome, RunRecord, log
from benchmark.reference import model as ref
from benchmark.trace import DeviceTimer, Trace


def expected_launches(cfg: dict, sections: int, cuda: bool) -> dict:
    """An eval forward's launches: K1 once a processor block, K5 once a
    section (or once, over slots built on the card), the bf16 body under
    kernel_dtype bfloat16; no backward."""
    if not cuda:
        return dict.fromkeys(program.launches(), 0)
    layers = int(cfg["model"]["transformer"]["num_layers"])
    bf16 = cfg["model"]["magno"].get("kernel_dtype", "float32") == "bfloat16"
    return {"k1": layers, "k2": 0, "k3": 0, "k5": sections,
            "k5_bf16": sections if bf16 else 0, "k5b": 0, "k5b_bf16": 0}


class Server:
    """The request path of one configuration."""

    def __init__(self, cfg: dict, model, device, record: RunRecord):
        from gaot3d_tpu_torch.serve import make_device_edge_model, make_edge_arg_model

        self.cfg, self.device, self.record = cfg, device, record
        self.host = cfg["edges"] == "host_sections"
        if cfg["edges"] not in ("host_sections", "device"):
            raise ValueError(f"unknown edges {cfg['edges']!r}")
        self.infer = make_edge_arg_model(model) if self.host else make_device_edge_model(model)
        self.forward = record.forward = DeviceTimer(device)
        self.capture = program.Capture(model)
        self.sections = 1

    def _host_graph(self, pos: np.ndarray, feats: np.ndarray):
        from gaot3d_tpu_torch.data.host_graph import (build_edge_slots_host,
                                                      section_slots_by_degree_np)
        from gaot3d_tpu_torch.ops.grid_graph import LatentGrid

        magno = self.cfg["model"]["magno"]
        grid = LatentGrid(dims=tuple(self.cfg["model"]["latent_tokens"]))
        lat, msk = build_edge_slots_host(pos, grid, float(magno["gno_radius"]),
                                         strategy=magno["neighbor_strategy"],
                                         budget=int(magno["slot_budget"]))
        perm, secs = section_slots_by_degree_np(lat, msk, int(self.cfg["section_chunk"]))
        return perm, secs, pos[perm], feats[perm]

    def __call__(self, pos: torch.Tensor, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One request: host tensors [N, 3] in; the host prediction [N, C_out]
        out as "pred", with the forward's captured stages on the card."""
        from gaot3d_tpu_torch.ops.grid_graph import SectionedEdgeSlots

        spans = self.record.spans
        with spans.span("request"):
            if self.host:
                with spans.span("host_graph"):
                    perm, secs, pos_np, feats_np = self._host_graph(pos.numpy(), feats.numpy())
                with spans.span("upload"):
                    p = torch.from_numpy(pos_np).to(self.device)[None]
                    f = torch.from_numpy(feats_np).to(self.device)[None]
                    slots = SectionedEdgeSlots.from_numpy(
                        [(la[None], ma[None]) for la, ma in secs], device=self.device)
                self.sections = len(secs)
                edges = (slots, slots)
            else:
                with spans.span("upload"):
                    p, f = pos.to(self.device)[None], feats.to(self.device)[None]
                edges = ()
            mask = torch.ones(p.shape[:2], dtype=torch.bool, device=self.device)
            with self.forward.region():
                out = self.infer(p, f, mask, *edges)
            with spans.span("download"):
                pred = out[0].cpu()
            if self.host:
                with spans.span("reorder"):
                    back = torch.empty_like(pred)
                    back[torch.from_numpy(perm)] = pred
                    pred = back
        return {**self.capture.take(), "pred": pred}


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    record = RunRecord(ctx.cell, cfg, ctx.device)
    ring, nodes = int(tr["meshes"]), int(cfg["nodes"])

    model = program.build_model(cfg, ctx.seed, dev).eval()
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    host = []
    for i in range(ring):
        m = traffic.make_mesh(nodes, ctx.seed, i, tr["surface"], dev)
        host.append((m.pos.cpu(), m.feats.cpu()))
        del m
    server = Server(cfg, model, dev, record)
    want = dict.fromkeys(program.launches(), 0)
    start = program.launches()

    def request(i):
        got = server(*host[i % ring])
        for k, v in expected_launches(cfg, server.sections, cuda).items():
            want[k] += v
        return got

    for i in range(int(tr["warm_requests"])):
        request(i)
    server.forward.pairs.clear()
    record.spans.seconds.clear()

    keep = int(tr["compare_requests"])
    rng = random.Random(traffic.stream_seed(ctx.seed, 4))
    sample, failed = [], 0
    ctx.setup_done()
    t0, n = time.perf_counter(), 0
    while True:
        i = int(tr["warm_requests"]) + n
        try:
            got = request(i)
        except (RuntimeError, ValueError) as exc:  # a failed request misses its latency
            failed += 1
            record.spans.seconds["request"].append(float("inf"))
            print(f"request {n} failed: {exc!r}")
            got = None
        if got is not None:  # a uniform sample of the finished requests
            if len(sample) < keep:
                sample.append((i % ring, got))
            elif rng.random() < keep / (n + 1 - failed):
                sample[rng.randrange(keep)] = (i % ring, got)
        del got
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    record.window_s = time.perf_counter() - t0
    record.items = n - failed
    log(f"window: {n} requests ({failed} failed) in {record.window_s:.2f} s")
    latencies = sorted(record.spans.seconds["request"])

    if ctx.trace:  # the window's spans stay the per-layer metrics' source
        saved = ({k: list(v) for k, v in record.spans.seconds.items()},
                 list(record.forward.pairs))
        record.trace = Trace(dev, record.spans)
        with record.trace.segment():
            for i in range(int(tr["trace_items"])):
                request(i)
        record.trace.items = int(tr["trace_items"])
        record.spans.seconds.clear()
        record.spans.seconds.update(saved[0])
        record.forward.pairs[:] = saved[1]
    launched = program.launches_since(start)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    server.capture.remove()
    del model, server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    log("program freed; the reference runs the compared meshes")
    spec = ref.Spec.from_config(cfg)
    meshes = [(p.to(dev), f.to(dev)) for p, f in host]
    gaps = [correctness.stage_gaps(w0, spec, *meshes[j], got) for j, got in sample]
    del sample
    if ctx.trace:
        edges = [ref.valid_edges(ref.graph(spec, p)[1]) for p, _ in meshes]
        flops = [counting.forward_flops(cfg, nodes, e) for e in edges]
        record.counts = {"forward_flops": sum(flops) / len(flops),
                         "payload": [counting.payload(cfg, nodes, edges[i % ring])
                                     for i in range(int(tr["trace_items"]))]}
    log(f"reference done: gaps {gaps}")
    checks = {**correctness.worst(gaps),
              "over_budget": correctness.over_budget(spec, (p for p, _ in meshes)),
              "launches_off": float(correctness.launch_mismatches(launched, want))}
    p90 = float(np.percentile(np.asarray(latencies) * 1e3, 90)) if latencies else float("nan")
    e2e = {"requests_per_s": record.items / record.window_s, "request_ms_p90": p90}
    return Outcome(e2e, n, failed, checks, record, int(memory_peak))
