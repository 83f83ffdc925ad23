"""Data-parallel and node-sharded execution of the port against the JAX
package on CPU: the shard-aligned sections bit for bit, the model over
S > 1 sections in one process, and two-process gloo runs (spawned as
tests/test_multiprocess.py spawns its ranks) of the node-sharded and the
data-parallel step and eval, each held against JAX's single-process step on
the same global batch, with unequal valid counts per rank and attention
dropout on; then the trainer and its command line, distributed, against the
undistributed trainer, with the reference's per-rank-mean validate quirk.

The model is tests/test_torch_port_processor_variants.py's small one (8x8x4
latent grid, 2 blocks, f32 attention). Dropout matches through explicit
bits, each rank taking its global rows of them. Tolerances are relative to
each reference: the loss to 1e-5, each gradient tensor and the prediction to
1e-4 of its max-abs (f32 on both sides, sums in other orders: the node
shards' accumulators are summed by an all-reduce).

Run as a script, this file is one rank of such a run:
    python tests/test_torch_port_distributed.py worker RANK WORLD PORT CASE OUT
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TIMEOUT = 240  # seconds a spawned step run may take
CLI_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                         env.get("PYTHONPATH", "")])
    return env


def _run_ranks(argvs, timeout):
    """Start one process a rank and wait for all; fail with their output."""
    procs = [subprocess.Popen(argv, env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"a rank failed:\n{out[-6000:]}"
    return outs


# --- the worker: one rank of a two-process step run -------------------------


def _edges_from(arrays, prefix):
    from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots, SectionedEdgeSlots

    if f"{prefix}/shards" in arrays:
        n = int(arrays[f"{prefix}/sections"])
        secs = tuple(EdgeSlots(torch.from_numpy(arrays[f"{prefix}/lat{i}"]),
                               torch.from_numpy(arrays[f"{prefix}/msk{i}"])) for i in range(n))
        return SectionedEdgeSlots(secs, int(arrays[f"{prefix}/shards"]))
    return EdgeSlots(torch.from_numpy(arrays[f"{prefix}/lat"]),
                     torch.from_numpy(arrays[f"{prefix}/msk"]))


def _worker(rank, world, port, case_path, out_path):
    import torch.distributed as dist

    import gaot3d_tpu_torch.models.transformer as ptransformer
    from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig,
                                         TransformerConfig, init_model)
    from gaot3d_tpu_torch.ops.attention import scaled_dot_product_attention
    from gaot3d_tpu_torch.parallel import (make_mesh, make_sharded_eval_step,
                                           make_sharded_train_step)
    from gaot3d_tpu_torch.parallel.sharding import all_reduce_sum
    from gaot3d_tpu_torch.train import OptimizerargsConfig, TrainBatch, make_optimizer
    from gaot3d_tpu_torch.train.step import NeuralField, eval_step, train_step
    from gaot3d_tpu_torch.weights import load_numpy_state_dict, numpy_state_dict

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    arrays = dict(np.load(case_path))
    with open(case_path + ".json") as f:
        spec = json.load(f)

    def model(i):
        """Model i of the spec with its weights (prefix m{i}/)."""
        t = spec["models"][i]["transformer"]
        attn = TransformerConfig(**{**t, "attn_config": AttentionConfig(**t["attn_config"]),
                                    "ffn_config": FFNConfig(**t["ffn_config"])})
        net = init_model(2, 1, "gaot_3d", MAGNOConfig(**spec["models"][i]["magno"]), attn,
                         latent_tokens=spec["latent"], device="cpu")
        prefix = f"m{i}/"
        return load_numpy_state_dict(net, {k[len(prefix):]: v for k, v in arrays.items()
                                           if k.startswith(prefix)})
    bits = [torch.from_numpy(arrays[k]) for k in sorted(a for a in arrays if a.startswith("bits"))]
    calls = iter(range(10 ** 6))

    def attention(q, k, v, dropout_rate=0.0, seed=None, bh_offset=0):
        # this rank's rows of the global bits of the layer
        b = None
        if dropout_rate > 0:
            full = bits[next(calls) % len(bits)]
            b = full[bh_offset:bh_offset + q.shape[0] * q.shape[1]].contiguous()
        return scaled_dot_product_attention(q, k, v, dropout_rate, dropout_bits=b)
    ptransformer.scaled_dot_product_attention = attention

    out = {}
    for case in spec["cases"]:
        name, data, node = case["name"], case["data"], case["node"]
        mesh = make_mesh(data, node)
        net = model(case.get("model", 0))
        p = case["batch"]
        edges = _edges_from(arrays, p)
        batch = TrainBatch(*(torch.from_numpy(arrays[f"{p}/{k}"])
                             for k in ("pos", "feats", "target", "mask")), edges, edges,
                           condition=torch.from_numpy(arrays["condition"]))
        shard = node > 1
        before = all_reduce_sum.calls
        pred, vloss = make_sharded_eval_step(eval_step, mesh, shard, replicate_outputs=True)(
            net, batch)
        out[f"{name}/allreduce_eval"] = all_reduce_sum.calls - before
        opt = make_optimizer("adamw", net.parameters(), OptimizerargsConfig(lr=1e-3), 1)
        nf = case.get("neural_field")
        nf = None if nf is None else NeuralField(*nf, torch.Generator().manual_seed(11))
        loss, norm = make_sharded_train_step(train_step, mesh, shard)(
            net, opt, batch, torch.Generator().manual_seed(3), nf)
        out[f"{name}/pred"] = pred.numpy()
        out[f"{name}/eval_loss"] = vloss.numpy()
        out[f"{name}/loss"] = loss.numpy()
        out[f"{name}/norm"] = norm.numpy()
        for k, g in numpy_state_dict(net, grads=True).items():
            out[f"{name}/grad/{k}"] = g
    np.savez(out_path, **out)
    dist.destroy_process_group()


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
    sys.exit(0)


# --- the tests ----------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gaot3d_tpu.ops.grid_graph as jgg  # noqa: E402
from gaot3d_tpu.ops.grid_graph import EdgeSlots as JaxEdgeSlots  # noqa: E402
import gaot3d_tpu_torch.data.host_graph as thg  # noqa: E402
from gaot3d_tpu_torch.ops.grid_graph import (EdgeSlots, FlatEdgeChunks,  # noqa: E402
                                             SectionedEdgeSlots)
from gaot3d_tpu_torch.parallel import shard_point_batch  # noqa: E402
from gaot3d_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from gaot3d_tpu_torch.train import TrainBatch  # noqa: E402
from gaot3d_tpu_torch.train.step import masked_mse  # noqa: E402
from gaot3d_tpu_torch.weights import numpy_state_dict  # noqa: E402
from test_torch_port_data import _slot_batch  # noqa: E402
from test_torch_port_processor_variants import (close, condition, configs,  # noqa: E402
                                                dense_bits, jax_loss, model_pair,
                                                patch_jax_attention, patch_port_attention,
                                                port_configs, port_state, problem)

N_DIST = 128  # points a cloud: 2 node shards of 64, chunks of 32


def rank_mean_total(sq, cnt, parts):
    """The JAX trainer's multi-process validate term of one step
    (gaot3d_tpu/train/trainer.py `_validate_multiprocess`): per-sample
    squared-error sums and valid counts of the global batch, in data ranks'
    order, each rank's batch mean sum(sq) / max(sum(cnt), 1), summed."""
    sq = np.asarray(sq, np.float64).reshape(parts, -1).sum(axis=1)
    cnt = np.maximum(np.asarray(cnt, np.float64).reshape(parts, -1).sum(axis=1), 1.0)
    return float((sq / cnt).sum())


def _jax_sections(lat, msk, mask, shards, chunk=32):
    perms, (sect,) = jgg.section_slots_shared([(lat, msk)], chunk, node_mask=mask,
                                              host_arrays=True, shards=shards)
    return perms, sect


@pytest.mark.parametrize("shards", [2, 4])
def test_section_slots_shared_shard_aligned_matches_jax(shards):
    """The deal (perm[b, s * n_local + l] = order[b, l * S + s]), the per-chunk
    K shared over the shards and the shard-major leaves, bit for bit, with
    padded nodes and two pairs (one aliased)."""
    lat, mask, node_mask = _slot_batch(3)
    lat2, mask2, _ = _slot_batch(4, K=3)
    mask2 = mask2 & node_mask[..., None]
    pairs = [(lat, mask), (lat2, mask2), (lat, mask)]
    jperm, jouts = jgg.section_slots_shared(pairs, 32, node_mask=node_mask, host_arrays=True,
                                            shards=shards)
    tperm, touts = thg.section_slots_shared(pairs, 32, node_mask=node_mask, shards=shards)
    assert np.array_equal(jperm, tperm)
    for j, t in zip(jouts, touts):
        assert t.shards == j.shards == shards and len(t.sections) == len(j.sections)
        for js, ts in zip(j.sections, t.sections):
            assert np.array_equal(np.asarray(js.lat_idx), ts.lat_idx.numpy())
            assert np.array_equal(np.asarray(js.mask), ts.mask.numpy())
    assert touts[0] is touts[2]
    # a shard's rows of every section are the unsharded layout of its point range
    n_local = lat.shape[1] // shards
    for s in range(shards):
        own = touts[0].node_shard(s, shards)
        assert own.shards == 1 and own.num_nodes == n_local
        rows = tperm[:, s * n_local:(s + 1) * n_local]
        got = np.concatenate([sec.mask.numpy().sum(-1) for sec in own.sections], axis=1)
        want = mask[np.arange(2)[:, None], rows].sum(-1)
        assert np.array_equal(got, want)
    # the shard-major walk hands each section the point rows of its slots,
    # and its inverse puts per-section rows back in the permuted node order
    rows = torch.from_numpy(tperm.astype(np.int64))
    walked = list(touts[0].blocks(rows[..., None], None))
    assert len(walked) == len(touts[0].sections)
    assert all(w is sec and none is None for (w, _, none), sec in zip(walked, touts[0].sections))
    got = np.concatenate([sec.mask.numpy().sum(-1) for sec in touts[0].sections], axis=1)
    want = mask[np.arange(2)[:, None], np.concatenate([r[..., 0].numpy() for _, r, _ in walked],
                                                      axis=1)].sum(-1)
    assert np.array_equal(got, want)
    assert torch.equal(touts[0].unblock([r for _, r, _ in walked])[..., 0], rows)
    with pytest.raises(ValueError, match=f"laid out for {shards} shards"):
        touts[0].node_shard(0, 2 * shards)
    with pytest.raises(ValueError, match="must divide N"):
        thg.section_slots_shared(pairs, 48, shards=shards)
    with pytest.raises(ValueError, match="must divide N"):
        jgg.section_slots_shared(pairs, 48, shards=shards)


def test_loader_section_shards_matches_jax(swept):
    """The loader with section_shards 2 (node sharding's layout), bit for bit."""
    from test_torch_port_data import _assert_same_batches, _loaders
    jl, tl = _loaders(swept, "train", "sectioned", shuffle=True, section_shards=2)
    batches = _assert_same_batches(jl, tl)
    assert all(b.enc_slots[0].shards == 2 for b in batches)


from test_torch_port_data import roots, swept  # noqa: E402,F401  (their fixtures)


@pytest.fixture(scope="module")
def sharded_problem():
    """The global batch of the step runs: 2 clouds of 128 points, cloud 1
    with 40 padded rows at its end (so rank 1 holds fewer valid nodes under
    either split), uniform slots and the shard-aligned sections of S = 2."""
    prob = problem(21, N=N_DIST, pad=40)
    pos, feats, target, mask, lat, msk = prob
    perms, sect = _jax_sections(lat, msk, mask, 2)
    rows = np.arange(2)[:, None]
    permuted = tuple(a[rows, perms] for a in (pos, feats, target, mask))
    return prob, permuted, sect


@pytest.fixture(scope="module")
def jax_refs(sharded_problem):
    """The conditioned rope3d model (2 blocks, attention dropout 0.1) in JAX
    on the global batch over uniform slots and over the S = 2 sections: the
    eval prediction, and the training loss and gradients on the same bits a
    layer (Pallas in interpret mode)."""
    prob, permuted, jsect = sharded_problem
    pos, feats, target, mask, lat, msk = prob
    magno, attn = configs("rope3d", True, rate=0.1, layers=2)
    jmodel, params, _ = model_pair(magno, attn, seed=12, prob=prob)
    blocked, dense = dense_bits(13, attn.num_layers, 2, 32)
    c = condition()
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_attention(mp, blocked)
        for name, (arrs, edges) in (
                ("uniform", ((pos, feats, target, mask),
                             JaxEdgeSlots(jnp.asarray(lat), jnp.asarray(msk)))),
                ("sections", (permuted, jsect))):
            p_, f_, _, m_ = (jnp.asarray(a) for a in arrs)
            pred = jmodel.apply(params, p_, f_, m_, encoder_slots=[edges],
                                decoder_slots=[edges], condition=jnp.asarray(c))
            loss, grads = jax.value_and_grad(jax_loss(jmodel, tuple(arrs) + (None, None), c,
                                                      edges=edges))(params)
            refs[name] = (np.asarray(pred), float(loss), port_state(grads, magno, attn),
                          float(np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                                            for g in jax.tree.leaves(grads)))))
    return magno, attn, params, blocked, dense, refs


def test_model_over_shard_aligned_sections_matches_jax(sharded_problem, jax_refs,
                                                       monkeypatch):
    """One process over S = 2 sections against JAX over the same sections:
    the eval forward (read through the [B, S, N/S] view, stitched back
    shard-major), and the training loss and every gradient on JAX's bits."""
    _, (pos, feats, target, mask), jsect = sharded_problem
    magno, attn, params, _, dense, refs = jax_refs
    want_pred, want_loss, want, _ = refs["sections"]
    pmagno, pattn = port_configs(magno, attn)
    from gaot3d_tpu_torch.models import init_model
    from gaot3d_tpu_torch.weights import load_numpy_state_dict
    pmodel = init_model(2, 1, "gaot_3d", pmagno, pattn, latent_tokens=(8, 8, 4), device="cpu")
    load_numpy_state_dict(pmodel, port_state(params, magno, attn))
    patch_port_attention(monkeypatch, dense)
    psect = SectionedEdgeSlots(tuple(EdgeSlots(torch.from_numpy(np.asarray(s.lat_idx)),
                                               torch.from_numpy(np.asarray(s.mask)))
                                     for s in jsect.sections), 2)
    t = torch.from_numpy
    args = (t(pos), t(feats), t(mask))
    kw = dict(encoder_slots=[psect], decoder_slots=[psect], condition=t(condition()))
    with torch.no_grad():
        close(pmodel.eval()(*args, **kw).numpy(), want_pred, 1e-4)
    pred = pmodel.train()(*args, **kw, generator=torch.Generator().manual_seed(0))
    loss = masked_mse(pred, t(target), t(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for key, g in numpy_state_dict(pmodel, grads=True).items():
        close(g, want[key], 1e-4, key)


def test_shard_point_batch_splits_every_layout():
    """Batch rows by data rank, point rows by node rank; slots with their
    rows, flat chunks by chunks, sections by each section's shard-major
    rows; aliased edges stay one object; the offset is the global row."""
    B, N, K = 4, 16, 3
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32))
    lat = torch.from_numpy(rng.integers(0, 9, (B, N, K)).astype(np.int32))
    msk = torch.from_numpy(rng.random((B, N, K)) < 0.5)
    slots = EdgeSlots(lat, msk)
    batch = TrainBatch(pos, pos, pos[..., :1], msk[..., 0], slots, slots)
    for data, node, rank in ((2, 2, 3), (4, 1, 2), (1, 2, 1)):
        mesh = Mesh(data, node, rank)
        local, off = shard_point_batch(batch, mesh, shard_nodes=node > 1)
        bl, nl = B // data, N // node
        b0, n0 = mesh.data_rank * bl, mesh.node_rank * nl
        assert off == b0 and local.enc_slots is local.dec_slots
        assert torch.equal(local.pos, pos[b0:b0 + bl, n0:n0 + nl])
        assert torch.equal(local.enc_slots.lat_idx, lat[b0:b0 + bl, n0:n0 + nl])
        local, off = shard_point_batch(local, mesh, process_local=True)
        assert off == mesh.data_rank * bl and local.pos.shape[0] == bl
    flat = FlatEdgeChunks(lat[..., 0].reshape(B, 4, 4), lat[..., 1].reshape(B, 4, 4),
                          msk[..., 0].reshape(B, 4, 4))
    local, _ = shard_point_batch(batch._replace(enc_slots=flat, dec_slots=None)
                                 if hasattr(batch, "_replace") else
                                 dataclasses.replace(batch, enc_slots=flat, dec_slots=None),
                                 Mesh(1, 2, 1), shard_nodes=True)
    assert torch.equal(local.enc_slots.src, flat.src[:, 2:]) and local.dec_slots is None
    sect = SectionedEdgeSlots((EdgeSlots(lat[:, :8], msk[:, :8]),
                               EdgeSlots(lat[:, 8:], msk[:, 8:])), shards=2)
    local, _ = shard_point_batch(dataclasses.replace(batch, enc_slots=sect, dec_slots=sect),
                                 Mesh(1, 2, 1), shard_nodes=True)
    assert local.enc_slots.shards == 1 and local.enc_slots is local.dec_slots
    assert torch.equal(local.enc_slots.sections[0].lat_idx, lat[:, 4:8])
    assert torch.equal(local.enc_slots.sections[1].lat_idx, lat[:, 12:16])
    with pytest.raises(ValueError, match="2 shards"):
        shard_point_batch(dataclasses.replace(batch, enc_slots=sect, dec_slots=sect),
                          Mesh(1, 4, 1), shard_nodes=True)
    # each format cuts itself: a list of one structure a scale, data rank 1's rows
    def tensors(edges):
        out = []
        edges.map(lambda t: out.append(t) or t)
        return out

    for edges in (slots, flat, sect):
        local, _ = shard_point_batch(dataclasses.replace(batch, enc_slots=[edges],
                                                         dec_slots=None), Mesh(2, 1, 1))
        assert isinstance(local.enc_slots, list) and local.enc_slots[0].layout == edges.layout
        cut, whole = tensors(local.enc_slots[0]), tensors(edges)
        assert len(cut) == len(whole) and all(torch.equal(a, b[2:]) for a, b in zip(cut, whole))
    with pytest.raises(ValueError, match="4 flat chunks do not split over 3 node ranks"):
        flat.node_shard(0, 3)


def _save_case(path, models, dense, batches, cases):
    """The spec (configs, cases) and arrays (weights, bits, batches) of a
    step run; `models` are (port MAGNOConfig, port TransformerConfig, state
    dict) triples."""
    arrays = {f"m{i}/{k}": np.asarray(v) for i, (_, _, sd) in enumerate(models)
              for k, v in sd.items()}
    arrays.update({f"bits{i}": d.numpy() for i, d in enumerate(dense)})
    arrays["condition"] = condition()
    for name, (arrs, edges) in batches.items():
        for key, a in zip(("pos", "feats", "target", "mask"), arrs):
            arrays[f"{name}/{key}"] = np.ascontiguousarray(a)
        if hasattr(edges, "sections"):
            arrays[f"{name}/shards"] = np.asarray(edges.shards)
            arrays[f"{name}/sections"] = np.asarray(len(edges.sections))
            for i, s in enumerate(edges.sections):
                arrays[f"{name}/lat{i}"] = np.asarray(s.lat_idx)
                arrays[f"{name}/msk{i}"] = np.asarray(s.mask)
        else:
            arrays[f"{name}/lat"], arrays[f"{name}/msk"] = edges
    np.savez(path, **arrays)
    spec = {"models": [{"magno": dataclasses.asdict(m), "transformer": dataclasses.asdict(a)}
                       for m, a, _ in models],
            "latent": [8, 8, 4], "cases": cases}
    with open(str(path) + ".json", "w") as f:
        json.dump(spec, f)


def _spawn_steps(tmp_path, *save_args):
    """Save a step run's case, run its two ranks, return their outputs."""
    case = os.path.join(str(tmp_path), "case.npz")
    _save_case(case, *save_args)
    port = _free_port()
    outs = [os.path.join(str(tmp_path), f"out{r}.npz") for r in range(2)]
    _run_ranks([[sys.executable, os.path.abspath(__file__), "worker", str(r), "2", str(port),
                 case, outs[r]] for r in range(2)], STEP_TIMEOUT)
    return [dict(np.load(o)) for o in outs]


def test_two_process_sharded_steps_match_jax(tmp_path, sharded_problem, jax_refs):
    """Two gloo ranks, each held to JAX's single-process step on the global
    batch (2 clouds, the second with 40 padded rows; the conditioned rope3d
    model with dropout 0.1 on the same bits): node_shards 2 over uniform
    slots and over S = 2 sections (the ranks hold 64 and 24 valid rows of
    cloud 1), data_parallel 2 (one cloud a rank, 128 and 88 valid rows).
    Eval prediction gathered and eval loss, train loss, gradient norm and
    every gradient after the all-reduce."""
    prob, permuted, jsect = sharded_problem
    pos, feats, target, mask, lat, msk = prob
    magno, attn, params, blocked, dense, refs = jax_refs
    ranks = _spawn_steps(
        tmp_path, [port_configs(magno, attn) + (port_state(params, magno, attn),)], dense,
        {"uniform": ((pos, feats, target, mask), (lat, msk)), "sections": (permuted, jsect)},
        [{"name": "node", "data": 1, "node": 2, "batch": "uniform"},
         {"name": "data", "data": 2, "node": 1, "batch": "uniform"},
         {"name": "node_sections", "data": 1, "node": 2, "batch": "sections"}])
    for name, batch in (("node", "uniform"), ("data", "uniform"),
                        ("node_sections", "sections")):
        want_pred, want_loss, want, norm = refs[batch]
        for r in ranks:
            close(r[f"{name}/pred"], want_pred, 1e-4, name)
            np.testing.assert_allclose(r[f"{name}/loss"], want_loss, rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(r[f"{name}/norm"], norm, rtol=1e-4, err_msg=name)
            for key in want:
                close(r[f"{name}/grad/{key}"], want[key], 1e-4, f"{name} {key}")
        assert ranks[0][f"{name}/allreduce_eval"] == (1 if name != "data" else 0)
    # the ranks' valid counts differ: rank 1's half of cloud 1 is the padded one
    assert mask[1, :64].sum() == 64 and mask[1, 64:].sum() == 24


# --- the trainer and its command line ------------------------------------------


def _trainer_config(tmp, name, **setup):
    from test_torch_port_trainer import small_config
    cfg = small_config(tmp, name)
    cfg["optimizer"]["args"]["epoch"] = 1
    cfg["setup"].update(setup)
    return cfg


def _losses(cfg):
    with np.load(cfg["path"]["loss_path"].rsplit(".", 1)[0] + ".npz") as f:
        return f["train_loss"], f["val_loss"]


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """The undistributed trainer (batch 2, one epoch: 2 steps, validation on
    2 samples); it generates and sweeps the data the other runs read."""
    from test_torch_port_trainer import port_trainer
    tmp = tmp_path_factory.mktemp("dist_trainer")
    cfg = _trainer_config(tmp, "single")
    trainer = port_trainer(cfg, tmp, "single.json")
    result = trainer.fit()
    return tmp, cfg, trainer, result


def test_distributed_world_one_is_the_undistributed_trainer(single_run):
    """`distributed: true` in one process (a gloo group of one): the same
    losses, bit for bit, and the files of rank 0."""
    import torch.distributed as dist

    from test_torch_port_trainer import port_trainer
    tmp, _, _, want = single_run
    cfg = _trainer_config(tmp, "world1", distributed=True)
    try:
        trainer = port_trainer(cfg, tmp, "world1.json")
        assert trainer.mesh.world == 1 and trainer.is_main and dist.get_world_size() == 1
        got = trainer.fit()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert got["train"]["loss"] == want["train"]["loss"]
    assert got["valid"]["loss"] == want["valid"]["loss"]
    assert os.path.exists(cfg["path"]["ckpt_path"])


def _cli_ranks(tmp, name, world, timeout, **setup):
    port = _free_port()
    argvs = []
    for r in range(world):
        cfg = _trainer_config(tmp, name, distributed=True, world_size=world, rank=r,
                              coordinator_address=f"localhost:{port}", **setup)
        if setup.get("data_parallel", 1) > 1:
            cfg["dataset"]["batch_size"] = 2 // setup["data_parallel"]
        path = os.path.join(str(tmp), f"{name}{r}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        argvs.append([sys.executable, "-m", "gaot3d_tpu_torch", "--config", path])
    _run_ranks(argvs, timeout)
    return cfg


def test_two_process_cli_data_parallel_keeps_the_per_rank_mean_validate(single_run):
    """data_parallel 2, one sample a rank: the train losses of the global
    batch of 2 (1e-4 relative: another section padding, sums in other
    orders), and validate's reference quirk. JAX's multi-process validate
    (gaot3d_tpu/train/trainer.py `_validate_multiprocess`) sums each rank's
    batch mean, sum(sq) / max(sum(cnt), 1) over its rows, over the ranks and
    divides by the set's size: here every sample its own rank's batch, so
    the mean of the per-sample means, not the undistributed batch mean."""
    tmp, single_cfg, trainer, _ = single_run
    cfg = _cli_ranks(tmp, "dp", 2, CLI_TIMEOUT, data_parallel=2)
    train, val = _losses(cfg)
    want_train, want_val = _losses(single_cfg)
    np.testing.assert_allclose(train, want_train, rtol=1e-4)
    sq, cnt = [], []
    for batch in trainer.val_loader:
        pred, _ = trainer.eval_step(batch)
        diff = (pred - torch.from_numpy(batch.target)) * torch.from_numpy(
            batch.node_mask)[..., None]
        sq += (diff * diff).sum(dim=(1, 2)).tolist()
        cnt += (batch.node_mask.sum(axis=1) * pred.shape[-1]).tolist()
    quirk = rank_mean_total(np.asarray(sq), np.asarray(cnt), 2) / 2
    np.testing.assert_allclose(val, [quirk], rtol=1e-4)
    assert abs(quirk - want_val[0]) > 1e-3 * abs(want_val[0])  # the quirk shows
    assert os.path.exists(cfg["path"]["ckpt_path"])
    assert len(open(cfg["path"]["database_path"]).read().splitlines()) == 2  # one row


def test_two_process_cli_node_shards_match_the_undistributed_trainer(single_run):
    """node_shards 2: both ranks read the same batch of 2, each half of every
    cloud through shard-aligned sections (section_shards 2), the encoder's
    accumulator summed over the pair: the undistributed losses, 1e-4
    relative."""
    tmp, single_cfg, _, _ = single_run
    cfg = _cli_ranks(tmp, "ns", 2, CLI_TIMEOUT, node_shards=2)
    train, val = _losses(cfg)
    want_train, want_val = _losses(single_cfg)
    np.testing.assert_allclose(train, want_train, rtol=1e-4)
    np.testing.assert_allclose(val, want_val, rtol=1e-4)


def test_node_shards_without_distributed_are_ignored_as_in_jax(single_run):
    """The JAX trainer reads node_shards only under `distributed: true`; so
    does the port: the undistributed losses, bit for bit."""
    from test_torch_port_trainer import port_trainer
    tmp, _, _, want = single_run
    trainer = port_trainer(_trainer_config(tmp, "ns1", node_shards=2), tmp, "ns1.json")
    assert trainer.mesh is None and trainer.section_shards == 1
    got = trainer.fit()
    assert got["train"]["loss"] == want["train"]["loss"]


def test_a_world_of_several_processes_needs_distributed(single_run):
    """`world_size` 2 without `distributed: true` raises (the JAX trainer
    would start a multi-process group and run no mesh)."""
    import gaot3d_tpu_torch.config as tconfig
    from gaot3d_tpu_torch.train.trainer import init_trainer
    from test_torch_port_trainer import write_config
    tmp, _, _, _ = single_run
    cfg = _trainer_config(tmp, "bad", world_size=2)
    with pytest.raises(ValueError, match="needs setup.distributed"):
        init_trainer(tconfig.load_run_config(write_config(cfg, os.path.join(str(tmp), "b.json"))))


def test_neural_field_draws_of_a_data_rank_are_its_rows_of_the_global_draw():
    """Data-parallel neural-field steps draw the global batch's numbers and
    keep their rows, so a row samples the nodes it samples in one process."""
    from gaot3d_tpu_torch.train.step import sample_nodes_without_replacement
    mask = torch.from_numpy(np.random.default_rng(0).random((4, 50)) < 0.8)
    idx, valid = sample_nodes_without_replacement(mask, 20, torch.Generator().manual_seed(7))
    for r in range(2):
        got, ok = sample_nodes_without_replacement(mask[2 * r:2 * r + 2], 20,
                                                   torch.Generator().manual_seed(7),
                                                   row_offset=2 * r, total_rows=4)
        assert torch.equal(got, idx[2 * r:2 * r + 2]) and torch.equal(ok, valid[2 * r:2 * r + 2])


def test_seeded_dropout_at_a_batch_offset_is_the_whole_batchs_rows():
    """A rank holding batch row 1 of 2 passes bh_offset = H: the plain
    versions (which the kernels are held to on the card) draw the bits,
    forward and gradients of that row of one call over the whole batch."""
    from gaot3d_tpu_torch.kernels import dropout_bits as k4
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    rng = np.random.default_rng(3)
    B, H, S, Skv, D = 2, 3, 20, 14, 8
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, s, D)).astype(np.float32))
               for s in (S, Skv, Skv))
    seed, rate = 0x1234_5678_9ABC, 0.3
    whole = k4.export_dropout_bits(seed, B * H, S, Skv, device="cpu")
    row = k4.export_dropout_bits(seed, H, S, Skv, device="cpu", bh_offset=H)
    assert torch.equal(row.view(torch.int32), whole[H:].view(torch.int32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = k1.attention(*leaves, rate, seed)
    out.sum().backward()
    one = [t[1:].clone().requires_grad_() for t in (q, k, v)]
    out1 = k1.attention(*one, rate, seed, bh_offset=H)
    out1.sum().backward()
    assert torch.equal(out1, out[1:])
    for a, b in zip(one, leaves):
        assert torch.equal(a.grad, b.grad[1:])
    other = k1.attention(*(t[1:] for t in (q, k, v)), rate, seed)  # without the offset
    assert not torch.equal(other, out[1:])


# (label, MAGNOConfig changes): the modular encoder's reductions under node sharding
MODULAR = (
    ("unfused scatter", dict(fused_encoder=False, fused_decoder=False, segment_impl="scatter")),
    ("unfused sort", dict(fused_encoder=False, fused_decoder=False, segment_impl="sort")),
    ("cosine attention", dict(use_attn=True, attention_type="cosine")),
    ("dot product", dict(use_attn=True, attention_type="dot_product")),
    ("pointnet max", dict(embedding_method="pointnet", use_geoembed=[True, True],
                          pooling="max")),
    ("pointnet mean", dict(embedding_method="pointnet", use_geoembed=[True, True],
                           pooling="mean")),
    ("decoder geoembed", dict(use_geoembed=[True, True])),
    ("neural field", {}),  # the fused encoder, trained by neural field
)
NF_NODES = (48, 40)  # input and query nodes a cloud (of 128): two draws


def test_two_process_node_sharded_modular_encoders_match_one_process(tmp_path,
                                                                     sharded_problem):
    """node_shards 2 over the modular encoder and decoder variants (the
    unfused statistical encoder under 'scatter' and 'sort', cosine and
    dot-product edge attention, PointNet max and mean pooling on both sides,
    the decoder's statistical geoembed) and a neural-field step (48 input
    and 40 query nodes drawn over the whole cloud, each rank keeping its
    shard's): the ranks join their per-cell sums, softmax states and maxima,
    and their gathered eval prediction, train loss and every gradient equal
    the port's one-process step on the global batch
    (itself held to JAX by test_torch_port_variants*.py): loss 1e-5,
    prediction and each gradient 1e-4 of its max-abs (the key projection's
    bias, whose gradient is 0 in exact math since the softmax cancels q.k_b,
    of the key weights' gradient's max-abs). Dropout off."""
    from gaot3d_tpu_torch.models import init_model
    from gaot3d_tpu_torch.train import OptimizerargsConfig, make_optimizer
    from gaot3d_tpu_torch.train.step import NeuralField, eval_step, train_step
    prob, _, _ = sharded_problem
    pos, feats, target, mask, lat, msk = prob
    magno, attn = configs("rope", False, layers=2)
    t = torch.from_numpy
    slots = EdgeSlots.from_numpy(lat, msk)
    models, cases, want = [], [], {}
    for i, (label, over) in enumerate(MODULAR):
        pmagno, pattn = port_configs(dataclasses.replace(magno, **over), attn)
        net = init_model(2, 1, "gaot_3d", pmagno, pattn, latent_tokens=(8, 8, 4), device="cpu",
                         generator=torch.Generator().manual_seed(i))
        models.append((pmagno, pattn, numpy_state_dict(net)))
        nf = list(NF_NODES) if label == "neural field" else None
        cases.append({"name": label, "data": 1, "node": 2, "batch": "uniform", "model": i,
                      "neural_field": nf})
        batch = TrainBatch(t(pos), t(feats), t(target), t(mask), slots, slots)
        pred, _ = eval_step(net, batch)
        opt = make_optimizer("adamw", net.parameters(), OptimizerargsConfig(lr=1e-3), 1)
        loss, _ = train_step(net, opt, batch, torch.Generator().manual_seed(3),
                             None if nf is None else
                             NeuralField(*nf, torch.Generator().manual_seed(11)))
        want[label] = (pred.numpy(), loss.item(), numpy_state_dict(net, grads=True))
    ranks = _spawn_steps(tmp_path, models, [], {"uniform": ((pos, feats, target, mask),
                                                            (lat, msk))}, cases)
    for label, (want_pred, want_loss, grads) in want.items():
        for r in ranks:
            close(r[f"{label}/pred"], want_pred, 1e-4, label)
            np.testing.assert_allclose(r[f"{label}/loss"], want_loss, rtol=1e-5, err_msg=label)
            for key, g in grads.items():
                got = r[f"{label}/grad/{key}"]
                if key.endswith("key_proj.bias"):
                    scale = np.abs(grads[key.replace(".bias", ".weight")]).max()
                    assert np.abs(got - g).max() <= 1e-4 * scale, f"{label} {key}"
                else:
                    close(got, g, 1e-4, f"{label} {key}")
