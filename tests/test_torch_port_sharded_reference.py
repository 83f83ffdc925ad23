"""The node-sharded training step of the port, four gloo ranks on the CPU,
against the benchmark's plain reference over the union of the shards; the
trainer under torchrun's variables against the same step; and the
exchange's span and byte counter.

(a) The benchmark's drivaerml-train-4chip cell through its own driver
(benchmark/drivers/train_sharded.py: rank 0 in this process, three ranks
it starts), with pressure.yaml's structure (MAGNO with the statistical
geoembed, budget-8 slots built in every forward, f32 kernel MLPs, a U-ViT
with bf16 attention and dropout 0.1, AdamW 'mix') on an 8x8x4 grid, two
blocks and 4,096-point meshes, 4 of their 8 shards held. The driver holds
three steps to benchmark/reference/ over the 2,048 points of the held
shards. Tolerances: the loss 2e-5 relative (bf16 attention rounds its
probabilities apart where the f32 sums before them run in another order);
the gradient's and the three steps' change's worst leaf norm 2e-3 and 6e-3
of the larger of its and the median leaf's norm (AdamW's first steps divide
small gradients by their own size); the GNO mean 1e-6 and the decoder 1e-6
relative L2 (f32 sums in another order); the encoder's output 5e-5 (its
geoembed z-normalises features that the f32 eigenvalue guard moves).

(b) Four ranks started with torchrun's variables (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK) run the trainer of a config with
`distributed: true` and `node_shards: 4` on a batch of its loader, and the
driver's sequence (`shard_point_batch(..., shard_nodes=True)`, then
`make_sharded_train_step` around `train_step`) on copies of its model,
optimizer and generator: the same loss and parameters, bit for bit. The
same ranks count the bytes one step all-reduces (parallel/sharding.py
`all_reduce_.bytes`) against the shapes, and open `gaot.node_allreduce`
inside a profiler session and no range outside one.

Run as a script, this file is one rank of (b):
    python tests/test_torch_port_sharded_reference.py worker CONFIG OUT
"""
import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
TIMEOUT = 240  # seconds the spawned ranks may take


def _worker(config_path, out_path):
    from torch.profiler import ProfilerActivity, profile

    from gaot3d_tpu_torch import config as tconfig
    from gaot3d_tpu_torch import tracing
    from gaot3d_tpu_torch.parallel import make_sharded_train_step, shard_point_batch, sharding
    from gaot3d_tpu_torch.train import TrainBatch, train_step
    from gaot3d_tpu_torch.train.trainer import init_trainer

    torch.set_num_threads(1)
    trainer = init_trainer(tconfig.load_run_config(config_path))
    mesh = trainer.mesh
    host = next(iter(trainer.train_loader))
    whole = TrainBatch(*(torch.from_numpy(np.asarray(a)) for a in
                         (host.pos, host.feats, host.target, host.node_mask)), None, None)

    def copies():
        model, opt = copy.deepcopy((trainer.model, trainer.optimizer))
        return model, opt, torch.Generator().set_state(trainer.generator.get_state())

    driver_model, driver_opt, driver_gen = copies()
    traced_model, traced_opt, traced_gen = copies()
    quiet_model, quiet_opt, quiet_gen = copies()
    before = sharding.all_reduce_.bytes
    loss = trainer.train_step(host)
    exchanged = sharding.all_reduce_.bytes - before
    # the driver's sequence: the rank's rows cut from the global batch and kept, then the
    # sharded step
    local, _ = shard_point_batch(whole, mesh, shard_nodes=True, process_local=True)
    local = TrainBatch(*(t.clone() for t in (local.pos, local.feats, local.target,
                                             local.node_mask)), None, None)
    step = make_sharded_train_step(train_step, mesh, process_local=True)
    driver_loss, _ = step(driver_model, driver_opt, local, driver_gen)
    same = bool(torch.equal(loss, driver_loss)) and all(
        torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                          driver_model.state_dict().values()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(traced_model, traced_opt, local, traced_gen)
    inside = sum(e.name == sharding.NODE_ALLREDUCE for e in prof.events())

    def opened(name):
        raise AssertionError(f"{name} opened a profiler range outside a session")
    tracing.torch.profiler.record_function = opened
    step(quiet_model, quiet_opt, local, quiet_gen)

    acc = whole.pos.shape[0] * trainer.model.grid.num_tokens \
        * (trainer.model_config.args.magno.lifting_channels + 11)  # values and moments
    grads = sum(p.numel() for p in trainer.model.parameters() if p.grad is not None) * 4
    want = (2 * acc * 4  # the encoder's accumulator forward and its cotangent, f32
            + 8 + 4  # the loss's valid count (int64) and the global loss (f32)
            + grads)
    with open(out_path, "w") as f:
        json.dump({"rank": mesh.rank, "node": mesh.node, "node_rank": mesh.node_rank,
                   "same": same, "loss": float(loss), "exchanged": exchanged, "want": want,
                   "inside": inside}, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    sys.path.insert(0, REPO)
    _worker(sys.argv[2], sys.argv[3])
    sys.exit(0)


# --- the tests ----------------------------------------------------------------

from benchmark import harness  # noqa: E402
from benchmark.tests.tiny import SEED, TINY  # noqa: E402
from test_torch_port_cpu import child_env  # noqa: E402
from test_torch_port_trainer import port_trainer, small_config  # noqa: E402

CELL = "drivaerml-train-4chip"
TOLERANCES = {"loss_gap": 2e-5, "grad_gap": 2e-3, "change_gap": 6e-3, "gno_gap": 1e-6,
              "enc_gap": 5e-5, "dec_gap": 1e-6, "over_budget": 0, "launches_off": 0,
              "ranks_apart": 0}


def test_four_gloo_ranks_through_the_driver_equal_the_reference_over_the_union(monkeypatch):
    """One thread a rank: the plain versions' sums then run in one order, and
    the tiny grid's geoembed, whose eigenvalue guard a reordered sum can
    flip, stays within its tolerance."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run_cell(CELL, SEED, 0.5, False, "cpu", config_over=TINY,
                             traffic_over={"meshes": 3})
    finally:
        torch.set_num_threads(threads)
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert set(checks) == set(TOLERANCES)
    for name, tol in TOLERANCES.items():
        assert checks[name] <= tol, (name, checks)
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["count"] == RANKS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def torchrun_ranks(tmp_path_factory):
    """The four ranks of (b), on a dataset the undistributed trainer made."""
    tmp = tmp_path_factory.mktemp("sharded_trainer")
    cfg = small_config(tmp, "single", update_pt_files_with_edges=False)
    cfg["model"]["args"]["magno"].pop("edge_layout")  # slots built in every forward
    cfg["model"]["args"]["magno"]["slot_budget"] = 8
    cfg["model"]["args"]["transformer"]["attn_config"]["atten_dropout"] = 0.1
    port_trainer(cfg, tmp, "single.json")  # generates the dataset
    cfg["setup"].update(distributed=True, node_shards=RANKS)
    path = os.path.join(str(tmp), "sharded.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    port = _free_port()
    procs, outs = [], []
    for r in range(RANKS):
        outs.append(os.path.join(str(tmp), f"rank{r}.json"))
        env = child_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(RANKS),
                        MASTER_ADDR="localhost", MASTER_PORT=str(port), JAX_PLATFORMS="cpu",
                        OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "worker",
                                       path, outs[r]], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = []
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"a rank failed:\n{log[-6000:]}"
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    return ranks


def test_the_trainer_under_torchrun_variables_takes_the_drivers_step(torchrun_ranks):
    assert [r["rank"] for r in torchrun_ranks] == list(range(RANKS))
    assert all(r["node"] == RANKS and r["node_rank"] == r["rank"] for r in torchrun_ranks)
    assert all(r["same"] for r in torchrun_ranks)
    assert len({r["loss"] for r in torchrun_ranks}) == 1  # the global loss on every rank


def test_the_byte_counter_counts_a_steps_all_reduces(torchrun_ranks):
    for r in torchrun_ranks:
        assert r["exchanged"] == r["want"], r


def test_node_allreduce_opens_only_inside_a_profiler_session(torchrun_ranks):
    """Inside a session the step opens the span at the encoder's sum, the
    loss's count and the global loss; outside one it opens no range (the
    step ran with record_function raising)."""
    for r in torchrun_ranks:
        assert r["inside"] == 3, r
