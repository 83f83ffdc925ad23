"""The port's neural-field strategy, serving with edges built on the device,
and the trainer in slot mode 'device', against the JAX package on the CPU.

- The node sampler: k distinct nodes a graph from an explicit generator.
- The neural-field loss and every gradient against `jax.grad` of the JAX
  trainer's loss (`gather_nodes`, `model.apply(query_pos=, query_mask=)`,
  `masked_mse`) on the same sampled indices: the flagship test model of
  tests/test_degree_sections.py, f32 attention, dropout 0, slots built
  inside both forwards.
- `load_inference(edges="device")` against JAX `model.apply` with query
  points.
- `configs/examples/synthetic/neural_field.yaml` through the port's command
  line, and full-grid training in slot mode 'device' against the JAX
  trainer.
"""
import copy
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu import config as jconfig
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu.train.trainer import gather_nodes as jax_gather_nodes
from gaot3d_tpu.train.trainer import init_trainer as jax_init_trainer
from gaot3d_tpu.train.trainer import masked_mse as jax_masked_mse
from gaot3d_tpu_torch import cli
from gaot3d_tpu_torch.serve import export_inference, load_inference
from gaot3d_tpu_torch.train import (NeuralField, TrainBatch, gather_nodes, neural_field_loss,
                                    sample_nodes_without_replacement)
from gaot3d_tpu_torch.weights import numpy_state_dict
from test_torch_port_device_edges import _jax_and_port
from test_torch_port_trainer import port_trainer, small_config, write_config
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF_CONFIG = os.path.join(REPO, "configs", "examples", "synthetic", "neural_field.yaml")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# --- the node sampler


def test_sampler_draws_distinct_valid_nodes():
    mask = torch.ones(3, 500, dtype=torch.bool)
    mask[1, 300:] = False
    mask[2, ::2] = False
    idx, valid = sample_nodes_without_replacement(mask, 120, torch.Generator().manual_seed(3))
    assert idx.shape == valid.shape == (3, 120) and idx.dtype == torch.int64
    for b in range(3):
        assert len(set(idx[b].tolist())) == 120
        assert bool(mask[b, idx[b]].all()) and bool(valid[b].all())


def test_sampler_flags_the_extra_picks_past_the_valid_count():
    mask = torch.zeros(2, 64, dtype=torch.bool)
    mask[0, :10] = True
    mask[1, 50:] = True
    idx, valid = sample_nodes_without_replacement(mask, 30, torch.Generator().manual_seed(4))
    assert torch.equal(valid, torch.gather(mask, 1, idx))
    assert valid.sum(dim=1).tolist() == [10, 14]
    # the valid picks come first (smallest draws), then invalid nodes, in
    # ascending index on the +inf tie, as jax.lax.top_k orders them
    assert bool(valid[:, :10].all()) and not bool(valid[0, 10:].any())
    assert idx[0, 10:].tolist() == list(range(10, 30))
    for b in range(2):
        assert len(set(idx[b].tolist())) == 30


def test_sampler_repeats_for_a_seed_and_reads_no_global_rng():
    mask = torch.rand(2, 1000, generator=torch.Generator().manual_seed(0)) < 0.8
    torch.manual_seed(123)
    state = torch.get_rng_state()
    a = sample_nodes_without_replacement(mask, 200, torch.Generator().manual_seed(7))
    b = sample_nodes_without_replacement(mask, 200, torch.Generator().manual_seed(7))
    c = sample_nodes_without_replacement(mask, 200, torch.Generator().manual_seed(8))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    x = torch.arange(2 * 1000 * 3, dtype=torch.float32).reshape(2, 1000, 3)
    got = gather_nodes(x, a[0])
    assert torch.equal(got, x[torch.arange(2)[:, None], a[0]])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_gather_nodes(jnp.asarray(x.numpy()),
                                                 jnp.asarray(a[0].numpy()))))


# --- the neural-field loss and its gradients against JAX


def _problem(seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 64, 2)).astype(np.float32)
    target = rng.normal(size=(2, 64, 1)).astype(np.float32)
    mask = np.ones((2, 64), bool)
    mask[1, -14:] = False  # 50 valid nodes in the second graph
    return pos, feats, target, mask


@pytest.mark.parametrize("k_in,k_q", [(40, 40), (48, 24), (60, 60), (60, 56)],
                         ids=["same", "fewer-queries", "above-valid", "above-valid-split"])
@pytest.mark.parametrize("slot_budget", [None, 12])
def test_neural_field_loss_and_gradients_match_jax(k_in, k_q, slot_budget):
    """Loss to 1e-6 relative, each gradient tensor to 1e-4 of its own
    max-abs (both sides f32, sums in other orders), on the indices the
    port's sampler draws; with k_in == k_q the queries are the inputs."""
    jmodel, params, pmodel, _ = _jax_and_port(21, slot_budget)
    pos, feats, target, mask = _problem(k_in + k_q)
    t = torch.from_numpy
    batch = TrainBatch(t(pos), t(feats), t(target), t(mask), None, None)
    seed = 1000 + k_in
    g = torch.Generator().manual_seed(seed)
    in_idx, in_valid = sample_nodes_without_replacement(batch.node_mask, k_in, g)
    if k_in == k_q:
        q_idx, q_valid = in_idx, in_valid
    else:
        q_idx, q_valid = sample_nodes_without_replacement(batch.node_mask, k_q, g)
    if k_in > 50:
        assert not bool(in_valid[1].all())  # the second graph has only 50 valid nodes
    ji, jq = jnp.asarray(in_idx.numpy()), jnp.asarray(q_idx.numpy())
    jin_valid, jq_valid = jnp.asarray(in_valid.numpy()), jnp.asarray(q_valid.numpy())

    def jax_loss(p):
        pred = jmodel.apply(p, jax_gather_nodes(jnp.asarray(pos), ji),
                            jax_gather_nodes(jnp.asarray(feats), ji), jin_valid,
                            query_pos=jax_gather_nodes(jnp.asarray(pos), jq),
                            query_mask=jq_valid, train=True)
        return jax_masked_mse(pred, jax_gather_nodes(jnp.asarray(target), jq), jq_valid)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    want = state_dict_from_params(want_grads, jmodel.magno_config, jmodel.attn_config)
    pmodel.train()
    loss = neural_field_loss(pmodel, batch, NeuralField(k_in, k_q,
                                                        torch.Generator().manual_seed(seed)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    got = numpy_state_dict(pmodel, grads=True)
    assert set(got) == set(want)
    for key, grad in got.items():
        w = np.asarray(want[key])
        assert np.isfinite(grad).all() and np.abs(w).max() > 0, key
        np.testing.assert_allclose(grad, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=key)


def test_neural_field_sizes_are_clipped_to_the_node_count():
    """k above N takes every node once: with the queries being the inputs,
    the loss is the full-grid loss on the nodes in the sampled order."""
    _, _, pmodel, _ = _jax_and_port(22, 12)
    pos, feats, target, mask = _problem(5)
    t = torch.from_numpy
    batch = TrainBatch(t(pos), t(feats), t(target), t(mask), None, None)
    loss = neural_field_loss(pmodel.eval(), batch, NeuralField(500, 500,
                                                               torch.Generator().manual_seed(0)))
    idx, _ = sample_nodes_without_replacement(batch.node_mask, 64,
                                              torch.Generator().manual_seed(0))
    assert sorted(idx[0].tolist()) == list(range(64))
    with torch.no_grad():
        pred = pmodel(gather_nodes(batch.pos, idx), gather_nodes(batch.feats, idx),
                      torch.gather(batch.node_mask, 1, idx))
        want = ((pred - gather_nodes(batch.target, idx)) ** 2
                * torch.gather(batch.node_mask, 1, idx)[..., None]).sum() / batch.node_mask.sum()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)


# --- serving with edges built on the device


def test_device_edge_serving_answers_query_points(tmp_path):
    """`load_inference(edges="device")`: the JAX forward with query points to
    1e-5; two query sets give two answers; without queries, the input points'
    prediction."""
    jmodel, params, pmodel, (pos, feats, mask) = _jax_and_port(23, 12)
    path = os.path.join(tmp_path, "model.pt")
    export_inference(pmodel, path)
    infer = load_inference(path, device="cpu", edges="device")
    rng = np.random.default_rng(9)
    t = torch.from_numpy
    answers = []
    for _ in range(2):
        qpos = rng.uniform(-1, 1, (2, 48, 3)).astype(np.float32)
        qmask = np.ones((2, 48), bool)
        want = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                            query_pos=jnp.asarray(qpos), query_mask=jnp.asarray(qmask))
        got = infer(t(pos), t(feats), t(mask), t(qpos), t(qmask))
        assert got.shape == (2, 48, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        answers.append(got)
    assert not torch.allclose(answers[0], answers[1])
    want = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask))
    np.testing.assert_allclose(infer(t(pos), t(feats), t(mask)).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="edges must be"):
        load_inference(path, device="cpu", edges="host")


# --- the trainer


def _nf_overrides(base, **setup):
    return {"setup": {"device": "cpu", **setup},
            "dataset": {"base_path": os.path.join(str(base), "data")},
            "path": {"ckpt_path": f"{base}/c.pt", "loss_path": f"{base}/l.png",
                     "result_path": f"{base}/r.png", "database_path": f"{base}/d.csv"}}


def test_neural_field_yaml_trains_through_the_command_line(tmp_path):
    """neural_field.yaml (2 epochs, 256 of 700 nodes a graph) on the CPU:
    finite losses, precompute_edges forced off, validation (full grid, slots
    built in the forward) below 0.7, the JAX trainer's bar for this config."""
    row, trainer = cli.run_config_file(NF_CONFIG, _nf_overrides(tmp_path, test=False),
                                       return_trainer=True)
    losses = np.load(os.path.join(str(tmp_path), "l.npz"))
    assert np.isfinite(losses["train_loss"]).all() and np.isfinite(losses["val_loss"]).all()
    assert trainer.model_config.args.magno.precompute_edges is False
    assert trainer.slot_mode == "device" and trainer.neural_field.input_nodes == 256
    assert losses["val_loss"][-1] < 0.7, losses["val_loss"]
    assert float(row["training time"]) > 0


def test_command_line_device_flag_overrides_the_config(tmp_path):
    """`--device cpu` reaches every config as a setup.device override."""
    seen = []
    with mock.patch.object(cli, "run_config_file",
                           lambda path, overrides=None: seen.append((path, overrides))):
        cli.main(["--config", NF_CONFIG, "--device", "cpu"])
        cli.main(["--config", NF_CONFIG])
    assert seen == [(NF_CONFIG, {"setup": {"device": "cpu"}}), (NF_CONFIG, None)]


def test_full_grid_in_device_mode_matches_the_jax_trainer(tmp_path):
    """A config that precomputes nothing and builds nothing on the host runs
    slot mode 'device' in both trainers: the same first validation (1e-5
    relative) and test metrics (1e-4) from the JAX trainer's initial
    parameters, then one epoch of fit with finite losses; the batches carry
    no edges."""
    cfg = small_config(tmp_path, update_pt_files_with_edges=False)
    cfg["model"]["args"]["magno"].update(edge_layout="slots")
    cfg["optimizer"]["args"].update(epoch=1)
    jcfg = copy.deepcopy(cfg)
    for key in ("ckpt_path", "loss_path", "result_path", "database_path"):
        jcfg["path"][key] = jcfg["path"][key].replace("/run/", "/jax/")
    jcfg["path"]["ckpt_path"] = jcfg["path"]["ckpt_path"].replace(".pt", ".msgpack")
    jt = jax_init_trainer(jconfig.load_run_config(write_config(jcfg, tmp_path / "jax.json")))
    jval = jt.validate(jt.val_loader)
    init_ckpt = os.path.join(str(tmp_path), "init.msgpack")
    jt.save_ckpt(init_ckpt)
    pt = port_trainer(cfg, tmp_path)
    assert pt.slot_mode == "device" and pt.model_config.args.magno.precompute_edges is False
    batch = next(iter(pt.val_loader))
    assert batch.enc_slots is None and batch.dec_slots is None
    pt.load_ckpt(init_ckpt)
    np.testing.assert_allclose(pt.validate(pt.val_loader), jval, rtol=1e-5)
    jres, pres = jt.test(), pt.test()
    for key in ("MSE", "MAE", "Rel L2 Error (%)"):
        np.testing.assert_allclose(pres[key], jres[key], rtol=1e-4, err_msg=key)
    result = pt.fit()
    assert np.isfinite(result["train"]["loss"]).all() and np.isfinite(result["valid"]["loss"]).all()
