"""The port's train step against the JAX train step on CPU: schedules and
optimizers against `gaot3d_tpu.train.schedule`, loss and every gradient
against `jax.grad` of `masked_mse`, three AdamW steps against optax, and the
seeding of attention dropout.

The flagship test model of tests/test_degree_sections.py (fused encoder with
statistical geoembed, GNO-only fused decode head, 2 layers, a 4x4x4 latent
grid) runs in both packages on the same weights and inputs, f32 attention,
dropout rate 0 (the two packages draw different dropout masks by design; the
mask itself is tested through explicit bits in test_torch_port_kernels.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaot3d_tpu.ops.grid_graph import EdgeSlots as JaxEdgeSlots
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu.train import schedule as jsched
from gaot3d_tpu.train.trainer import masked_mse as jax_masked_mse
from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots
from gaot3d_tpu_torch.train import (OptimizerargsConfig, TrainBatch, eval_step,
                                    make_lr_schedule, make_optimizer, masked_mse,
                                    mix_phase_lengths, train_step)
from gaot3d_tpu_torch.weights import numpy_state_dict
from test_degree_sections import _problem
from test_torch_port_model import _pair, _sections
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("total,frac", [(100, 0.96), (100, 0.90), (20, 0.96), (20, 0.90),
                                        (3, 0.90), (1, 0.96)])
def test_mix_phase_lengths_match(total, frac):
    assert mix_phase_lengths(total, frac) == jsched.mix_phase_lengths(total, frac)


@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("scheduler", ["mix", "step", "cos", "exp", "none"])
def test_schedule_values_match_over_all_epochs(name, scheduler):
    """Every step of every epoch, 1e-6 relative: both sides compute in f32 in
    the same order, so they differ by a few ulps of cos and pow at most."""
    kw = dict(scheduler=scheduler, epoch=50, scheduler_step_size=7, scheduler_T_max=50)
    frac = 0.96 if name == "adam" else 0.90
    want = jsched.make_lr_schedule(jsched.OptimizerargsConfig(**kw), 3, frac)
    model = torch.nn.Linear(2, 2)
    opt = make_optimizer(name, model.parameters(), OptimizerargsConfig(**kw), 3)
    direct = make_lr_schedule(OptimizerargsConfig(**kw), 3, frac)
    for step in range(50 * 3):
        assert opt.schedule(step) == direct(step)
        np.testing.assert_allclose(opt.schedule(step), float(want(step)), rtol=1e-6, atol=0)


def test_optimizer_reads_the_schedule_before_the_update():
    """optax applies schedule(count) and then counts, so step 0 runs at
    config.lr; the rate of the wrapped optimizer follows."""
    model = torch.nn.Linear(2, 2)
    cfg = OptimizerargsConfig(scheduler="mix", epoch=100)
    opt = make_optimizer("adamw", model.parameters(), cfg, steps_per_epoch=1)
    assert isinstance(opt.optimizer, torch.optim.AdamW)
    assert opt.optimizer.defaults["weight_decay"] == cfg.weight_decay
    model(torch.ones(1, 2)).sum().backward()
    assert opt.learning_rate == pytest.approx(cfg.lr)
    opt.step()
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(cfg.lr)
    opt.step()  # epoch 1 of a 2-epoch warm-up: already max_lr
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(cfg.max_lr)
    assert opt.count == 2
    with pytest.raises(ValueError, match="unsupported optimizer"):
        make_optimizer("sgd", model.parameters(), cfg, 1)


def test_masked_mse_matches():
    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(2, 9, 3)).astype(np.float32) for _ in range(2))
    mask = rng.random((2, 9)) < 0.6
    want = jax_masked_mse(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    t = torch.from_numpy
    np.testing.assert_allclose(masked_mse(t(pred), t(target), t(mask)).item(), float(want),
                               rtol=1e-6)
    none = masked_mse(t(pred), t(target), torch.zeros(2, 9, dtype=torch.bool))
    assert none.item() == 0.0  # the denominator is clamped to 1


def _jax_loss(jmodel, pos, feats, target, mask, jslots):
    def loss(params):
        pred = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                            train=True, encoder_slots=[jslots], decoder_slots=[jslots])
        return jax_masked_mse(pred, jnp.asarray(target), jnp.asarray(mask))
    return loss


def _setup(layout, seed):
    """(jax model, params, port model, jax loss fn, port batch) on one problem
    with uniform or degree-sectioned slots."""
    jmodel, params, pmodel = _pair("float32", seed=seed)
    pos, feats, target, mask, lat_c, msk_c = _problem(seed=61 + seed)
    mask[1, -5:] = False  # some padded nodes, so that the mask matters
    if layout == "sectioned":
        perms, jslots, pslots = _sections(lat_c, msk_c)
        assert len(pslots.sections) > 1
        rows = np.arange(pos.shape[0])[:, None]
        pos, feats, target, mask = (x[rows, perms] for x in (pos, feats, target, mask))
    else:
        jslots = JaxEdgeSlots(jnp.asarray(lat_c), jnp.asarray(msk_c))
        pslots = EdgeSlots.from_numpy(lat_c, msk_c)
    t = torch.from_numpy
    batch = TrainBatch(t(pos), t(feats), t(target), t(mask), pslots, pslots)
    return jmodel, params, pmodel, _jax_loss(jmodel, pos, feats, target, mask, jslots), batch


def _export(jmodel, tree):
    return state_dict_from_params(tree, jmodel.magno_config, jmodel.attn_config)


@pytest.mark.parametrize("layout", ["uniform", "sectioned"])
def test_loss_and_every_gradient_match_jax_grad(layout):
    """Loss to 1e-6 relative. Each gradient tensor to 1e-4 of its own
    max-abs: both sides are f32, sums run in different orders."""
    jmodel, params, pmodel, loss_fn, batch = _setup(layout, seed=0)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    want = _export(jmodel, want_grads)
    pmodel.train()
    pred = pmodel(batch.pos, batch.feats, batch.node_mask, encoder_slots=[batch.enc_slots],
                  decoder_slots=[batch.dec_slots])
    loss = masked_mse(pred, batch.target, batch.node_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    got = numpy_state_dict(pmodel, grads=True)
    assert set(got) == set(want)
    for key, g in got.items():
        w = np.asarray(want[key])
        assert np.isfinite(g).all() and np.abs(w).max() > 0, key
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_three_optimizer_steps_match_optax(name):
    """Three train steps, loss_scale 2, against optax on the JAX model.

    Adam's first update is lr * g / (|g| + eps): an entry whose gradient is
    near eps = 1e-8 moves by anything between 0 and lr depending on rounding
    noise in g. So the parameters are compared with an ABSOLUTE bound of 2%
    of the learning rate per step (no entry is left out), the losses and
    gradient norms to 1e-5 relative."""
    jmodel, params, pmodel, loss_fn, batch = _setup("sectioned", seed=1)
    cfg = dict(lr=1e-3, weight_decay=1e-2, epoch=4, scheduler="mix", loss_scale=2.0)
    tx = jsched.make_optimizer(name, jsched.OptimizerargsConfig(**cfg), steps_per_epoch=1)
    opt_state = tx.init(params)
    opt = make_optimizer(name, pmodel.parameters(), OptimizerargsConfig(**cfg), 1)
    lrs = []
    for step in range(3):
        loss_j, grads = jax.value_and_grad(lambda p: 2.0 * loss_fn(p))(params)
        norm_j = optax.global_norm(grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        lrs.append(opt.learning_rate)
        loss, norm = train_step(pmodel, opt, batch, None)  # the scale comes from cfg
        np.testing.assert_allclose(loss.item(), float(loss_j) / 2.0, rtol=1e-5)
        np.testing.assert_allclose(norm.item(), float(norm_j), rtol=1e-5)
    assert lrs[0] == pytest.approx(1e-3) and lrs[1] > lrs[0]  # the warm-up is under way
    want = _export(jmodel, params)
    got = numpy_state_dict(pmodel)
    bound = 0.02 * sum(lrs)
    for key, p in got.items():
        np.testing.assert_allclose(p, np.asarray(want[key]), rtol=0, atol=bound, err_msg=key)
    pred, val = eval_step(pmodel, batch)
    assert pred.shape == batch.target.shape and not pmodel.training
    assert torch.isfinite(val)


def test_empty_latent_cells_give_finite_gradients():
    """Cells with no point (count 0) and with one point have an isotropic
    regularised covariance, where the closed-form eigenvalues have an
    infinite derivative. The accumulator's cotangent must stay finite, with
    zeros in the moment columns, and so must every parameter gradient."""
    from gaot3d_tpu_torch.models import fused_encoder

    _, _, pmodel = _pair("float32", seed=2)
    pos, feats, target, mask, lat_c, msk_c = _problem(seed=67)
    lat_c = lat_c % 24          # cells 24..63 stay empty
    lat_c[:, :8, 0] = 30 + np.arange(8)  # cells with exactly one point each
    msk_c[:, :8, 0], msk_c[:, :8, 1:] = True, False
    slots = EdgeSlots.from_numpy(lat_c, msk_c)
    seen = []
    finalize = fused_encoder.FusedEncoderScale._finalize

    def spy(self, acc):
        acc.register_hook(lambda g: seen.append(g.clone()))
        return finalize(self, acc)

    t = torch.from_numpy
    pmodel.train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_encoder.FusedEncoderScale, "_finalize", spy)
        pred = pmodel(t(pos), t(feats), t(mask), encoder_slots=[slots], decoder_slots=[slots])
        masked_mse(pred, t(target), t(mask)).backward()
    (g,) = seen
    C = pmodel.magno_config.lifting_channels
    assert torch.isfinite(g).all() and g[..., :C].abs().max() > 0
    assert not g[..., C:].any()
    for name, p in pmodel.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def _dropout_pair(seed):
    jmodel, params, pmodel = _pair("float32", seed=seed)
    for m in pmodel.modules():
        if hasattr(m, "atten_dropout"):
            m.atten_dropout = 0.5
    pos, feats, target, mask, lat_c, msk_c = _problem(seed=71)
    slots = EdgeSlots.from_numpy(lat_c, msk_c)
    t = torch.from_numpy
    return pmodel, TrainBatch(t(pos), t(feats), t(target), t(mask), slots, slots)


def test_dropout_seeds_come_from_the_generator_only():
    """One seed per attention layer and call, drawn in layer order from the
    generator handed in: the same generator state gives the same loss, a
    different one or a second call gives another, and nothing reads the
    global generator."""
    pmodel, batch = _dropout_pair(seed=3)
    pmodel.train()

    def loss(gen_seed):
        torch.manual_seed(gen_seed * 977)  # the global state must not matter
        gen = torch.Generator().manual_seed(gen_seed)
        first = masked_mse(pmodel(batch.pos, batch.feats, batch.node_mask,
                                  encoder_slots=[batch.enc_slots],
                                  decoder_slots=[batch.dec_slots], generator=gen),
                           batch.target, batch.node_mask).item()
        second = masked_mse(pmodel(batch.pos, batch.feats, batch.node_mask,
                                   encoder_slots=[batch.enc_slots],
                                   decoder_slots=[batch.dec_slots], generator=gen),
                            batch.target, batch.node_mask).item()
        return first, second

    a, b, c = loss(1), loss(1), loss(2)
    assert a == b and a[0] != a[1] and a[0] != c[0]
    seeds = pmodel.processor.layer_seeds(torch.Generator().manual_seed(1))
    assert len(seeds) == 2 and len(set(seeds)) == 2 and all(0 <= s < 2 ** 63 for s in seeds)
    assert pmodel.processor.layer_seeds(None) == [None, None]
    pmodel.eval()  # no dropout in eval: no generator needed, and none consumed
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    out = pmodel(batch.pos, batch.feats, batch.node_mask, encoder_slots=[batch.enc_slots],
                 decoder_slots=[batch.dec_slots])
    assert torch.isfinite(out).all() and torch.equal(gen.get_state(), state)


def test_train_step_with_dropout_runs_and_checks_devices():
    pmodel, batch = _dropout_pair(seed=4)
    opt = make_optimizer("adamw", pmodel.parameters(), OptimizerargsConfig(), 2)
    before = [p.detach().clone() for p in pmodel.parameters()]
    loss, norm = train_step(pmodel, opt, batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and norm > 0 and pmodel.training and opt.count == 1
    assert all(not torch.equal(p, b) for p, b in zip(pmodel.parameters(), before))
    with pytest.raises(ValueError, match="dropout needs a seed"):
        train_step(pmodel, opt, batch, None)
    meta = dataclasses.replace(batch, pos=batch.pos.to("meta"))
    with pytest.raises(ValueError, match="the batch is on"):
        train_step(pmodel, opt, meta, torch.Generator().manual_seed(0))
