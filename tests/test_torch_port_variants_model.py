"""The port's GAOT3D with every MAGNO variant against the JAX model on the CPU.

The model and problem of tests/test_degree_sections.py (`_flagship_model`,
`_problem`: 2 layers, a 4x4x4 grid, 64 points a sample) with one change of
its MAGNO config a case: the unfused encoder and decoder ('sort' and
'scatter'), nonlinear transforms with cosine attention, dot-product
attention, the PointNet geoembed (max and mean pooling), the decoder's
statistical geoembed (FusedDecoderScale), two scales with scale weights,
'ratio' and 'max_neighbors' sampling and the radius cap, and `use_gno:
false`. Both models build their slots in the forward; the port loads the JAX
weights through gaot3d_tpu.torch_export.state_dict_from_params with
strict=True. Then a train step's loss and gradients (the sampling steps on
JAX's own draws) and a multiscale model served both ways. The trainer on a
multiscale variant config is tests/test_torch_port_variants_trainer.py.

Attention runs in f32 in both. Limits, relative to the size of the
reference: eval forward 1e-5 relative L2, loss 1e-5, each gradient 1e-4
relative L2.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.models import magno as jmagno
from gaot3d_tpu.ops.grid_graph import LatentGrid as JaxLatentGrid
from gaot3d_tpu.ops.grid_graph import build_edge_slots_batched
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu_torch.models import init_model
from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots
from gaot3d_tpu_torch.serve import export_inference, load_inference, make_edge_arg_model
from gaot3d_tpu_torch.train.step import masked_mse
from gaot3d_tpu_torch.weights import load_numpy_state_dict, numpy_state_dict
from test_degree_sections import _flagship_model, _problem
from test_torch_port_model import _port_configs, _with_attention_dtype
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False

VARIANTS = {
    "a unfused sort": dict(fused_encoder=False, fused_decoder=False, use_geoembed=[True, True],
                           segment_impl="sort"),
    "a unfused scatter": dict(fused_encoder=False, fused_decoder=False,
                              use_geoembed=[True, True], segment_impl="scatter"),
    "b nonlinear cosine": dict(in_gno_transform_type="nonlinear",
                               out_gno_transform_type="nonlinear_kernelonly", use_attn=True,
                               attention_type="cosine"),
    "c dot product": dict(use_attn=True, attention_type="dot_product"),
    "d pointnet max": dict(embedding_method="pointnet", use_geoembed=[True, True],
                           pooling="max"),
    "d pointnet mean": dict(embedding_method="pointnet", use_geoembed=[True, True],
                            pooling="mean"),
    "e decoder geoembed": dict(use_geoembed=[True, True]),
    "f multiscale": dict(scales=[1.0, 2.0], use_scale_weights=True),
    "g ratio": dict(sampling_strategy="ratio", sample_ratio=0.5),
    "g max_neighbors": dict(sampling_strategy="max_neighbors", max_neighbors=3),
    "g radius cap": dict(max_radius_neighbors=4),
    "h no gno": dict(use_gno=False),
    "fused nonlinear": dict(in_gno_transform_type="nonlinear_kernelonly",
                            out_gno_transform_type="nonlinear", use_geoembed=[True, True]),
}
FWD, LOSS, GRAD = 1e-5, 1e-5, 1e-4


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _pair(variant, seed=0):
    """(jax model, params, port model) sharing weights, f32 attention; slots
    built in the forward."""
    jmodel = _with_attention_dtype(_flagship_model(**VARIANTS[variant]), "float32")
    pos, feats, _, mask, _, _ = _problem()
    params = jmodel.init({"params": jax.random.key(seed)}, jnp.asarray(pos),
                         jnp.asarray(feats), jnp.asarray(mask))
    magno, attn = _port_configs(jmodel)
    pmodel = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=jmodel.latent_tokens,
                        device="cpu")
    load_numpy_state_dict(pmodel, state_dict_from_params(
        params, jmodel.magno_config, jmodel.attn_config, latent_tokens=jmodel.latent_tokens))
    return jmodel, params, pmodel


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_forward_matches_jax(variant):
    jmodel, params, pmodel = _pair(variant)
    pos, feats, _, mask, _, _ = _problem(seed=61)
    mask = mask.copy()
    mask[1, -6:] = False  # padding rows: no edges, left out of the geoembed's statistics
    want = np.asarray(jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats),
                                   jnp.asarray(mask)))
    with torch.inference_mode():
        got = pmodel.eval()(torch.from_numpy(pos), torch.from_numpy(feats),
                            torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 64, 1) and np.isfinite(got).all()
    assert rel(got, want) <= FWD, rel(got, want)


def _record_jax_draws(monkeypatch):
    """Wrap the JAX model's edge sampling to record the draws it makes, in
    call order: 'ratio' keep masks, 'max_neighbors' priority keys."""
    draws = []
    orig = jmagno.apply_edge_sampling

    def recording(slots, cfg, direction, train, rng, num_latent):
        if train and rng is not None and cfg.sampling_strategy == "ratio":
            keep = 1.0 - (1.0 - cfg.sample_ratio)  # dropout_edges' p = 1 - rate
            draws.append(np.asarray(jax.random.bernoulli(rng, keep, slots.mask.shape)))
        elif train and rng is not None and cfg.sampling_strategy == "max_neighbors":
            B = slots.mask.shape[0]
            if direction == "encoder":  # one key a sample, as its vmap splits them
                draws.append(np.stack([np.asarray(jax.random.uniform(
                    r, (slots.mask[0].size,))) for r in jax.random.split(rng, B)]))
            else:
                draws.append(np.asarray(jax.random.uniform(rng, slots.mask.shape)))
        return orig(slots, cfg, direction, train, rng, num_latent)

    monkeypatch.setattr(jmagno, "apply_edge_sampling", recording)
    return draws


def _grad_rel(pg, jg, name):
    if name.endswith("key_proj.bias"):
        # the softmax cancels q . k_b: 0 up to rounding, held against the key weights
        scale = np.linalg.norm(jg[name.replace("bias", "weight")])
        return max(np.linalg.norm(pg[name]), np.linalg.norm(jg[name])) / scale
    return rel(pg[name], jg[name])


@pytest.mark.parametrize("variant", ["f multiscale", "b nonlinear cosine", "c dot product",
                                     "d pointnet max", "g ratio", "g max_neighbors"])
def test_train_step_loss_and_gradients_match_jax(variant, monkeypatch):
    """A training forward (edge sampling on: the JAX model draws from its
    'edges' stream, the port takes those draws), masked MSE and its
    gradients."""
    jmodel, params, pmodel = _pair(variant, seed=3)
    pos, feats, target, mask, _, _ = _problem(seed=67)
    draws = _record_jax_draws(monkeypatch)

    def loss_fn(p):
        pred = jmodel.apply(p, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                            train=True, rngs={"edges": jax.random.key(9)})
        diff = (pred - jnp.asarray(target)) * jnp.asarray(mask)[..., None]
        return (diff * diff).sum() / (mask.sum() * pred.shape[-1])

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    sampling = variant.startswith("g ")
    assert len(draws) == (2 if sampling else 0)  # the encoder's, the decoder's
    jg = state_dict_from_params({"params": jgrads["params"]}, jmodel.magno_config,
                                jmodel.attn_config)
    pmodel.train()
    t = torch.from_numpy
    pred = pmodel(t(pos), t(feats), t(mask),
                  edge_draws=[t(np.array(d)) for d in draws] if sampling else None)
    loss = masked_mse(pred, t(target), t(mask))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS * abs(float(jloss))
    pg = numpy_state_dict(pmodel, grads=True)
    assert set(pg) == set(jg)
    worst = max((_grad_rel(pg, jg, k), k) for k in pg)
    assert worst[0] <= GRAD, worst


def test_training_forward_draws_from_its_generator():
    """'ratio' and 'max_neighbors' in training: the same generator seed gives
    the same forward, another seed another; without a generator (or draws)
    the forward refuses; in eval, 'ratio' keeps every edge."""
    for variant in ("g ratio", "g max_neighbors"):
        _, _, pmodel = _pair(variant, seed=5)
        pos, feats, _, mask, _, _ = _problem(seed=71)
        t = torch.from_numpy
        pmodel.train()
        with torch.no_grad():
            runs = [pmodel(t(pos), t(feats), t(mask),
                           generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
            assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
            with pytest.raises(ValueError, match="needs a generator"):
                pmodel(t(pos), t(feats), t(mask))
            pmodel.eval()
            plain = pmodel(t(pos), t(feats), t(mask))
            assert not torch.equal(plain, runs[0])


def _scale_slots(pos, mask, scales=(1.0, 2.0)):
    grid = JaxLatentGrid(dims=(4, 4, 4))
    return [build_edge_slots_batched(jnp.asarray(pos), grid, 0.45 * s, k_neighbors=1,
                                     strategy="bidirectional", point_mask=jnp.asarray(mask))
            for s in scales]


def test_multiscale_model_serves_with_call_time_and_device_edges(tmp_path):
    jmodel, params, pmodel = _pair("f multiscale", seed=7)
    pos, feats, _, mask, _, _ = _problem(seed=73)
    jslots = _scale_slots(pos, mask)
    want = np.asarray(jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats),
                                   jnp.asarray(mask), encoder_slots=jslots,
                                   decoder_slots=jslots))
    t = torch.from_numpy
    pslots = [EdgeSlots.from_numpy(np.array(s.lat_idx), np.array(s.mask)) for s in jslots]
    infer = make_edge_arg_model(pmodel.eval())
    got = infer(t(pos), t(feats), t(mask), *pslots, *pslots).numpy()
    assert rel(got, want) <= 1e-4
    with pytest.raises(ValueError, match="expected 4 edge structures"):
        infer(t(pos), t(feats), t(mask), pslots[0], pslots[0])
    path = os.path.join(tmp_path, "multiscale.pt")
    export_inference(pmodel, path, edges="device")
    built = load_inference(path, device="cpu")(t(pos), t(feats), t(mask)).numpy()
    np.testing.assert_allclose(built, got, rtol=1e-6, atol=1e-6)
    args_path = os.path.join(tmp_path, "multiscale_args.pt")
    export_inference(pmodel, args_path)
    again = load_inference(args_path, device="cpu")(t(pos), t(feats), t(mask), *pslots, *pslots)
    assert torch.equal(again, t(got))


def test_reference_state_dict_drops_the_dead_recovery_without_gno():
    """The reference builds encoder.recovery whenever its geoembed is on and
    applies it only with use_gno; a reference checkpoint of a use_gno: false
    model loads with that key dropped, as gaot3d_tpu/torch_import.py drops it."""
    from gaot3d_tpu_torch.weights import state_dict_from_reference

    jmodel, params, pmodel = _pair("h no gno", seed=9)
    sd = state_dict_from_params(params, jmodel.magno_config, jmodel.attn_config)
    assert not any(k.startswith("encoder.recovery") for k in sd)
    ref = dict(sd, **{"encoder.recovery.fcs.0.weight": np.zeros((8, 16, 1), np.float32),
                      "encoder.recovery.fcs.0.bias": np.zeros(8, np.float32)})
    out = state_dict_from_reference(ref, pmodel)
    assert set(out) == set(sd)
