"""The port's whole serving slice against the JAX GAOT3D eval forward on CPU.

The flagship test model and problem of tests/test_degree_sections.py (fused
encoder with statistical geoembed, GNO-only fused decode head, 2 layers, a
4x4x4 latent grid) run in both packages on the same inputs, the port loading
the JAX weights through gaot3d_tpu.torch_export.state_dict_from_params with
strict=True.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.ops.grid_graph import EdgeSlots as JaxEdgeSlots
from gaot3d_tpu.ops.grid_graph import LatentGrid as JaxLatentGrid
from gaot3d_tpu.ops.grid_graph import build_edge_slots_batched, section_slots_by_degree_batched
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig,
                                     TransformerConfig, init_model)
from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots, SectionedEdgeSlots
from gaot3d_tpu_torch.serve import export_inference, load_inference, make_edge_arg_model
from gaot3d_tpu_torch.weights import load_numpy_state_dict
from test_degree_sections import _flagship_model, _problem

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _port_configs(jmodel):
    a = jmodel.attn_config
    attn = TransformerConfig(**{**a.__dict__,
                                "attn_config": AttentionConfig(**a.attn_config.__dict__),
                                "ffn_config": FFNConfig(**a.ffn_config.__dict__)})
    return MAGNOConfig(**dataclasses.asdict(jmodel.magno_config)), attn


def _with_attention_dtype(jmodel, dtype):
    a = jmodel.attn_config
    return jmodel.clone(attn_config=dataclasses.replace(
        a, attn_config=dataclasses.replace(a.attn_config, attention_dtype=dtype)))


def _pair(attention_dtype, seed=0):
    """(jax model, params, port model) sharing weights."""
    jmodel = _with_attention_dtype(_flagship_model(), attention_dtype)
    pos, feats, _, mask, lat_c, msk_c = _problem()
    base = JaxEdgeSlots(lat_idx=jnp.asarray(lat_c), mask=jnp.asarray(msk_c))
    params = jmodel.init({"params": jax.random.key(seed)}, jnp.asarray(pos),
                         jnp.asarray(feats), jnp.asarray(mask),
                         encoder_slots=[base], decoder_slots=[base])
    magno, attn = _port_configs(jmodel)
    sd = state_dict_from_params(params, jmodel.magno_config, jmodel.attn_config,
                                latent_tokens=jmodel.latent_tokens)
    pmodel = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=jmodel.latent_tokens,
                        device="cpu")
    load_numpy_state_dict(pmodel, sd)
    return jmodel, params, pmodel.eval()


def _sections(lat_c, msk_c, chunk=16):
    perms, sect = section_slots_by_degree_batched(lat_c, msk_c, chunk)
    port = SectionedEdgeSlots(tuple(
        EdgeSlots(torch.from_numpy(np.array(s.lat_idx)), torch.from_numpy(np.array(s.mask)))
        for s in sect.sections))
    return perms, sect, port


def _run_both(jmodel, params, pmodel, pos, feats, mask, jslots, pslots):
    want = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                        encoder_slots=[jslots], decoder_slots=[jslots])
    with torch.inference_mode():
        got = pmodel(torch.from_numpy(pos), torch.from_numpy(feats), torch.from_numpy(mask),
                     encoder_slots=[pslots], decoder_slots=[pslots])
    return got.numpy(), np.asarray(want)


def test_whole_slice_uniform_slots_f32_attention():
    jmodel, params, pmodel = _pair("float32")
    pos, feats, _, mask, lat_c, msk_c = _problem(seed=31)
    got, want = _run_both(jmodel, params, pmodel, pos, feats, mask,
                          JaxEdgeSlots(jnp.asarray(lat_c), jnp.asarray(msk_c)),
                          EdgeSlots.from_numpy(lat_c, msk_c))
    assert got.shape == (2, 64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_whole_slice_sectioned_slots_f32_attention():
    jmodel, params, pmodel = _pair("float32", seed=1)
    pos, feats, _, mask, lat_c, msk_c = _problem(seed=37)
    perms, jsect, psect = _sections(lat_c, msk_c)
    assert len(psect.sections) > 1
    rows = np.arange(pos.shape[0])[:, None]
    got, want = _run_both(jmodel, params, pmodel, pos[rows, perms], feats[rows, perms], mask,
                          jsect, psect)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_whole_slice_sectioned_slots_bf16_attention():
    """bf16 q/k/v: the JAX eval path at S=8 tokens is its naive attention
    (bf16 logits and bf16 softmax weights) while the port runs K1's math
    (f32 logits from a prescaled bf16 q), so the two differ by bf16 rounding
    (2^-8 relative) inside attention; the bound is bf16-grade."""
    jmodel, params, pmodel = _pair("bfloat16", seed=2)
    pos, feats, _, mask, lat_c, msk_c = _problem(seed=41)
    perms, jsect, psect = _sections(lat_c, msk_c)
    rows = np.arange(pos.shape[0])[:, None]
    got, want = _run_both(jmodel, params, pmodel, pos[rows, perms], feats[rows, perms], mask,
                          jsect, psect)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3)


def test_whole_slice_slot_budget_compacts_wide_slots():
    """Uniform stencil-window slots (K=64) with slot_budget set: both models
    compact them in the forward (valid slots first, window order kept)."""
    pos, feats, _, mask, lat_c, msk_c = _problem(seed=59)
    budget = lat_c.shape[-1]
    jmodel = _with_attention_dtype(_flagship_model(slot_budget=budget), "float32")
    wide = build_edge_slots_batched(jnp.asarray(pos), JaxLatentGrid(dims=(4, 4, 4)), 0.45,
                                    k_neighbors=1,
                                    strategy="bidirectional", point_mask=jnp.asarray(mask))
    assert wide.lat_idx.shape[-1] > budget
    params = jmodel.init({"params": jax.random.key(7)}, jnp.asarray(pos), jnp.asarray(feats),
                         jnp.asarray(mask), encoder_slots=[wide], decoder_slots=[wide])
    magno, attn = _port_configs(jmodel)
    pmodel = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=jmodel.latent_tokens,
                        device="cpu")
    load_numpy_state_dict(pmodel, state_dict_from_params(params, jmodel.magno_config,
                                                         jmodel.attn_config))
    got, want = _run_both(jmodel, params, pmodel.eval(), pos, feats, mask, wide,
                          EdgeSlots.from_numpy(np.array(wide.lat_idx), np.array(wide.mask)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sectioned_output_comes_back_in_permuted_order():
    """Sectioned slots on degree-permuted inputs give the uniform-slot
    prediction on the original inputs, permuted the same way."""
    _, _, pmodel = _pair("float32", seed=3)
    pos, feats, _, mask, lat_c, msk_c = _problem(seed=43)
    perms, _, psect = _sections(lat_c, msk_c)
    rows = np.arange(pos.shape[0])[:, None]
    infer = make_edge_arg_model(pmodel)
    t = torch.from_numpy
    uni = EdgeSlots.from_numpy(lat_c, msk_c)
    out_u = infer(t(pos), t(feats), t(mask), uni, uni)
    out_s = infer(t(pos[rows, perms]), t(feats[rows, perms]), t(mask), psect, psect)
    assert not torch.allclose(out_s, out_u, atol=1e-3)  # the order really differs
    np.testing.assert_allclose(out_s.numpy()[rows, np.argsort(perms, axis=1)], out_u.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_export_load_roundtrip(tmp_path):
    _, _, pmodel = _pair("bfloat16", seed=4)
    pos, feats, _, mask, lat_c, msk_c = _problem(seed=47)
    perms, _, psect = _sections(lat_c, msk_c)
    rows = np.arange(pos.shape[0])[:, None]
    args = (torch.from_numpy(pos[rows, perms]), torch.from_numpy(feats[rows, perms]),
            torch.from_numpy(mask), psect, psect)
    want = make_edge_arg_model(pmodel)(*args)
    path = os.path.join(tmp_path, "model.pt")
    export_inference(pmodel, path)
    got = load_inference(path, device="cpu")(*args)
    assert torch.equal(got, want)


def test_load_is_strict_and_checks_latent_tokens():
    jmodel, params, pmodel = _pair("float32", seed=5)
    sd = state_dict_from_params(params, jmodel.magno_config, jmodel.attn_config,
                                latent_tokens=jmodel.latent_tokens)
    missing = dict(sd)
    missing.pop("patch_linear.bias")
    with pytest.raises(RuntimeError, match="patch_linear.bias"):
        load_numpy_state_dict(pmodel, missing)
    wrong = dict(sd, latent_tokens=sd["latent_tokens"] * 2)
    with pytest.raises(ValueError, match="latent_tokens"):
        load_numpy_state_dict(pmodel, wrong)


def test_init_model_is_seeded_by_its_generator():
    magno, attn = _port_configs(_flagship_model())

    def weights(seed):
        m = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4),
                       generator=torch.Generator().manual_seed(seed), device="cpu")
        return torch.cat([p.detach().flatten() for p in m.parameters()])

    a, b, c = weights(0), weights(0), weights(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    bound = 1 / 6 ** 0.5  # the kernel MLP's first layer has fan_in 6
    m = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    w = m.encoder.gno.channel_mlp.fcs[0].weight
    assert w.abs().max() <= bound and w.abs().max() > 0.8 * bound


@pytest.mark.parametrize("magno_kw,attn_kw,match,error", [
    (dict(kernel_dtype="float16"), {}, "kernel_dtype", ValueError),  # float32 | bfloat16 run
    (dict(gno_coord_dim=2), {}, "gno_coord_dim", NotImplementedError),
], ids=["magno_kw0-attn_kw0-kernel_dtype", "gno_coord_dim"])
def test_unsupported_configs_raise(magno_kw, attn_kw, match, error):
    """Values the port does not run raise NotImplementedError, unknown ones
    ValueError. The MAGNO variants run (tests/test_torch_port_variants*.py),
    the processor's conditional norm and rope3d too
    (tests/test_torch_port_processor_variants.py); gno_coord_dim 2 runs in
    neither package."""
    magno, attn = _port_configs(_flagship_model())
    magno = dataclasses.replace(magno, **magno_kw)
    attn = dataclasses.replace(attn, **attn_kw)
    with pytest.raises(error, match=match):
        init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4), device="cpu")


def test_unsupported_inputs_raise():
    _, _, pmodel = _pair("float32", seed=6)
    pos, feats, _, mask, lat_c, msk_c = _problem(seed=53)
    t = torch.from_numpy
    bad = lat_c.copy()
    bad[msk_c] = 64  # a valid slot outside the 4x4x4 grid
    slots = EdgeSlots.from_numpy(bad, msk_c)
    with pytest.raises(ValueError, match="outside the latent grid"):
        pmodel(t(pos), t(feats), t(mask), encoder_slots=[slots], decoder_slots=[slots])
    with pytest.raises(ValueError, match="dropout needs a seed"):
        # a training forward with dropout and no generator to seed it
        uni = EdgeSlots.from_numpy(lat_c, msk_c)
        _, _, drop = _pair("float32", seed=6)
        for m in drop.modules():
            if hasattr(m, "atten_dropout"):
                m.atten_dropout = 0.1
        drop.train()(t(pos), t(feats), t(mask), encoder_slots=[uni], decoder_slots=[uni])


def test_entry_points_default_to_the_card(tmp_path):
    """`init_model` and `load_inference` run on the card unless the caller
    asks for the CPU; without a card they raise, they do not fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults work")
    magno, attn = _port_configs(_flagship_model())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4))
    _, _, pmodel = _pair("float32", seed=8)
    path = os.path.join(tmp_path, "model.pt")
    export_inference(pmodel, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_inference(path)
