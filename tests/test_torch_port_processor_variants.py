"""The processor's variants in the port against the JAX package on CPU:
`ConditionedNorm` and `AugmentedMLP`, the axial 'rope3d', the conditioned
attention, FFN, block and U-ViT processor, and the whole conditioned rope3d
model, forward and a train step with attention dropout; the conditioned
weights carried across (flax tree, msgpack checkpoint, reference tools).

The model is small: an 8x8x4 latent grid, patch 2 (32 tokens), 3 blocks
(one a middle block) of 2 heads of dim 16, so rope3d rotates 3 slices of 4
dims and leaves 4. Attention runs in f32. Dropout matches through explicit
bits: JAX's Pallas kernel in interpret mode and the port's plain versions
take the same uint32 bits, one set a layer. Tolerances are relative to the
size of each reference: 1e-5 of its max-abs for the modules (f32, sums in
other orders), 1e-4 for the model's output and each gradient tensor.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import gaot3d_tpu.models.transformer as jtransformer
from gaot3d_tpu.models import init_model as jax_init_model
from gaot3d_tpu.models.magno import MAGNOConfig as JaxMAGNOConfig
from gaot3d_tpu.models.mlp import AugmentedMLP as JaxAugmentedMLP
from gaot3d_tpu.models.mlp import ConditionedNorm as JaxConditionedNorm
from gaot3d_tpu.ops.grid_graph import EdgeSlots as JaxEdgeSlots
from gaot3d_tpu.ops.grid_graph import LatentGrid as JaxLatentGrid
from gaot3d_tpu.ops.grid_graph import build_edge_slots_batched
from gaot3d_tpu.ops.pallas_attention import flash_attention_dropout
from gaot3d_tpu.ops.rope import apply_rope as jax_apply_rope
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu.train.checkpoint import load_params_only
from gaot3d_tpu.train.trainer import masked_mse as jax_masked_mse
import gaot3d_tpu_torch.models.transformer as ptransformer
from gaot3d_tpu_torch.kernels.dropout_bits import blocked_to_rowmajor
from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig, TransformerConfig,
                                     init_model)
from gaot3d_tpu_torch.models.mlp import AugmentedMLP, ConditionedNorm
from gaot3d_tpu_torch.ops.attention import scaled_dot_product_attention
from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots
from gaot3d_tpu_torch.ops.rope import apply_rope
from gaot3d_tpu_torch.train.checkpoint import load_msgpack_params, save_msgpack_params
from gaot3d_tpu_torch.train.step import masked_mse
from gaot3d_tpu_torch.weights import (COND_NORM_KEY, conditioned_norm_state_dict,
                                      load_numpy_state_dict, numpy_state_dict,
                                      reference_state_dict, state_dict_from_reference)
from test_degree_sections import compact_slots_np
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False

LATENT = (8, 8, 4)
RADIUS = 0.35
N_POINTS = 96
HEADS, HIDDEN = 2, 32


def configs(positional_embedding="rope3d", cond=True, rate=0.0, layers=3):
    """(JAX MAGNOConfig, JAX TransformerConfig) of the small model."""
    magno = JaxMAGNOConfig(
        lifting_channels=8, use_geoembed=[True, False], gno_radius=RADIUS,
        neighbor_strategy="bidirectional", in_gno_channel_mlp_hidden_layers=[16, 16],
        out_gno_channel_mlp_hidden_layers=[16], projection_channels=16, edge_chunk_size=32)
    attn = jtransformer.TransformerConfig(
        patch_size=2, hidden_size=HIDDEN, num_layers=layers,
        positional_embedding=positional_embedding,
        attn_config=jtransformer.AttentionConfig(
            hidden_size=HIDDEN, num_heads=HEADS, num_kv_heads=HEADS, atten_dropout=rate,
            use_conditional_norm=cond, attention_dtype="float32"),
        ffn_config=jtransformer.FFNConfig(hidden_size=64, use_conditional_norm=cond))
    return magno, attn


def port_configs(magno, attn):
    a = attn
    pattn = TransformerConfig(**{**a.__dict__,
                                 "attn_config": AttentionConfig(**a.attn_config.__dict__),
                                 "ffn_config": FFNConfig(**a.ffn_config.__dict__)})
    return MAGNOConfig(**dataclasses.asdict(magno)), pattn


def problem(seed, B=2, N=N_POINTS, pad=0):
    """pos, feats, target, mask ([B, N] with `pad` invalid rows at the end of
    sample 1) and budget-compacted uniform slots (lat, msk) [B, N, K]."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, 2)).astype(np.float32)
    target = rng.normal(size=(B, N, 1)).astype(np.float32)
    mask = np.ones((B, N), bool)
    if pad:
        mask[1, N - pad:] = False
    wide = build_edge_slots_batched(jnp.asarray(pos), JaxLatentGrid(dims=LATENT), RADIUS,
                                    k_neighbors=1, strategy="bidirectional",
                                    point_mask=jnp.asarray(mask))
    lat_np, msk_np = np.asarray(wide.lat_idx), np.asarray(wide.mask)
    budget = int(msk_np.sum(axis=2).max())
    lat = np.empty((B, N, budget), np.int32)
    msk = np.empty((B, N, budget), bool)
    for b in range(B):
        lat[b], msk[b] = compact_slots_np(lat_np[b], msk_np[b], budget)
    return pos, feats, target, mask, lat, msk


def condition(B=2):
    return np.asarray([[0.7], [-0.4], [1.3], [0.2]][:B], np.float32)


def port_state(params, magno, attn):
    """The port's state dict of a JAX param tree: `state_dict_from_params`
    with the ConditionedNorm weights merged in."""
    sd = state_dict_from_params(params, magno, attn)
    sd.update(conditioned_norm_state_dict(params, attn.num_layers))
    return sd


def model_pair(magno, attn, seed=0, prob=None):
    """(jax model, params, port model) sharing weights, initialised on the
    problem's slots."""
    pos, feats, _, mask, lat, msk = prob if prob is not None else problem(5)
    jmodel = jax_init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=LATENT)
    jslots = JaxEdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    cond = condition(pos.shape[0]) if attn.attn_config.use_conditional_norm else None
    params = jmodel.init({"params": jax.random.key(seed)}, jnp.asarray(pos), jnp.asarray(feats),
                         jnp.asarray(mask), encoder_slots=[jslots], decoder_slots=[jslots],
                         condition=None if cond is None else jnp.asarray(cond))
    pmagno, pattn = port_configs(magno, attn)
    pmodel = init_model(2, 1, "gaot_3d", pmagno, pattn, latent_tokens=LATENT, device="cpu")
    load_numpy_state_dict(pmodel, port_state(params, magno, attn))
    return jmodel, params, pmodel


def dense_bits(seed, layers, B, S):
    """One uint32 bits set a layer: the JAX layout [B*H, 1, 1, S, S] and the
    port's row-major [B*H, S, S]."""
    rng = np.random.default_rng(seed)
    blocked = [rng.integers(0, 2 ** 32, size=(B * HEADS, 1, 1, S, S), dtype=np.uint32)
               for _ in range(layers)]
    return blocked, [blocked_to_rowmajor(torch.from_numpy(b), S, S) for b in blocked]


def patch_jax_attention(monkeypatch, blocked):
    """JAX attention through the Pallas kernel in interpret mode on the given
    bits, one set a layer in call order."""
    calls = iter(range(10 ** 6))

    def attention(q, k, v, dropout_rate=0.0, rng=None, impl=None, chunk_size=None):
        bits = jnp.asarray(blocked[next(calls) % len(blocked)]) if dropout_rate > 0 else None
        S = q.shape[2]
        return flash_attention_dropout(q, k, v, dropout_rate=dropout_rate, dropout_bits=bits,
                                       block_q=S, block_k=S, interpret=True)
    monkeypatch.setattr(jtransformer, "scaled_dot_product_attention", attention)


def patch_port_attention(monkeypatch, dense):
    """The port's attention on the same bits: a layer's call takes rows
    [bh_offset, bh_offset + B*H) of its set, the rows its batch holds in the
    global batch."""
    calls = iter(range(10 ** 6))

    def attention(q, k, v, dropout_rate=0.0, seed=None, bh_offset=0):
        bits = None
        if dropout_rate > 0:
            full = dense[next(calls) % len(dense)]
            bits = full[bh_offset:bh_offset + q.shape[0] * q.shape[1]].contiguous()
        return scaled_dot_product_attention(q, k, v, dropout_rate, dropout_bits=bits)
    monkeypatch.setattr(ptransformer, "scaled_dot_product_attention", attention)


def close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=what)


# --- the modules -----------------------------------------------------------


def test_conditioned_norm_matches_jax():
    """scale = 1 + c Dense_0(c), bias = c Dense_1(c) on x [B, S, F], for c
    [B, 1] and a 0-d c (taken as [1, 1]); JAX's weights transposed."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    c = rng.normal(size=(3, 1)).astype(np.float32)
    jm = JaxConditionedNorm(12)
    params = jm.init(jax.random.key(1), jnp.asarray(c), jnp.asarray(x))["params"]
    # make the maps large enough that a transposition or a swap would show
    params = jax.tree.map(lambda a: a * 40.0 + 0.1, params)
    pm = ConditionedNorm(12, hidden_size=4)
    for dense, lin in (("Dense_0", pm.scale_mlp), ("Dense_1", pm.bias_mlp)):
        lin.weight.data = torch.from_numpy(np.asarray(params[dense]["kernel"]).T.copy())
        lin.bias.data = torch.from_numpy(np.asarray(params[dense]["bias"]))
    for cc, xx in ((c, x), (np.float32(0.6), x[:1])):
        want = jm.apply({"params": params}, jnp.asarray(cc), jnp.asarray(xx))
        got = pm(torch.tensor(cc), torch.from_numpy(xx)).detach().numpy()
        close(got, want, 1e-6)


def test_conditioned_norm_init_is_jax_init_from_the_generator():
    """Weights N(0, 0.01) and zero biases, drawn from the model's generator:
    the init_model draws of the Linear layers leave them alone."""
    magno, attn = port_configs(*configs())
    draws = []
    for seed in (0, 0, 1):
        m = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=LATENT,
                       generator=torch.Generator().manual_seed(seed), device="cpu")
        norms = [mod for mod in m.modules() if isinstance(mod, ConditionedNorm)]
        assert len(norms) == 6  # attention and FFN of 3 blocks
        w = torch.cat([torch.cat([n.scale_mlp.weight.flatten(), n.bias_mlp.weight.flatten()])
                       for n in norms])
        assert all(not n.scale_mlp.bias.any() and not n.bias_mlp.bias.any() for n in norms)
        assert 0.007 < w.std().item() < 0.013
        draws.append(w)
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


def test_augmented_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 5)).astype(np.float32)
    c = rng.normal(size=(2, 1)).astype(np.float32)
    jm = JaxAugmentedMLP(6, hidden_size=9, num_layers=3, use_conditional_norm=True)
    params = jm.init(jax.random.key(3), jnp.asarray(x), jnp.asarray(c))["params"]
    params = dict(params, ConditionedNorm_0=jax.tree.map(lambda a: a * 30.0 + 0.05,
                                                          params["ConditionedNorm_0"]))
    pm = AugmentedMLP(5, 6, hidden_size=9, num_layers=3, use_conditional_norm=True)
    mlp = params["MLP_0"]
    for i, layer in enumerate(pm.mlp.layers):
        d = mlp[f"TorchLinear_{i}"]["Dense_0"]
        layer.weight.data = torch.from_numpy(np.asarray(d["kernel"]).T.copy())
        layer.bias.data = torch.from_numpy(np.asarray(d["bias"]))
    pm.layer_norm.weight.data = torch.from_numpy(np.asarray(params["LayerNorm_0"]["scale"]))
    pm.layer_norm.bias.data = torch.from_numpy(np.asarray(params["LayerNorm_0"]["bias"]))
    for dense, lin in (("Dense_0", pm.cond_norm.scale_mlp), ("Dense_1", pm.cond_norm.bias_mlp)):
        lin.weight.data = torch.from_numpy(
            np.asarray(params["ConditionedNorm_0"][dense]["kernel"]).T.copy())
        lin.bias.data = torch.from_numpy(np.asarray(params["ConditionedNorm_0"][dense]["bias"]))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(c))
    close(pm(torch.from_numpy(x), torch.from_numpy(c)).detach().numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="Conditional input"):
        pm(torch.from_numpy(x))


@pytest.mark.parametrize("head_dim", [16, 32])
def test_rope_with_float_positions_and_rope3d_slices_match_jax(head_dim):
    """apply_rope at float positions takes its frequencies from the slice's
    own width; rope3d rotates three slices of head_dim // 6 * 2 dims by the
    three patch coordinates (10 of 32, 4 of 16) and keeps the rest."""
    rng = np.random.default_rng(head_dim)
    x = rng.normal(size=(2, 3, 20, head_dim)).astype(np.float32)
    pos = (rng.uniform(0, 6, (20, 3)) + 0.25).astype(np.float32)
    third = head_dim // 6 * 2
    want = jnp.concatenate(
        [jax_apply_rope(jnp.asarray(x[..., a * third:(a + 1) * third]),
                        positions=jnp.asarray(pos[:, a])) for a in range(3)]
        + [jnp.asarray(x[..., 3 * third:])], axis=-1)
    got = ptransformer.rope3d(torch.from_numpy(x), torch.from_numpy(pos))
    close(got.numpy(), want, 1e-6)
    assert np.array_equal(got.numpy()[..., 3 * third:], x[..., 3 * third:])
    one = apply_rope(torch.from_numpy(x[..., :third]), torch.from_numpy(pos[:, 1]))
    close(one.numpy(), jax_apply_rope(jnp.asarray(x[..., :third]),
                                      positions=jnp.asarray(pos[:, 1])), 1e-6)


@pytest.fixture(scope="module")
def processor_pair():
    """A JAX UViTProcessor (rope3d, conditioned attention and FFN, 3 blocks,
    input and output projections) and the port's on the same weights."""
    magno, attn = configs()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 24)).astype(np.float32)
    rel = np.stack(np.meshgrid(*(np.arange(n, dtype=np.float32) for n in (4, 4, 2)),
                               indexing="ij"), -1).reshape(-1, 3)
    c = condition()
    jproc = jtransformer.UViTProcessor(24, 24, attn)
    params = jproc.init(jax.random.key(5), jnp.asarray(x), jnp.asarray(c), jnp.asarray(rel))
    # scale the ConditionedNorm maps up from their 0.01 init so that they matter
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 30.0 if "ConditionedNorm" in jax.tree_util.keystr(path) else a,
        params)
    _, pattn = port_configs(magno, attn)
    pproc = ptransformer.UViTProcessor(24, 24, pattn)
    sd = {}
    from gaot3d_tpu.torch_export import _put_processor
    _put_processor(sd, params["params"], attn.num_layers)
    sd.update(conditioned_norm_state_dict({"processor": params["params"]}, attn.num_layers))
    sd = {k.removeprefix("processor."): torch.from_numpy(np.ascontiguousarray(v))
          for k, v in sd.items()}
    pproc.load_state_dict(sd, strict=True)
    return attn, jproc, params["params"], pproc.eval(), x, rel, c


def test_processor_matches_jax(processor_pair):
    attn, jproc, params, pproc, x, rel, c = processor_pair
    want = jproc.apply({"params": params}, jnp.asarray(x), jnp.asarray(c), jnp.asarray(rel))
    with torch.no_grad():
        got = pproc(torch.from_numpy(x), torch.from_numpy(rel), condition=torch.from_numpy(c))
    close(got.numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="needs a condition"):
        pproc(torch.from_numpy(x), torch.from_numpy(rel))


@pytest.mark.parametrize("part", ["attention", "ffn", "block"])
def test_attention_ffn_and_block_match_jax(processor_pair, part):
    """The first block's conditioned attention (ConditionedNorm before the
    q/k/v projections, rope3d on q and k), its FFN (ConditionedNorm on the
    output), and the block, each on JAX's own sub-tree."""
    attn, _, params, pproc, _, rel, c = processor_pair
    x = np.random.default_rng(6).normal(size=(2, 32, HIDDEN)).astype(np.float32)
    block = params["TransformerBlock_0"]
    a = dataclasses.replace(attn.attn_config, positional_embedding=attn.positional_embedding)
    t = torch.from_numpy
    with torch.no_grad():
        if part == "attention":
            jmod = jtransformer.GroupQueryAttention(
                output_size=HIDDEN, hidden_size=HIDDEN, num_heads=HEADS, num_kv_heads=HEADS,
                use_conditional_norm=True, positional_embedding="rope3d",
                attention_dtype="float32")
            want = jmod.apply({"params": block["GroupQueryAttention_0"]}, jnp.asarray(x),
                              jnp.asarray(c), jnp.asarray(rel))
            got = pproc.encoder_layers[0].attn(t(x), t(rel), None, t(c))
        elif part == "ffn":
            jmod = jtransformer.FFN(output_size=HIDDEN, hidden_size=64,
                                    use_conditional_norm=True)
            want = jmod.apply({"params": block["FFN_0"]}, jnp.asarray(x), jnp.asarray(c))
            got = pproc.encoder_layers[0].ffn(t(x), t(c))
        else:
            jmod = jtransformer.TransformerBlock(HIDDEN, HIDDEN, attn_config=a,
                                                 ffn_config=attn.ffn_config)
            want = jmod.apply({"params": block}, jnp.asarray(x), jnp.asarray(c),
                              jnp.asarray(rel))
            got = pproc.encoder_layers[0](t(x), t(rel), condition=t(c))
    close(got.numpy(), want, 1e-5)


# --- the whole model -------------------------------------------------------


@pytest.mark.parametrize("pe,cond", [("rope3d", True), ("rope", True), ("rope3d", False)],
                         ids=["rope3d-cond", "rope-cond", "rope3d"])
def test_model_forward_matches_jax(pe, cond):
    """The eval forward, c [B, 1] through every block's ConditionedNorms."""
    magno, attn = configs(pe, cond, layers=2)
    prob = problem(7)
    pos, feats, _, mask, lat, msk = prob
    jmodel, params, pmodel = model_pair(magno, attn, seed=1, prob=prob)
    c = condition() if cond else None
    jslots = JaxEdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    want = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                        encoder_slots=[jslots], decoder_slots=[jslots],
                        condition=None if c is None else jnp.asarray(c))
    slots = EdgeSlots.from_numpy(lat, msk)
    t = torch.from_numpy
    with torch.no_grad():
        got = pmodel.eval()(t(pos), t(feats), t(mask), encoder_slots=[slots],
                            decoder_slots=[slots], condition=None if c is None else t(c))
    close(got.numpy(), want, 1e-4)


def jax_loss(jmodel, batch, c, train=True, edges=None):
    """JAX's masked MSE of a training forward as a function of the params,
    over the batch's uniform slots or the given edges, c None or [B, 1]."""
    pos, feats, target, mask, lat, msk = batch
    jslots = edges if edges is not None else JaxEdgeSlots(jnp.asarray(lat), jnp.asarray(msk))

    def loss(params):
        pred = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                            encoder_slots=[jslots], decoder_slots=[jslots],
                            condition=None if c is None else jnp.asarray(c), train=train,
                            rngs={"dropout": jax.random.key(0)})
        return jax_masked_mse(pred, jnp.asarray(target), jnp.asarray(mask))
    return loss


def test_train_step_gradients_with_dropout_match_jax(monkeypatch):
    """One conditioned rope3d training forward with attention dropout 0.1 on
    the same bits a layer: the loss to 1e-5 and every gradient, the
    ConditionedNorm maps' included, to 1e-4 of its max-abs."""
    magno, attn = configs("rope3d", True, rate=0.1)
    prob = problem(8, pad=9)
    jmodel, params, pmodel = model_pair(magno, attn, seed=2, prob=prob)
    blocked, dense = dense_bits(9, attn.num_layers, 2, 32)
    patch_jax_attention(monkeypatch, blocked)
    patch_port_attention(monkeypatch, dense)
    c = condition()
    want_loss, grads = jax.value_and_grad(jax_loss(jmodel, prob, c))(params)
    want = port_state(grads, magno, attn)
    pos, feats, target, mask, lat, msk = (torch.from_numpy(a) for a in prob)
    slots = EdgeSlots(lat, msk)
    pmodel.train()
    pred = pmodel(pos, feats, mask, encoder_slots=[slots], decoder_slots=[slots],
                  condition=torch.from_numpy(c), generator=torch.Generator().manual_seed(0))
    loss = masked_mse(pred, target, mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = numpy_state_dict(pmodel, grads=True)
    assert set(got) == set(want) and sum(bool(COND_NORM_KEY.fullmatch(k)) for k in got) == 24
    for key, g in got.items():
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        close(g, w, 1e-4, key)


# --- the weights across ------------------------------------------------------


def test_conditioned_weights_round_trip_the_msgpack_checkpoint(tmp_path):
    """The port writes JAX's tree (ConditionedNorm_0 under
    GroupQueryAttention_0 and FFN_0, Dense_0 scale and Dense_1 bias), which
    the JAX trainer's load_params_only restores into its conditioned params,
    and reads it back into a fresh port model, the same bits."""
    magno, attn = configs()
    jmodel, params, pmodel = model_pair(magno, attn, seed=3)
    with torch.no_grad():
        for p in pmodel.parameters():
            p.add_(0.01)  # other values than JAX's init
    path = os.path.join(tmp_path, "c.msgpack")
    save_msgpack_params(path, pmodel)
    restored = load_params_only(path, params)
    back = port_state(restored, magno, attn)
    mine = numpy_state_dict(pmodel)
    assert set(back) == set(mine)
    for k, v in mine.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    fresh = init_model(2, 1, "gaot_3d", *port_configs(magno, attn), latent_tokens=LATENT,
                       device="cpu")
    load_msgpack_params(path, fresh)
    for k, v in numpy_state_dict(fresh).items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)


def test_reference_tools_carry_no_conditioned_norm_as_jax_tools(tmp_path):
    """JAX's export (`state_dict_from_params`) has no key for a
    ConditionedNorm and its import reads none: the port's reference dict has
    JAX's keys, its import of that dict leaves the maps out, and the
    import tool's msgpack, like the JAX tool's, then fails to load into a
    conditioned model in both packages."""
    magno, attn = configs()
    jmodel, params, pmodel = model_pair(magno, attn, seed=4)
    ref = reference_state_dict(pmodel)
    want = state_dict_from_params(params, magno, attn, latent_tokens=LATENT)
    assert set(ref) == set(want)
    carried = state_dict_from_reference(ref, pmodel)
    assert not any(COND_NORM_KEY.fullmatch(k) for k in carried)
    from gaot3d_tpu_torch.tools import import_torch_ckpt
    cfg_path = os.path.join(tmp_path, "run.json")
    import json
    pmagno, pattn = port_configs(magno, attn)
    with open(cfg_path, "w") as f:
        json.dump({"model": {"args": {"latent_tokens": list(LATENT),
                                      "magno": dataclasses.asdict(pmagno),
                                      "transformer": dataclasses.asdict(pattn)}}}, f)
    pt = os.path.join(tmp_path, "ref.pt")
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()}}, pt)
    out = os.path.join(tmp_path, "imported.msgpack")
    import_torch_ckpt.main(["--config", cfg_path, "--torch-ckpt", pt, "--output", out])
    with pytest.raises((KeyError, ValueError)):
        load_msgpack_params(out, pmodel)
    with pytest.raises((KeyError, ValueError)):
        load_params_only(out, params)
    # with its maps from the flax tree, the conditioned model loads strictly
    load_numpy_state_dict(pmodel, dict(carried, **conditioned_norm_state_dict(
        params, attn.num_layers)))
    with open(out, "rb") as f:
        tree = serialization.msgpack_restore(f.read())["params"]["params"]
    assert "ConditionedNorm_0" not in tree["processor"]["TransformerBlock_0"]["FFN_0"]
