"""The port's flat edge layout and sorted encoder reductions against the JAX
package on the CPU.

Host side: the port's `flatten_slots_host` gives exactly the JAX function's
lists, both orders, and raises where edges would be dropped. Whole slice: the
model of tests/test_flat_edges.py (fused encoder with statistical geoembed,
GNO-only decode head, 2 layers, a 4x4x4 latent grid, 64 points in chunks of
16) runs in both packages on the same weights (carried over by
gaot3d_tpu.torch_export and gaot3d_tpu_torch.weights) and the same numpy
inputs, f32 attention, for every layout and reduction the port now honours.
Tolerances are those of tests/test_flat_edges.py: outputs to 5e-5, gradients
to 2e-4 (absolute and relative), both sides float32 with sums in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.ops import grid_graph as jgg
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu_torch.data import host_graph
from gaot3d_tpu_torch.models import MAGNOConfig, init_model, parse_edge_layout
from gaot3d_tpu_torch.models.integral_transform import IntegralTransform
from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots, FlatEdgeChunks, LatentGrid
from gaot3d_tpu_torch.serve import export_inference, load_inference
from gaot3d_tpu_torch.train import (OptimizerargsConfig, TrainBatch, make_optimizer,
                                    train_step)
from gaot3d_tpu_torch.weights import load_numpy_state_dict, numpy_state_dict
from test_flat_edges import _flagship_model
from test_torch_port_model import _port_configs, _with_attention_dtype
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, N, CHUNK = 2, 64, 16


# --- host: flattening -----------------------------------------------------------


def _random_slots(seed, n=256, k=5, cells=500):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cells, (n, k)).astype(np.int32), rng.random((n, k)) < 0.5)


@pytest.mark.parametrize("order", ["src", "dst"])
@pytest.mark.parametrize("pinned", [0, 128])
def test_flatten_slots_host_equals_jax(order, pinned):
    lat, msk = _random_slots(17)
    want = jgg.flatten_slots_host(lat, msk, 32, pad_multiple=8, order=order,
                                  edges_per_chunk=pinned)
    got = host_graph.flatten_slots_host(lat, msk, 32, pad_multiple=8, order=order,
                                        edges_per_chunk=pinned)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("order", ["src", "dst"])
def test_flatten_slots_host_equals_the_numpy_form(order, monkeypatch):
    """The JAX function's numpy branch (taken when its native library is
    missing) is the plain version the native flattening is held against."""
    lat, msk = _random_slots(19)
    got = host_graph.flatten_slots_host(lat, msk, 32, pad_multiple=8, order=order)
    monkeypatch.setattr(jgg, "_GRAPH_LIB", None)
    monkeypatch.setattr(jgg, "_GRAPH_LIB_TRIED", True)
    want = jgg.flatten_slots_host(lat, msk, 32, pad_multiple=8, order=order)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_flatten_slots_host_batched_equals_jax():
    lat = np.stack([_random_slots(s)[0] for s in (1, 2)])
    msk = np.stack([_random_slots(s)[1] for s in (1, 2)])
    msk[1, :40] = True  # the second sample needs a larger E: the first is padded up
    want = jgg.flatten_slots_host_batched(lat, msk, 32, pad_multiple=8, order="dst",
                                          host_arrays=True)
    got = host_graph.flatten_slots_host_batched(lat, msk, 32, pad_multiple=8, order="dst")
    assert isinstance(got, FlatEdgeChunks)
    assert (got.num_chunks, got.edges_per_chunk) == (8, want.src.shape[-1])
    assert got.src.dtype == got.dst.dtype == torch.int32 and got.mask.dtype == torch.bool
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_flatten_slots_host_refuses_to_drop_edges():
    lat = np.zeros((8, 4), np.int32)
    msk = np.ones((8, 4), bool)
    with pytest.raises(ValueError, match="edges would be dropped"):
        host_graph.flatten_slots_host(lat, msk, 4, edges_per_chunk=8)
    with pytest.raises(ValueError, match="unknown flat edge order"):
        host_graph.flatten_slots_host(lat, msk, 4, order="cell")
    with pytest.raises(ValueError, match="must divide"):
        host_graph.flatten_slots_host(lat, msk, 3)


# --- the whole slice ---------------------------------------------------------------


def _problem(seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, 2)).astype(np.float32)
    target = rng.normal(size=(B, N, 1)).astype(np.float32)
    mask = np.ones((B, N), bool)
    slots = jgg.build_edge_slots_batched(jnp.asarray(pos), jgg.LatentGrid(dims=(4, 4, 4)), 0.45,
                                         k_neighbors=1, strategy="bidirectional",
                                         point_mask=jnp.asarray(mask))
    return pos, feats, target, mask, np.asarray(slots.lat_idx), np.asarray(slots.mask)


def _edges(kind, lat, msk):
    """(JAX structure, port structure) of one side: slots, or flat in an order."""
    if kind == "slots":
        return (jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk)), EdgeSlots.from_numpy(lat, msk))
    order = kind.split(":")[1]
    return (jgg.flatten_slots_host_batched(lat, msk, CHUNK, pad_multiple=8, order=order),
            host_graph.flatten_slots_host_batched(lat, msk, CHUNK, pad_multiple=8, order=order))


def _pair(seed, lat, msk, pos, feats, mask, **magno_kw):
    """(jax model, params, port model) sharing weights; f32 attention."""
    jmodel = _with_attention_dtype(_flagship_model(**magno_kw), "float32")
    base = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    params = jmodel.init({"params": jax.random.key(seed)}, jnp.asarray(pos), jnp.asarray(feats),
                         jnp.asarray(mask), encoder_slots=[base], decoder_slots=[base])
    magno, attn = _port_configs(jmodel)
    pmodel = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=jmodel.latent_tokens,
                        device="cpu")
    load_numpy_state_dict(pmodel, state_dict_from_params(
        params, jmodel.magno_config, jmodel.attn_config, latent_tokens=jmodel.latent_tokens))
    return jmodel, params, pmodel


_CASES = {
    "flat src": (dict(edge_layout="flat"), "flat:src", "flat:src"),
    "flat src, segment_impl sort": (dict(edge_layout="flat", segment_impl="sort"),
                                    "flat:src", "flat:src"),
    "flat src, segment_impl tile": (dict(edge_layout="flat", segment_impl="tile"),
                                    "flat:src", "flat:src"),
    "flat dst, fold": (dict(edge_layout="flat", flat_order="dst"), "flat:dst", "flat:src"),
    "flat dst, pallas": (dict(edge_layout="flat", flat_order="dst", flat_reduce_impl="pallas"),
                         "flat:dst", "flat:src"),
    "slots, segment_impl sort": (dict(segment_impl="sort"), "slots", "slots"),
    "slots, segment_impl tile": (dict(segment_impl="tile"), "slots", "slots"),
    "mixed [flat, slots]": (dict(edge_layout=["flat", "slots"]), "flat:src", "slots"),
    "mixed [slots, flat]": (dict(edge_layout=["slots", "flat"]), "slots", "flat:src"),
    "flat, plain decoder tail": (dict(edge_layout="flat", fused_head=False),
                                 "flat:src", "flat:src"),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_whole_slice_matches_jax_output_and_gradients(case):
    magno_kw, enc_kind, dec_kind = _CASES[case]
    pos, feats, target, mask, lat, msk = _problem(seed=23 + len(case))
    jmodel, params, pmodel = _pair(0, lat, msk, pos, feats, mask, **magno_kw)
    (jenc, penc), (jdec, pdec) = _edges(enc_kind, lat, msk), _edges(dec_kind, lat, msk)

    def loss(p):
        pred = jmodel.apply(p, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                            encoder_slots=[jenc], decoder_slots=[jdec])
        return jnp.sum((pred - jnp.asarray(target)) ** 2), pred

    (want_loss, want_out), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    t = torch.from_numpy
    pmodel.train()
    out = pmodel(t(pos), t(feats), t(mask), encoder_slots=[penc], decoder_slots=[pdec])
    total = ((out - t(target)) ** 2).sum()
    total.backward()
    assert out.shape == (B, N, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=5e-5, rtol=0)
    np.testing.assert_allclose(total.item(), float(want_loss), rtol=1e-5)
    want = state_dict_from_params(want_grads, jmodel.magno_config, jmodel.attn_config)
    got = numpy_state_dict(pmodel, grads=True)
    assert set(got) == set(want)
    for key, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want[key]), atol=2e-4, rtol=2e-4, err_msg=key)


def test_flat_outputs_come_back_in_the_callers_node_order():
    """Flat lists leave the nodes where they are: the flat forward equals the
    uniform-slot forward row for row (sectioned outputs would be permuted)."""
    pos, feats, _, mask, lat, msk = _problem(seed=5)
    _, _, pmodel = _pair(1, lat, msk, pos, feats, mask, flat_order="dst")
    t = torch.from_numpy
    slots = EdgeSlots.from_numpy(lat, msk)
    with torch.inference_mode():
        pmodel.eval()
        want = pmodel(t(pos), t(feats), t(mask), encoder_slots=[slots], decoder_slots=[slots])
        got = pmodel(t(pos), t(feats), t(mask), encoder_slots=[_edges("flat:dst", lat, msk)[1]],
                     decoder_slots=[_edges("flat:src", lat, msk)[1]])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5, rtol=0)


def test_served_model_accepts_flat_chunks(tmp_path):
    """Export, load and serve with flat edge lists on both sides and on one;
    the exported config keeps the four fields."""
    pos, feats, _, mask, lat, msk = _problem(seed=7)
    kw = dict(edge_layout=["flat", "slots"], flat_order="dst", flat_reduce_impl="pallas",
              flat_edges_per_chunk=48)
    _, _, pmodel = _pair(2, lat, msk, pos, feats, mask, **kw)
    path = str(tmp_path / "flat.pt")
    export_inference(pmodel, path)
    infer = load_inference(path, device="cpu")
    cfg = torch.load(path, weights_only=True)["config"]["magno_config"]
    assert {k: cfg[k] for k in kw} == kw
    t = torch.from_numpy
    enc = host_graph.flatten_slots_host_batched(lat, msk, CHUNK, order="dst",
                                                edges_per_chunk=cfg["flat_edges_per_chunk"])
    assert enc.edges_per_chunk == 48
    dec = host_graph.flatten_slots_host_batched(lat, msk, CHUNK, pad_multiple=8)
    slots = EdgeSlots.from_numpy(lat, msk)
    with torch.inference_mode():
        want = pmodel.eval()(t(pos), t(feats), t(mask), encoder_slots=[slots],
                             decoder_slots=[slots])
    for e, d in ((enc, slots), (enc, dec)):
        got = infer(t(pos), t(feats), t(mask), e, d)
        assert got.shape == (B, N, 1) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5, rtol=0)


def test_train_step_takes_flat_chunks():
    pos, feats, target, mask, lat, msk = _problem(seed=9)
    _, _, pmodel = _pair(3, lat, msk, pos, feats, mask, flat_order="dst",
                         flat_reduce_impl="pallas")
    t = torch.from_numpy
    batch = TrainBatch(t(pos), t(feats), t(target), t(mask), _edges("flat:dst", lat, msk)[1],
                       _edges("flat:src", lat, msk)[1])
    before = [p.detach().clone() for p in pmodel.parameters()]
    opt = make_optimizer("adamw", pmodel.parameters(), OptimizerargsConfig(), steps_per_epoch=1)
    loss, norm = train_step(pmodel, opt, batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and torch.isfinite(norm)
    assert all(not torch.equal(p, b) for p, b in zip(pmodel.parameters(), before))


# --- config fields and refusals ---------------------------------------------------


def test_parse_edge_layout():
    assert parse_edge_layout("slots") == ("slots", "slots")
    assert parse_edge_layout("flat") == ("flat", "flat")
    assert parse_edge_layout(["flat", "slots"]) == ("flat", "slots")
    assert parse_edge_layout(("slots", "flat")) == ("slots", "flat")
    assert parse_edge_layout("sectioned") == ("sectioned", "sectioned")
    with pytest.raises(ValueError, match="unknown edge_layout"):
        parse_edge_layout("dense")
    with pytest.raises(ValueError, match="length 2"):
        parse_edge_layout(["flat", "slots", "flat"])
    with pytest.raises(ValueError, match="both sides"):
        parse_edge_layout(["sectioned", "flat"])


@pytest.mark.parametrize("field,value", [("segment_impl", "atomic"), ("flat_order", "cell"),
                                         ("flat_reduce_impl", "mxu"), ("edge_layout", "dense")])
def test_unknown_reduction_and_layout_values_raise(field, value):
    magno, attn = _port_configs(_flagship_model())
    with pytest.raises(ValueError, match=f"unknown {field}"):
        init_model(2, 1, "gaot_3d", dataclasses.replace(magno, **{field: value}), attn,
                   latent_tokens=(4, 4, 4), device="cpu")


@pytest.mark.parametrize("magno_kw,match", [
    (dict(use_geoembed=[True, True], fused_head=False), "decoder geoembed"),
    (dict(fused_encoder=False), "fused"),
    (dict(max_radius_neighbors=32), "radius caps"),
    (dict(sampling_strategy="max_neighbors", max_neighbors=4), "edge sampling"),
])
def test_what_jax_refuses_for_flat_edges_stays_refused(magno_kw, match):
    """tests/test_flat_edges.py test_flat_rejects_unsupported_configs: the JAX
    model refuses these when handed flat edges; the port refuses them when
    the model is built."""
    magno, attn = _port_configs(_flagship_model(edge_layout="flat", **magno_kw))
    with pytest.raises(NotImplementedError, match=match):
        init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4), device="cpu")


def test_flat_edges_are_validated():
    pos, feats, _, mask, lat, msk = _problem(seed=11)
    _, _, pmodel = _pair(4, lat, msk, pos, feats, mask)
    t = torch.from_numpy
    flat = _edges("flat:src", lat, msk)[1]
    slots = EdgeSlots.from_numpy(lat, msk)

    def run(enc):
        return pmodel(t(pos), t(feats), t(mask), encoder_slots=[enc], decoder_slots=[slots])

    with pytest.raises(ValueError, match="outside its chunk"):
        run(flat._replace(dst=torch.where(flat.mask, torch.full_like(flat.dst, 64), flat.dst)))
    with pytest.raises(ValueError, match="outside its chunk"):
        run(flat._replace(src=flat.src + CHUNK * flat.mask.to(torch.int32)))
    with pytest.raises(ValueError, match="must divide"):
        run(FlatEdgeChunks(*(x[:, :3] for x in flat)))
    with pytest.raises(ValueError, match="int32"):
        run(flat._replace(src=flat.src.long()))
    gno = IntegralTransform([6, 16, 8], LatentGrid(dims=(4, 4, 4)))
    with pytest.raises(ValueError, match="fused encoder"):
        gno(flat, t(pos), torch.zeros(B, 64, 8), direction="encoder")


@pytest.mark.parametrize("side,wrong", [("decoder", "dst list"), ("decoder", "padding first"),
                                        ("encoder", "src list"), ("decoder", "one list for both")])
def test_flat_edges_in_the_wrong_order_raise(side, wrong):
    """The presorted folds trust their key's order: the decoder's by node, and
    the encoder's by cell under flat_order 'dst'. A list in another order
    would give wrong sums silently, so the forward refuses it."""
    pos, feats, _, mask, lat, msk = _problem(seed=13)
    _, _, pmodel = _pair(5, lat, msk, pos, feats, mask, edge_layout="flat", flat_order="dst")
    t = torch.from_numpy
    by_src, by_dst = _edges("flat:src", lat, msk)[1], _edges("flat:dst", lat, msk)[1]
    assert not torch.equal(by_src.dst, by_dst.dst)
    enc, dec = {"dst list": (by_dst, FlatEdgeChunks(*by_dst)),
                "padding first": (by_dst, FlatEdgeChunks(*(x.flip(-1) for x in by_src))),
                "src list": (by_src, by_src),
                "one list for both": (by_dst, by_dst)}[wrong]
    with pytest.raises(ValueError, match="not sorted by " + ("src" if side == "decoder" else "dst")):
        pmodel(t(pos), t(feats), t(mask), encoder_slots=[enc], decoder_slots=[dec])
    # the right pair passes
    out = pmodel(t(pos), t(feats), t(mask), encoder_slots=[by_dst], decoder_slots=[by_src])
    assert torch.isfinite(out).all()
