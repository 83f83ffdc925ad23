"""The port's bucket bundles and padding dispatcher against the JAX
package's, on the CPU.

The tiny model of tests/test_serve.py (fused encoder with statistical
geoembed, bidirectional radius 0.45 on a 4x4x4 grid, 2 layers) at f32
attention, the port loading the JAX weights through
gaot3d_tpu.torch_export.state_dict_from_params. Both bundles serve buckets
{64, 128} with the edges built in the forward. The dispatcher is the port's
forward on the padded inputs, sliced, bit for bit (the same computation);
against JAX's bundle it meets the serving parity bound (rtol 1e-4, atol
1e-5); against the port's unpadded forward, whose node loops may run in
another order, 1e-5 relative L2.
"""
import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.serve import export_inference_buckets as jax_export_buckets
from gaot3d_tpu.serve import load_inference_buckets as jax_load_buckets
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu_torch.models import init_model
from gaot3d_tpu_torch.ops.grid_graph import build_budgeted_slots
from gaot3d_tpu_torch.serve import (BucketedInference, export_inference,
                                    export_inference_buckets, load_inference,
                                    load_inference_buckets)
from gaot3d_tpu_torch.weights import load_numpy_state_dict
from test_serve import _tiny
from test_torch_port_model import _port_configs, _with_attention_dtype
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BUCKETS = (64, 128)
REQUESTS = ((50, 64), (64, 64), (100, 128), (128, 128))  # (request nodes, its bucket)


def _pair(kernel_dtype="float32", edge_chunk_size=None):
    """(jax model, params, port model) sharing weights."""
    jmodel = _with_attention_dtype(_tiny(), "float32")
    jmodel = jmodel.clone(magno_config=dataclasses.replace(
        jmodel.magno_config, kernel_dtype=kernel_dtype, edge_chunk_size=edge_chunk_size))
    zeros = jnp.zeros((1, 64, 3), jnp.float32)
    params = jmodel.init({"params": jax.random.key(0)}, zeros, zeros[..., :2],
                         jnp.ones((1, 64), bool))
    magno, attn = _port_configs(jmodel)
    pmodel = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=jmodel.latent_tokens,
                        device="cpu")
    load_numpy_state_dict(pmodel, state_dict_from_params(params, jmodel.magno_config,
                                                         jmodel.attn_config))
    return jmodel, params, pmodel.eval()


def _request(n, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    pos = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    feats = rng.normal(size=(1, n, 2)).astype(np.float32)
    mask = np.ones((1, n), bool)
    mask[0, -3:] = n != 64  # a request may hold masked rows of its own
    return pos, feats, mask


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _padded_forward(pmodel, pos, feats, mask, bucket):
    """The port model's forward on the request padded to `bucket`, sliced."""
    pad = bucket - pos.shape[1]
    args = (np.pad(pos, ((0, 0), (0, pad), (0, 0))), np.pad(feats, ((0, 0), (0, pad), (0, 0))),
            np.pad(mask, ((0, 0), (0, pad))))
    with torch.inference_mode():
        return pmodel(*_torch(*args))[:, :pos.shape[1]]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' bundles of the same weights, loaded."""
    jmodel, params, pmodel = _pair()
    tmp = tmp_path_factory.mktemp("buckets")
    jpath, ppath = os.path.join(tmp, "jax.gaotxb"), os.path.join(tmp, "port.pt")
    jax_export_buckets(jmodel, params,
                       {n: (jnp.zeros((1, n, 3), jnp.float32), jnp.zeros((1, n, 2), jnp.float32),
                            jnp.ones((1, n), bool)) for n in BUCKETS}, jpath)
    export_inference_buckets(pmodel, ppath, BUCKETS)
    return pmodel, jax_load_buckets(jpath), load_inference_buckets(ppath, device="cpu"), ppath


@pytest.mark.parametrize("n,bucket", REQUESTS)
def test_dispatch_equals_the_padded_forward(served, n, bucket):
    """(a) The dispatcher is the model's forward on the request zero-padded to
    its bucket with mask False, sliced back: the same bits."""
    pmodel, _, infer, _ = served
    assert infer.buckets == list(BUCKETS) and infer.bucket(n) == bucket
    pos, feats, mask = _request(n)
    got = infer(*_torch(pos, feats, mask))
    assert got.shape == (1, n, 1)
    assert torch.equal(got, _padded_forward(pmodel, pos, feats, mask, bucket))


@pytest.mark.parametrize("n,bucket", REQUESTS)
def test_dispatch_matches_the_jax_bundle(served, n, bucket):
    """(b) Against JAX's `load_inference_buckets` on a bundle of the same
    weights: rtol 1e-4, atol 1e-5."""
    _, jinfer, infer, _ = served
    pos, feats, mask = _request(n)
    want = jinfer(jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask))
    got = infer(*_torch(pos, feats, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,bucket", REQUESTS)
def test_dispatch_matches_the_unpadded_forward(served, n, bucket):
    """(c) Against the model's forward on the request as it came: 1e-5
    relative L2 (the padded rows are inert; sums may run in another order)."""
    pmodel, _, infer, _ = served
    pos, feats, mask = _request(n)
    got = infer(*_torch(pos, feats, mask))
    with torch.inference_mode():
        want = pmodel(*_torch(pos, feats, mask))
    assert ((got - want).norm() / want.norm()).item() <= 1e-5


@pytest.mark.parametrize("n,bucket", [(50, 64), (100, 128)])
def test_dispatch_in_node_chunks_matches_the_unpadded_forward(tmp_path, n, bucket):
    """(c) With an edge chunk of 16 nodes the padded request's node loops
    take other chunks (16 against 10 or 20 nodes) than the unpadded one's:
    still within 1e-5 relative L2, and the padded forward's bits."""
    _, _, pmodel = _pair(edge_chunk_size=16)
    path = os.path.join(tmp_path, "chunked.pt")
    export_inference_buckets(pmodel, path, BUCKETS)
    infer = load_inference_buckets(path, device="cpu")
    pos, feats, mask = _request(n, seed=n + 2)
    got = infer(*_torch(pos, feats, mask))
    with torch.inference_mode():
        want = pmodel(*_torch(pos, feats, mask))
    assert ((got - want).norm() / want.norm()).item() <= 1e-5
    assert torch.equal(got, _padded_forward(pmodel, pos, feats, mask, bucket))


def test_dispatch_errors(served, tmp_path):
    """(d) A request above the largest bucket, call-time slots at a size that
    is no bucket, and files that are no bundle all raise."""
    pmodel, _, infer, ppath = served
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        infer(*_torch(*_request(200)))
    pos, feats, mask = _torch(*_request(100))
    cfg = pmodel.magno_config
    slots = build_budgeted_slots(pos, pmodel.grid, cfg.gno_radius, cfg.k_neighbors,
                                 "bidirectional", mask, cfg.slot_budget, cfg.edge_chunk_size)
    with pytest.raises(ValueError, match="exact bucket size"):
        infer(pos, feats, mask, slots, slots)
    junk = os.path.join(tmp_path, "junk.pt")
    with open(junk, "wb") as f:
        f.write(b"GAOTX001xxxx")
    single = os.path.join(tmp_path, "single.pt")
    export_inference(pmodel, single)
    for path in (junk, single):
        with pytest.raises(ValueError, match="bucket bundle"):
            load_inference_buckets(path, device="cpu")
    # the default is the card: without one the loader raises, it does not fall back
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        load_inference_buckets(ppath)


def test_call_time_edges_at_an_exact_bucket(served, tmp_path):
    """Call-time slots at an exact bucket size run on them, in a bundle that
    builds its own (mode 'device') and in one whose edges are arguments."""
    pmodel, _, infer, _ = served
    pos, feats, mask = _torch(*_request(128))
    cfg = pmodel.magno_config
    slots = build_budgeted_slots(pos, pmodel.grid, cfg.gno_radius, cfg.k_neighbors,
                                 "bidirectional", mask, cfg.slot_budget, cfg.edge_chunk_size)
    with torch.inference_mode():
        want = pmodel(pos, feats, mask, encoder_slots=[slots], decoder_slots=[slots])
    assert torch.equal(infer(pos, feats, mask, slots, slots), want)
    path = os.path.join(tmp_path, "args.pt")
    export_inference_buckets(pmodel, path, BUCKETS, edges="args")
    args_infer = load_inference_buckets(path, device="cpu")
    assert isinstance(args_infer, BucketedInference)
    assert torch.equal(args_infer(pos, feats, mask, slots, slots), want)
    with pytest.raises(ValueError, match="expected 2 edge structures"):
        args_infer(pos, feats, mask)


def test_load_inference_reads_the_stored_mode(tmp_path):
    """(e) `load_inference` serves the mode the artifact stores, an explicit
    `edges=` wins, and an artifact that stores none serves 'args'."""
    _, _, pmodel = _pair()
    pos, feats, mask = _torch(*_request(64))
    cfg = pmodel.magno_config
    slots = build_budgeted_slots(pos, pmodel.grid, cfg.gno_radius, cfg.k_neighbors,
                                 "bidirectional", mask, cfg.slot_budget, cfg.edge_chunk_size)
    with torch.inference_mode():
        built = pmodel(pos, feats, mask)
        given = pmodel(pos, feats, mask, encoder_slots=[slots], decoder_slots=[slots])
    device_path, args_path = (os.path.join(tmp_path, f"{m}.pt") for m in ("device", "args"))
    export_inference(pmodel, device_path, edges="device")
    export_inference(pmodel, args_path)
    assert torch.equal(load_inference(device_path, device="cpu")(pos, feats, mask), built)
    assert torch.equal(load_inference(args_path, device="cpu")(pos, feats, mask, slots, slots),
                       given)
    with pytest.raises(ValueError, match="expected 2 edge structures"):
        load_inference(args_path, device="cpu")(pos, feats, mask)
    explicit = load_inference(device_path, device="cpu", edges="args")
    assert torch.equal(explicit(pos, feats, mask, slots, slots), given)
    assert torch.equal(load_inference(args_path, device="cpu", edges="device")(pos, feats, mask),
                       built)
    old = torch.load(device_path, weights_only=True)
    del old["edges"]  # an artifact written before the mode was stored
    torch.save(old, device_path)
    assert torch.equal(load_inference(device_path, device="cpu")(pos, feats, mask, slots, slots),
                       given)
    with pytest.raises(ValueError, match="edges must be"):
        export_inference(pmodel, args_path, edges="baked")


def test_bf16_dispatch_equals_the_padded_forward(tmp_path):
    """(f) `kernel_dtype: bfloat16`: the dispatcher is the bf16 model's
    padded forward, sliced, bit for bit."""
    _, _, pmodel = _pair("bfloat16")
    assert pmodel.magno_config.kernel_dtype == "bfloat16"
    path = os.path.join(tmp_path, "bf16.pt")
    export_inference_buckets(pmodel, path, BUCKETS)
    infer = load_inference_buckets(path, device="cpu")
    for n, bucket in ((50, 64), (100, 128)):
        pos, feats, mask = _request(n, seed=n + 1)
        assert torch.equal(infer(*_torch(pos, feats, mask)),
                           _padded_forward(pmodel, pos, feats, mask, bucket))
