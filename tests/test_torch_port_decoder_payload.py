"""The decoder's GNO mean in one pass, K9 (`gaot3d_tpu_torch/kernels/
decoder_payload.py`), on the CPU: the predicate that picks it, its plain
version against `IntegralTransform.decoder_chunk`, and the model's eval
forward, which on the CPU never launches it.

K9 itself runs only on the card (tests/test_torch_port_cuda.py); here the
predicate must pick it for an eval forward on the card of a linear f32
kernel MLP and for nothing else, and the plain
version the CPU path takes must be `decoder_chunk`'s bits.
"""
import itertools

import numpy as np
import pytest
import torch

from gaot3d_tpu_torch.kernels import decoder_payload as k9
from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig,
                                     TransformerConfig, init_model)
from gaot3d_tpu_torch.models.integral_transform import IntegralTransform
from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots, LatentGrid, SectionedEdgeSlots
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

RECIPE = [6, 64, 64, 32]  # drivaerml's decoder kernel MLP


@pytest.mark.parametrize("device,grad,transform,use_attn,kernel_dtype", list(
    itertools.product(["cpu", "cuda"], [False, True],
                      ["linear", "nonlinear", "nonlinear_kernelonly"], [False, True],
                      ["float32", "bfloat16"])))
def test_engages_only_for_an_eval_forward_of_a_linear_f32_gno_on_the_card(
        device, grad, transform, use_attn, kernel_dtype):
    want = (device == "cuda" and not grad and transform == "linear" and not use_attn
            and kernel_dtype == "float32")
    with torch.set_grad_enabled(grad):
        got = k9.engages(device, transform, use_attn, kernel_dtype, RECIPE, 8)
    assert got == want


@pytest.mark.parametrize("widths,k,want", [
    (RECIPE, 8, True), ([6, 16, 8], 1, True), ([6, 32, 32, 32, 16], 128, True),
    (RECIPE, 129, False),           # a tile holds whole nodes of at most 128 slots
    (RECIPE, 0, False),
    ([6, 64, 32, 32], 8, False),    # hidden widths differ
    ([6, 48, 48, 32], 8, False),    # widths not built
    ([9, 64, 64, 32], 8, False),    # a nonlinear kernel's input
    ([6, 32], 8, False),            # no hidden layer
])
def test_engages_only_for_built_widths_and_whole_nodes(widths, k, want):
    with torch.no_grad():
        assert k9.engages("cuda", "linear", False, "float32", widths, k) == want


def _slots(rng, B, n, K, valid):
    """Random slots with masked slots between valid ones and rows with no
    valid slot (the first 7 of each sample)."""
    grid = LatentGrid(dims=(8, 8, 4))
    lat = rng.integers(0, grid.num_tokens, (B, n, K)).astype(np.int32)
    msk = rng.random((B, n, K)) < valid
    msk[:, :7] = False
    lat[~msk] = rng.integers(-5, 10 ** 6, int((~msk).sum()))  # a masked slot may hold anything
    return grid, torch.from_numpy(lat), torch.from_numpy(msk)


@pytest.mark.parametrize("K,B,n,valid", [(5, 1, 300, 0.5), (8, 2, 257, 0.3), (8, 1, 64, 0.9)])
def test_plain_version_is_decoder_chunk_bit_for_bit(K, B, n, valid):
    rng = np.random.default_rng(K + n)
    grid, lat, msk = _slots(rng, B, n, K, valid)
    torch.manual_seed(K)
    gno = IntegralTransform(RECIPE, grid)
    pos = torch.from_numpy(rng.uniform(-1, 1, (B, n, 3)).astype(np.float32))
    latent = torch.randn(B, grid.num_tokens, RECIPE[-1])
    weights = [fc.weight for fc in gno.channel_mlp.fcs]
    biases = [fc.bias for fc in gno.channel_mlp.fcs]
    with torch.no_grad():
        want = gno.decoder_chunk(latent, pos, lat, msk)
        got = k9.decoder_payload(latent, pos, lat, msk, weights, biases, grid)
    assert torch.equal(got, want)
    assert torch.all(got[:, :7] == 0)  # no valid slot: 0
    assert k9.decoder_payload.launches == 0


def _model(scales):
    magno = MAGNOConfig(lifting_channels=8, use_geoembed=[True, False], gno_radius=0.45,
                        in_gno_channel_mlp_hidden_layers=[16, 16],
                        out_gno_channel_mlp_hidden_layers=[16], projection_channels=16,
                        edge_chunk_size=64, scales=scales)
    attn = TransformerConfig(
        patch_size=2, hidden_size=32, num_layers=2, positional_embedding="rope",
        attn_config=AttentionConfig(hidden_size=32, num_heads=4, num_kv_heads=2,
                                    atten_dropout=0.0, attention_dtype="float32"),
        ffn_config=FFNConfig(hidden_size=64))
    return init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4),
                      generator=torch.Generator().manual_seed(0), device="cpu").eval()


@pytest.mark.parametrize("scales,edges", [([1.0], "built"), ([1.0, 1.5], "built"),
                                          ([1.0], "slots"), ([1.0], "sectioned")])
def test_eval_forward_on_the_cpu_keeps_the_plain_path(scales, edges):
    """An eval forward on the CPU (slots built in it, given slots, degree
    sections) is the forward with the gradient on, bit for bit, and
    launches no K9."""
    model = _model(scales)
    rng = np.random.default_rng(len(scales))
    n = 256
    pos = torch.from_numpy(rng.uniform(-1, 1, (1, n, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(1, n, 2)).astype(np.float32))
    mask = torch.ones(1, n, dtype=torch.bool)
    mask[0, -9:] = False
    kw = {}
    if edges != "built":
        lat = torch.from_numpy(rng.integers(0, 64, (1, n, 4)).astype(np.int32))
        msk = torch.from_numpy(rng.random((1, n, 4)) < 0.7)
        slots = EdgeSlots(lat, msk)
        if edges == "sectioned":  # two sections of 128 nodes, 4 and 2 slots
            slots = SectionedEdgeSlots((EdgeSlots(lat[:, :128], msk[:, :128]),
                                        EdgeSlots(lat[:, 128:, :2].contiguous(),
                                                  msk[:, 128:, :2].contiguous())))
        kw = {"encoder_slots": [slots], "decoder_slots": [slots]}
    with torch.inference_mode():
        got = model(pos, feats, mask, **kw)
    with torch.enable_grad():
        want = model(pos, feats, mask, **kw).detach()
    assert torch.equal(got, want)
    assert k9.decoder_payload.launches == 0
