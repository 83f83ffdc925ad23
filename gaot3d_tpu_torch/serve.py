"""Serving export for the port (counterpart of gaot3d_tpu/serve.py).

The artifact is `torch.save({"config": ..., "state_dict": ...})`: the model's
constructor arguments as plain data plus its weights. `load_inference`
rebuilds the model on a device and returns its eval forward in one of two
modes. With `edges="args"` (the default) the forward takes the precomputed
edge structures as call-time arguments, like `make_edge_arg_model`:

    export_inference(model, "model.pt")                          # once
    infer = load_inference("model.pt")                           # serve, on the card
    pred = infer(pos, feats, mask, encoder_slots, decoder_slots)

With `edges="device"` (`make_device_edge_model`) the forward builds both
sides' slots on the device from the points, as the JAX package's default
export does, and the decoder's queries are call-time arguments too (the
input points by default):

    infer = load_inference("model.pt", edges="device")
    pred = infer(pos, feats, mask)                               # [B, N, out]
    pred = infer(pos, feats, mask, query_pos, query_mask)        # [B, Q, out]

The exported config holds what the build needs: grid, radius, k, strategies,
slot budget and node chunk; and `kernel_dtype`, so a bf16 model is served
at bf16.

Each side takes any edge structure the model runs: `EdgeSlots`,
`SectionedEdgeSlots` or `FlatEdgeChunks` (the encoder's built in the order
the exported config's `flat_order` names, the decoder's always in 'src'
order). With sectioned slots, `pos` and `feats` are in the sections' permuted
node order and so is the prediction; with flat edge lists they stay in the
caller's order.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from .models import MAGNOConfig, TransformerConfig, init_model, require_device
from .models.gaot3d import GAOT3D
from .models.transformer import AttentionConfig, FFNConfig
from .ops.grid_graph import LatentGrid


def model_config(model: GAOT3D) -> dict:
    """The constructor arguments of `model` as plain data."""
    g = model.grid
    return {
        "input_size": model.input_size,
        "output_size": model.output_size,
        "magno_config": dataclasses.asdict(model.magno_config),
        "attn_config": dataclasses.asdict(model.attn_config),
        "latent_tokens": list(model.latent_tokens),
        "grid": {"dims": list(g.dims), "lo": list(g.lo), "hi": list(g.hi)},
    }


def model_from_config(config: dict, device="cuda") -> GAOT3D:
    attn = dict(config["attn_config"])
    attn["attn_config"] = AttentionConfig(**attn["attn_config"])
    attn["ffn_config"] = FFNConfig(**attn["ffn_config"])
    g = config["grid"]
    return init_model(
        config["input_size"], config["output_size"], "gaot_3d",
        MAGNOConfig(**config["magno_config"]), TransformerConfig(**attn),
        latent_tokens=tuple(config["latent_tokens"]),
        grid=LatentGrid(tuple(g["dims"]), tuple(g["lo"]), tuple(g["hi"])), device=device)


def export_inference(model: GAOT3D, path: str) -> None:
    """Write the model's config and weights to `path` (atomically)."""
    blob = {"config": model_config(model),
            "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def make_edge_arg_model(model: GAOT3D, num_scales: int = 1) -> Callable:
    """The eval forward with edge structures as call-time arguments:
    `infer(pos, feats, mask, enc_s0..enc_s{S-1}, dec_s0..dec_s{S-1})`."""

    def infer(pos, feats, mask, *edges):
        if len(edges) != 2 * num_scales:
            raise ValueError(f"expected {2 * num_scales} edge structures "
                             f"(encoder+decoder per scale), got {len(edges)}")
        with torch.inference_mode():
            return model(pos, feats, mask, encoder_slots=list(edges[:num_scales]),
                         decoder_slots=list(edges[num_scales:]))

    return infer


def make_device_edge_model(model: GAOT3D) -> Callable:
    """The eval forward that builds its slots on the device:
    `infer(pos, feats, mask, query_pos=None, query_mask=None)`; query_mask
    defaults to all true when query_pos is given."""

    def infer(pos, feats, mask, query_pos=None, query_mask=None):
        with torch.inference_mode():
            return model(pos, feats, mask, query_pos=query_pos, query_mask=query_mask)

    return infer


def load_inference(path: str, device="cuda", edges: str = "args") -> Callable:
    """Rebuild an exported model on `device` (the card unless the caller asks
    for the CPU) in eval mode and return its forward: with edges "args" the
    call-time-edges forward (see make_edge_arg_model), which accepts slots,
    sections or flat edge lists; with edges "device" the forward that builds
    them (see make_device_edge_model)."""
    if edges not in ("args", "device"):
        raise ValueError(f"edges must be 'args' or 'device', got {edges!r}")
    device = require_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model = model_from_config(blob["config"], device="cpu")
    model.load_state_dict(blob["state_dict"], strict=True)
    model = model.to(device).eval()
    return make_device_edge_model(model) if edges == "device" else make_edge_arg_model(model)
