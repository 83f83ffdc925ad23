"""Serving export for the port (counterpart of gaot3d_tpu/serve.py).

A single artifact is `torch.save({"config": ..., "state_dict": ..., "edges":
mode})`: the model's constructor arguments as plain data, its weights, and
the serving mode it was exported for. `load_inference` rebuilds the model on
a device and returns its eval forward in one of two modes. With
`edges="args"` (the default of `export_inference`) the forward takes the
precomputed edge structures as call-time arguments, like
`make_edge_arg_model`:

    export_inference(model, "model.pt")                          # once
    infer = load_inference("model.pt")                           # serve, on the card
    pred = infer(pos, feats, mask, encoder_slots, decoder_slots)

With `edges="device"` (`make_device_edge_model`) the forward builds both
sides' slots on the device from the points, as the JAX package's baked
export does, and the decoder's queries are call-time arguments too (the
input points by default):

    export_inference(model, "model.pt", edges="device")
    infer = load_inference("model.pt")                           # the stored mode
    pred = infer(pos, feats, mask)                               # [B, N, out]
    pred = infer(pos, feats, mask, query_pos, query_mask)        # [B, Q, out]

`load_inference(path, edges=...)` overrides the stored mode; an artifact
without one (written before the mode was stored) serves with "args".

The exported config holds what the build needs: grid, radius, scales, k,
strategies, slot budget and node chunk; `kernel_dtype`, so a bf16 model is
served at bf16; and the MAGNO variant (transform types, attention, geoembed,
scale weights, caps). A model of S scales takes 2·S edge structures with
`edges="args"` (the encoder's S, then the decoder's) and builds S a side
with `edges="device"`.

Each side takes any edge structure the model runs: `EdgeSlots`,
`SectionedEdgeSlots` or `FlatEdgeChunks` (the encoder's built in the order
the exported config's `flat_order` names, the decoder's always in 'src'
order). With sectioned slots, `pos` and `feats` are in the sections' permuted
node order and so is the prediction; with flat edge lists they stay in the
caller's order.

A bucket bundle (`export_inference_buckets`) is one `torch.save` file with
the same config and weights, once, plus the sorted node counts it serves
("buckets"), the serving mode and a format tag. `load_inference_buckets`
returns `BucketedInference`, which pads each request along the node axis to
the smallest covering bucket on the request's device (mask False on the
padded rows, which stay inert) and slices the prediction back, as
gaot3d_tpu/serve.py `BucketedInference` does. The port's forward is not
static-shaped, so the buckets fix the shapes a deployment serves (and may
capture), not one compiled function each.
"""
from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from .edges import LatentGrid
from .models import MAGNOConfig, TransformerConfig, init_model, require_device
from .models.gaot3d import GAOT3D
from .models.transformer import AttentionConfig, FFNConfig
from .tracing import span

EDGE_MODES = ("args", "device")
BUNDLE_FORMAT = "gaot3d_tpu_torch bucket bundle 1"


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


def _check_mode(edges: str) -> str:
    if edges not in EDGE_MODES:
        raise ValueError(f"edges must be 'args' or 'device', got {edges!r}")
    return edges


def _save(blob: dict, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def _model_blob(model: GAOT3D, edges: str) -> dict:
    return {"config": model_config(model),
            "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "edges": _check_mode(edges)}


def export_inference(model: GAOT3D, path: str, edges: str = "args") -> None:
    """Write the model's config, weights and serving mode `edges` ("args":
    edge structures as call-time arguments; "device": slots built in the
    forward) to `path` (atomically)."""
    _save(_model_blob(model, edges), path)


def _load_model(blob: dict, device) -> GAOT3D:
    model = model_from_config(blob["config"], device="cpu")
    model.load_state_dict(blob["state_dict"], strict=True)
    return model.to(device).eval()


def make_edge_arg_model(model: GAOT3D, num_scales: Optional[int] = None) -> Callable:
    """The eval forward with edge structures as call-time arguments:
    `infer(pos, feats, mask, enc_s0..enc_s{S-1}, dec_s0..dec_s{S-1})`, S the
    model's number of scales unless `num_scales` says otherwise."""
    if num_scales is None:
        num_scales = len(model.magno_config.scales)

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
        with torch.inference_mode(), span("gaot.serve.forward"):
            return model(pos, feats, mask, query_pos=query_pos, query_mask=query_mask)

    return infer


def load_inference(path: str, device="cuda", edges: Optional[str] = None) -> Callable:
    """Rebuild an artifact of `export_inference` on `device` (the card unless
    the caller asks for the CPU) in eval mode and return its forward in the
    serving mode `edges`: the one stored in the artifact when left out
    ("args" for an artifact that stores none). "args" is the
    call-time-edges forward (see make_edge_arg_model), which accepts slots,
    sections or flat edge lists; "device" the forward that builds them (see
    make_device_edge_model)."""
    if edges is not None:
        _check_mode(edges)
    device = require_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    edges = edges or _check_mode(blob.get("edges", "args"))
    model = _load_model(blob, device)
    return make_device_edge_model(model) if edges == "device" else make_edge_arg_model(model)


# -- bucket bundles ------------------------------------------------------------


def export_inference_buckets(model: GAOT3D, path: str, buckets: Sequence[int],
                             edges: str = "device") -> None:
    """Write a bucket bundle: the model's config and weights, the node counts
    `buckets` it serves (sorted) and its serving mode `edges` (by default
    "device", slots built in the forward, which lets any request up to the
    largest bucket be padded), atomically."""
    sizes = sorted({int(n) for n in buckets})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"buckets must be positive node counts, got {list(buckets)}")
    _save({**_model_blob(model, edges), "format": BUNDLE_FORMAT, "buckets": sizes}, path)


class BucketedInference:
    """Dispatcher over a bucket bundle: pads (pos, feats, mask) along the node
    axis to the smallest covering bucket, with mask False on the padded rows
    (which stay inert: no edge is built from them and the decoder's rows for
    them are sliced off), and slices the prediction back to the request's
    `n`. Requests with extra arguments (call-time edge structures) must
    already be at an exact bucket size: edge structures are not padded here.

    `infer(pos, feats, mask, *edges)` is the model's eval forward: without
    edges it builds its slots on the device (mode "device"); with them it
    runs on them (either mode)."""

    def __init__(self, infer: Callable, buckets: Sequence[int]):
        self.infer = infer
        self.buckets = sorted(int(n) for n in buckets)

    def bucket(self, n: int, exact: bool = False) -> int:
        """The smallest bucket that covers `n` nodes (`n` itself if exact)."""
        bucket = next((b for b in self.buckets if b >= n), None)
        if bucket is None:
            raise ValueError(f"{n} nodes exceeds the largest bucket {self.buckets[-1]}")
        if exact and bucket != n:
            raise ValueError(f"call-time edge structures require an exact bucket size; "
                             f"got {n} nodes, buckets {self.buckets}")
        return bucket

    @staticmethod
    def pad(pos: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor, bucket: int):
        """(pos, feats, mask) zero-padded to `bucket` nodes on their device."""
        pad = bucket - pos.shape[1]
        return (F.pad(pos, (0, 0, 0, pad)), F.pad(feats, (0, 0, 0, pad)),
                F.pad(mask, (0, pad), value=False))

    def __call__(self, pos, feats, mask, *edges):
        n = pos.shape[1]
        bucket = self.bucket(n, exact=bool(edges))
        if bucket == n:
            return self.infer(pos, feats, mask, *edges)
        return self.infer(*self.pad(pos, feats, mask, bucket))[:, :n]


def load_inference_buckets(path: str, device="cuda") -> BucketedInference:
    """Load a bucket bundle onto `device` (the card unless the caller asks for
    the CPU) and return its padding dispatcher."""
    device = require_device(device)
    blob = (torch.load(path, map_location="cpu", weights_only=True)
            if zipfile.is_zipfile(path) else None)
    if not isinstance(blob, dict) or blob.get("format") != BUNDLE_FORMAT:
        raise ValueError(f"{path} is not a gaot3d_tpu_torch bucket bundle")
    model = _load_model(blob, device)
    edge_arg = make_edge_arg_model(model)
    if _check_mode(blob["edges"]) == "args":
        return BucketedInference(edge_arg, blob["buckets"])
    built = make_device_edge_model(model)
    return BucketedInference(
        lambda pos, feats, mask, *edges: (edge_arg(pos, feats, mask, *edges) if edges
                                          else built(pos, feats, mask)),
        blob["buckets"])
