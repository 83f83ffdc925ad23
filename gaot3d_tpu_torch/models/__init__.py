"""Model factory (port of gaot3d_tpu/models/__init__.py `init_model`)."""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.grid_graph import LatentGrid
from .gaot3d import GAOT3D
from .magno import MAGNOConfig, MAGNODecoder, MAGNOEncoder, parse_edge_layout
from .mlp import ConditionedNorm, reset_linear_
from .transformer import AttentionConfig, FFNConfig, TransformerConfig

SUPPORTED_MODELS = ["gaot_3d"]


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises when it names a CUDA device and
    none is present, so that nothing runs on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is present; pass device='cpu' "
            "to run the plain versions on the CPU")
    return device


def init_model(input_size: int, output_size: int, model: str = "gaot_3d",
               magno_config: Optional[MAGNOConfig] = None,
               attn_config: Optional[TransformerConfig] = None,
               latent_tokens=(32, 32, 32), grid: Optional[LatentGrid] = None, *,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> GAOT3D:
    """Build a GAOT3D with torch.nn.Linear-style random weights drawn from
    `generator` (a CPU torch.Generator), the ConditionedNorm maps N(0, 0.01)
    with zero biases, then move it to `device`: the card unless the caller
    asks for the CPU."""
    if model.lower() != "gaot_3d":
        raise ValueError(f"model {model} not supported currently! supported: {SUPPORTED_MODELS}")
    require_device(device)
    net = GAOT3D(input_size, output_size, magno_config, attn_config, latent_tokens, grid)
    for m in net.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d)):
            reset_linear_(m, generator)
    for m in net.modules():  # after the Linear draws: its own init overrides theirs
        if isinstance(m, ConditionedNorm):
            m.reset_parameters_(generator)
    return net.to(device)


__all__ = [
    "GAOT3D",
    "MAGNOConfig",
    "MAGNOEncoder",
    "MAGNODecoder",
    "TransformerConfig",
    "AttentionConfig",
    "FFNConfig",
    "init_model",
    "parse_edge_layout",
    "SUPPORTED_MODELS",
]
