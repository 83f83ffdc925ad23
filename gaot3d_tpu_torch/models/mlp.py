"""MLP building blocks (port of gaot3d_tpu/models/mlp.py).

Module and parameter names follow the reference state dict that
gaot3d_tpu/torch_export.py emits: an MLP keeps its layers in `fcs`. With
`mlp_type: channel` a layer is a kernel-size-1 `nn.Conv1d` (weight
[out, in, 1]), with `linear` an `nn.Linear`; both are applied channel-last as
the same dense product, so the two types differ only in the weight's key
shape. GELU is the exact (erf) form.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels.encoder_payload import kernel_mlp


def reset_linear_(layer: nn.Module, generator: Optional[torch.Generator]) -> None:
    """torch.nn.Linear's default init drawn from `generator`: weight and bias
    both U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    w = layer.weight
    fan_in = w.shape[1] * (w.shape[2] if w.ndim == 3 else 1)
    bound = 1.0 / fan_in ** 0.5
    with torch.no_grad():
        for p in (w, layer.bias):
            if p is not None:
                draw = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_(draw * (2 * bound) - bound)


def kernel_mlp_apply(x: torch.Tensor, fcs: Sequence[nn.Module],
                     compute_dtype: str = "float32") -> torch.Tensor:
    """Dense layers with exact GELU between them and none after the last, at
    the GNO kernel MLP's `kernel_dtype`: 'float32', or 'bfloat16' (operands
    rounded to bf16 a layer, products with an f32 result, bias and GELU in
    f32, as kernels/encoder_payload.py `kernel_mlp` says)."""
    weights = [fc.weight[..., 0] if fc.weight.ndim == 3 else fc.weight for fc in fcs]
    return kernel_mlp(x, weights, [fc.bias for fc in fcs], compute_dtype)


class ChannelMLP(nn.Module):
    """`sizes` = [in, h0, ..., out]; layers in `fcs`, GELU between them."""

    def __init__(self, sizes: Sequence[int], mlp_type: str = "linear"):
        super().__init__()
        if mlp_type not in ("linear", "channel"):
            raise ValueError(f"unknown mlp_type: {mlp_type!r}")
        make = ((lambda i, o: nn.Conv1d(i, o, 1)) if mlp_type == "channel"
                else (lambda i, o: nn.Linear(i, o)))
        self.fcs = nn.ModuleList(make(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return kernel_mlp_apply(x, self.fcs)
