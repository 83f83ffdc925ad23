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


def kernel_weights(fcs: Sequence[nn.Module]):
    """(weights [out, in], biases) of the layers `fcs`, Linear or kernel-size-1
    Conv1d alike."""
    return ([fc.weight[..., 0] if fc.weight.ndim == 3 else fc.weight for fc in fcs],
            [fc.bias for fc in fcs])


def kernel_mlp_apply(x: torch.Tensor, fcs: Sequence[nn.Module],
                     compute_dtype: str = "float32") -> torch.Tensor:
    """Dense layers with exact GELU between them and none after the last, at
    the GNO kernel MLP's `kernel_dtype`: 'float32', or 'bfloat16' (operands
    rounded to bf16 a layer, products with an f32 result, bias and GELU in
    f32, as kernels/encoder_payload.py `kernel_mlp` says)."""
    return kernel_mlp(x, *kernel_weights(fcs), compute_dtype)


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


def activation_fn(name: str):
    """The reference's activations by name: 'none', 'swish' / 'silu',
    exact 'gelu', or any function of torch.nn.functional."""
    if name == "none":
        return lambda x: x
    if name in ("swish", "silu"):
        return torch.nn.functional.silu
    if name == "gelu":
        return torch.nn.functional.gelu
    if hasattr(torch.nn.functional, name):
        return getattr(torch.nn.functional, name)
    raise ValueError(f"Activation function {name} not found")


class MLP(nn.Module):
    """Generic MLP with the activation after every layer but the last; with
    num_layers <= 2 it is a single Linear (the reference quirk)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 num_layers: int = 3, activation: str = "swish"):
        super().__init__()
        self.act = activation_fn(activation)
        if num_layers <= 2:
            sizes = [input_size, output_size]
        else:
            sizes = [input_size] + [hidden_size] * (num_layers - 1) + [output_size]
        self.layers = nn.ModuleList(nn.Linear(sizes[i], sizes[i + 1])
                                    for i in range(len(sizes) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.layers[-1](x)


class ConditionedNorm(nn.Module):
    """Scale and bias of x conditioned on a scalar c a sample:
    scale = 1 + c * scale_mlp(c), bias = c * bias_mlp(c),
    out = x * scale[:, None] + bias[:, None], for c [B, 1] (a 0-d c is
    [1, 1]) and x [B, S, output_size]. Both maps are one Linear c ->
    output_size, weight N(0, 0.01) and bias 0 at init (flax's Dense_0 and
    Dense_1 in that order). `hidden_size` is accepted and unused, as in the
    JAX module."""

    def __init__(self, output_size: int, hidden_size: int = 4):
        super().__init__()
        self.hidden_size = hidden_size
        self.scale_mlp = nn.Linear(1, output_size)
        self.bias_mlp = nn.Linear(1, output_size)
        self.reset_parameters_(None)

    def reset_parameters_(self, generator: Optional[torch.Generator]) -> None:
        """The JAX init, drawn from `generator`: weights N(0, 0.01), biases 0."""
        with torch.no_grad():
            for layer in (self.scale_mlp, self.bias_mlp):
                layer.weight.copy_(0.01 * torch.randn(layer.weight.shape, generator=generator))
                layer.bias.zero_()

    def forward(self, c, x: torch.Tensor) -> torch.Tensor:
        c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
        if c.ndim == 0:
            c = c.reshape(1, 1)
        scale = 1.0 + c * self.scale_mlp(c)
        bias = c * self.bias_mlp(c)
        return x * scale[:, None, :] + bias[:, None, :]


class AugmentedMLP(nn.Module):
    """MLP, then an optional LayerNorm, then an optional ConditionedNorm on
    `condition` (the JAX package's AugmentedMLP; neither package calls it)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int = 64,
                 num_layers: int = 3, activation: str = "swish", use_layer_norm: bool = True,
                 use_conditional_norm: bool = False, cond_norm_hidden_size: int = 4):
        super().__init__()
        self.mlp = MLP(input_size, output_size, hidden_size, num_layers, activation)
        self.layer_norm = nn.LayerNorm(output_size, eps=1e-6) if use_layer_norm else None
        self.cond_norm = (ConditionedNorm(output_size, cond_norm_hidden_size)
                          if use_conditional_norm else None)

    def forward(self, x: torch.Tensor, condition=None) -> torch.Tensor:
        x = self.mlp(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        if self.cond_norm is not None:
            if condition is None:
                raise ValueError("Conditional input c should be provided")
            x = self.cond_norm(condition, x)
        return x
