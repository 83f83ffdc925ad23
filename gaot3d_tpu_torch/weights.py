"""Reference-keyed weights in and out of the port.

The port's module and parameter names are the keys that
gaot3d_tpu/torch_export.py `state_dict_from_params` emits, so a JAX param
tree exported there loads here with `strict=True` and no second mapping.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.gaot3d import GAOT3D


def load_numpy_state_dict(model: GAOT3D, state: Mapping[str, np.ndarray]) -> GAOT3D:
    """Copy a {reference key: np.ndarray} state dict into `model` (strict).

    The optional `latent_tokens` buffer of the reference is checked against
    the model's latent grid and not stored: the port computes cell
    coordinates from the grid itself."""
    state = dict(state)
    tokens = state.pop("latent_tokens", None)
    if tokens is not None:
        want = model.grid.positions().numpy()
        if np.shape(tokens) != want.shape or not np.allclose(tokens, want, atol=1e-6):
            raise ValueError("latent_tokens buffer does not match the model's latent grid")
    model.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in state.items()},
                          strict=True)
    return model


def numpy_state_dict(model: GAOT3D, grads: bool = False) -> Dict[str, np.ndarray]:
    """The model's parameters as {reference key: np.ndarray}, or with
    `grads=True` their gradients (every parameter must have one). The keys
    are those of `state_dict_from_params`, so a JAX param or gradient tree
    exported there compares entry by entry."""
    out = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"parameter {name} has no gradient")
        out[name] = t.detach().cpu().numpy().copy()
    return out
