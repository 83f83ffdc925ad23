"""Reference-keyed weights in and out of the port.

The port's module and parameter names are the keys that
gaot3d_tpu/torch_export.py `state_dict_from_params` emits, so a JAX param
tree exported there loads here with `strict=True` and no second mapping.
The same keys are the reference PyTorch GAOT-3D's, so its checkpoints come
in through `state_dict_from_reference` and go out through
`reference_state_dict`.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .models.gaot3d import GAOT3D

LIFTING_KEY = "encoder.lifting.fcs.0.weight"  # [C, in] (or [C, in, 1])
HEAD_KEY = "decoder.projection.fcs.1.weight"  # [out, projection] (or [out, projection, 1])
_DEAD_SKIP = re.compile(r"processor\.decoder_layers\.\d+\.skip_proj\.(weight|bias)")
_DEAD_RECOVERY = re.compile(r"encoder\.recovery\.fcs\.0\.(weight|bias)")


def _check_latent_tokens(model: GAOT3D, tokens) -> None:
    want = model.grid.positions().numpy()
    if np.shape(tokens) != want.shape or not np.allclose(tokens, want, atol=1e-6):
        raise ValueError("latent_tokens buffer does not match the model's latent grid")


def load_numpy_state_dict(model: GAOT3D, state: Mapping[str, np.ndarray]) -> GAOT3D:
    """Copy a {reference key: np.ndarray} state dict into `model` (strict).

    The optional `latent_tokens` buffer of the reference is checked against
    the model's latent grid and not stored: the port computes cell
    coordinates from the grid itself."""
    state = dict(state)
    tokens = state.pop("latent_tokens", None)
    if tokens is not None:
        _check_latent_tokens(model, tokens)
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


def strip_ddp_prefix(sd: Mapping[str, object]) -> Dict[str, object]:
    """The state dict without DistributedDataParallel's `module.` key prefix
    (gaot3d_tpu/torch_import.py `params_from_torch_state_dict`)."""
    return {k.removeprefix("module."): v for k, v in sd.items()}


def io_channels(sd: Mapping[str, object]) -> Tuple[int, int]:
    """(input_size, output_size) of the model a reference-keyed state dict
    belongs to: the lifting's input width and the head's output width."""
    return int(sd[LIFTING_KEY].shape[1]), int(sd[HEAD_KEY].shape[0])


def state_dict_from_reference(sd: Mapping[str, object], model: GAOT3D) -> Dict[str, np.ndarray]:
    """A reference GAOT-3D `state_dict()` (torch tensors or arrays, with or
    without DDP's `module.` prefix) as the {key: np.ndarray} that
    `load_numpy_state_dict` loads into `model`.

    Its `latent_tokens` buffer is checked against the model's grid and
    dropped. So are the keys gaot3d_tpu/torch_import.py drops because the
    reference builds those modules and never applies them: with
    `use_long_range_skip: false`, every decoder block's `skip_proj`; with
    `use_gno: false`, the encoder's `recovery`. Any
    other key the model lacks, and any key of the model the dict lacks, is a
    ValueError. Conv1d weights [out, in, 1] (`mlp_type: channel`) are kept as
    they are: the port's ChannelMLP holds that layout."""
    out = {}
    for key, value in strip_ddp_prefix(sd).items():
        out[key] = np.asarray(value.detach().cpu().numpy() if hasattr(value, "detach") else value)
    tokens = out.pop("latent_tokens", None)
    if tokens is not None:
        _check_latent_tokens(model, tokens)
    if not model.attn_config.use_long_range_skip:
        out = {k: v for k, v in out.items() if not _DEAD_SKIP.fullmatch(k)}
    if not model.magno_config.use_gno:
        out = {k: v for k, v in out.items() if not _DEAD_RECOVERY.fullmatch(k)}
    want = set(model.state_dict())
    extra, missing = sorted(set(out) - want), sorted(want - set(out))
    if extra or missing:
        raise ValueError(f"the checkpoint does not fit the model: keys the model lacks {extra}, "
                         f"keys the checkpoint lacks {missing}")
    return out


def latent_tokens_buffer(latent_tokens, coord_dim: int = 3) -> np.ndarray:
    """The reference's `latent_tokens` state-dict buffer as
    gaot3d_tpu/torch_export.py `_latent_tokens_buffer` builds it: a linspace
    over (-1, 1) on each axis, meshgrid 'ij', [-1, coord_dim]; whatever the
    model's grid `lo` and `hi`."""
    axes = [np.linspace(-1, 1, d, dtype=np.float32) for d in latent_tokens]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack(mesh, axis=-1).reshape(-1, coord_dim)


def reference_state_dict(model: GAOT3D) -> Dict[str, np.ndarray]:
    """The model's weights as the reference's `model.state_dict()`: its
    parameters under their (reference) keys and the `latent_tokens` buffer,
    as gaot3d_tpu/torch_export.py `state_dict_from_params(...,
    latent_tokens=...)` writes them."""
    out = {"latent_tokens": latent_tokens_buffer(model.latent_tokens,
                                                 model.magno_config.gno_coord_dim)}
    out.update(numpy_state_dict(model))
    return out
