"""Checkpoints of the port (port of gaot3d_tpu/train/checkpoint.py), and
parameters across the two packages.

The port's own format is one `torch.save` file holding `{"params":
model.state_dict(), "opt_state": optimizer state, "step": steps taken,
...extra}`, written to a temporary name and renamed into place.

Parameters cross to and from the JAX package through its `.msgpack`
checkpoints: `load_msgpack_params` reads one that the JAX trainer wrote,
`save_msgpack_params` writes one that gaot3d_tpu/train/checkpoint.py
`load_params_only` reads. Both go through `tree_path`, this package's copy of
the rules that tie the JAX parameter tree to the reference state-dict keys the
port's modules are named by (gaot3d_tpu/torch_export.py
`state_dict_from_params` and its inverse in gaot3d_tpu/torch_import.py), for
the configurations the port builds: fused encoder, GNO-only decoder, one
scale. The optimizer's state crosses in neither direction: optax and
torch.optim keep different trees, so a run resumed in the other package
starts its moments and its schedule anew. `msgpack` is imported inside the
two calls; nothing else here needs it.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.gaot3d import GAOT3D
from ..weights import (HEAD_KEY, LIFTING_KEY, io_channels, load_numpy_state_dict,
                       numpy_state_dict)

_NDARRAY_EXT = 1  # flax.serialization's msgpack extension types
_NPSCALAR_EXT = 3


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=False)


def load_params_only(path: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    """Just the model's state dict from a full checkpoint (extra state is
    tolerated, as in the reference's load)."""
    state = load_checkpoint(path, map_location)
    return state["params"] if "params" in state else state


def tree_path(key: str, model: Optional[GAOT3D] = None) -> Tuple[str, ...]:
    """The path in the JAX parameter tree of the port's state-dict entry `key`.
    flax numbers sibling modules of one class in construction order, which is
    what the counters below reproduce; `model` is read for the processor's
    keys only."""
    parts = key.split(".")
    leaf = parts[-1]  # 'weight' | 'bias'
    dense = ("Dense_0", "kernel" if leaf == "weight" else "bias")
    top = parts[0]
    if top == "patch_linear":
        return ("patch_linear",) + dense
    if top == "encoder":
        if parts[1] == "lifting":
            return ("encoder", "TorchLinear_0") + dense
        if parts[1] == "recovery":
            return ("encoder", "TorchLinear_1") + dense
        if parts[1] == "gno":  # encoder.gno.channel_mlp.fcs.{i}
            return ("encoder", "FusedEncoderScale_0", f"kernel_{leaf[0]}{parts[4]}")
        if parts[1] == "geoembed":  # encoder.geoembed.mlp.{0,2}
            return ("encoder", "FusedEncoderScale_0", f"geo_{leaf[0]}{int(parts[3]) // 2}")
    if top == "decoder":
        if parts[1] == "gno":
            return ("decoder", "IntegralTransform_0", f"kernel_{leaf[0]}{parts[4]}")
        if parts[1] == "projection":  # decoder.projection.fcs.{0,1}
            return ("decoder", f"TorchLinear_{parts[3]}") + dense
    if top == "processor":
        proc = model.processor
        if parts[1] == "input_proj":
            return ("processor", "TorchLinear_0") + dense
        if parts[1] == "output_proj":
            return ("processor", f"TorchLinear_{int(proc.input_proj is not None)}") + dense
        n_enc = len(proc.encoder_layers)
        if parts[1] == "encoder_layers":
            block, rest = int(parts[2]), parts[3:]
        elif parts[1] == "middle_layer":
            block, rest = n_enc, parts[2:]
        elif parts[1] == "decoder_layers":
            block = n_enc + int(proc.middle_layer is not None) + int(parts[2])
            rest = parts[3:]
        else:
            raise KeyError(f"no JAX counterpart known for {key}")
        base = ("processor", f"TransformerBlock_{block}")
        cfg = model.attn_config
        if rest[0] == "attn_norm":
            return base + ("RMSNorm_0", "weight")
        if rest[0] == "ffn_norm":
            return base + (f"RMSNorm_{int(bool(cfg.use_attn_norm))}", "weight")
        if rest[0] == "attn":
            i = ("q_proj", "k_proj", "v_proj", "o_proj").index(rest[1])
            return base + ("GroupQueryAttention_0", f"TorchLinear_{i}") + dense
        if rest[0] == "ffn":
            i = ("w1", "w3", "w2").index(rest[1])
            return base + ("FFN_0", f"TorchLinear_{i}") + dense
        if rest[0] == "skip_proj":
            return base + ("TorchLinear_0",) + dense
    raise KeyError(f"no JAX counterpart known for {key}")


def _is_matrix(key: str, path: Tuple[str, ...]) -> bool:
    """Whether the entry is a dense layer's weight: [out, in] here (or
    [out, in, 1] under `mlp_type: channel`), [in, out] in the JAX tree."""
    return key.endswith(".weight") and path[-1] != "weight"


def params_tree(model: GAOT3D) -> Dict[str, Any]:
    """The model's parameters as the JAX variables dict `{"params": tree}`
    of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in numpy_state_dict(model).items():
        path = tree_path(key, model)
        if _is_matrix(key, path):
            value = (value[..., 0] if value.ndim == 3 else value).T
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return {"params": tree}


def state_dict_from_tree(variables: Dict[str, Any], model: GAOT3D) -> Dict[str, np.ndarray]:
    """A JAX variables dict (`{"params": tree}` or the tree itself) as the
    port's {key: np.ndarray}, every entry in the shape the model holds."""
    tree = variables
    while "params" in tree and "encoder" not in tree:
        tree = tree["params"]
    out = {}
    for key, param in model.state_dict().items():
        path = tree_path(key, model)
        node = tree
        for name in path:
            if name not in node:
                raise KeyError(f"the checkpoint has no {'/'.join(path)} (for {key})")
            node = node[name]
        value = np.asarray(node)
        if _is_matrix(key, path):
            value = value.T
        out[key] = np.ascontiguousarray(value).reshape(tuple(param.shape))
    return out


def read_msgpack(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays a JAX `.msgpack` checkpoint holds."""
    import msgpack

    def ext_hook(code, data):
        if code in (_NDARRAY_EXT, _NPSCALAR_EXT):
            shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
            arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)
            return arr[()] if code == _NPSCALAR_EXT else arr
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def load_msgpack_params(path: str, model: GAOT3D) -> GAOT3D:
    """Load the parameters of a JAX trainer's `.msgpack` checkpoint (or of a
    bare msgpack variables dict) into `model`. Optimizer state and step count
    in the file are not read."""
    return load_numpy_state_dict(model, state_dict_from_tree(read_msgpack(path), model))


def load_trained_params(path: str, model: GAOT3D, map_location="cpu") -> GAOT3D:
    """Load a trained run's parameters into `model` (strict): from a JAX
    `.msgpack` checkpoint, or from the port's checkpoint or state dict."""
    if path.endswith(".msgpack"):
        return load_msgpack_params(path, model)
    model.load_state_dict(load_params_only(path, map_location))
    return model


def checkpoint_channels(path: str) -> Tuple[int, int]:
    """(input_size, output_size) of the model whose parameters `path` holds
    (a JAX `.msgpack` checkpoint, or the port's): the lifting's input width
    and the head's output width."""
    if not path.endswith(".msgpack"):
        return io_channels(load_params_only(path))
    node = read_msgpack(path)
    while "params" in node and "encoder" not in node:
        node = node["params"]
    width = []
    for key, axis in ((LIFTING_KEY, 0), (HEAD_KEY, 1)):  # [in, out] in the JAX tree
        leaf = node
        for name in tree_path(key):
            leaf = leaf[name]
        width.append(int(np.shape(leaf)[axis]))
    return width[0], width[1]


def save_msgpack_params(path: str, model: GAOT3D) -> None:
    """Write `{"params": variables}` in the JAX package's msgpack format, so
    that its `load_params_only` restores the model's parameters from it."""
    import msgpack

    def default(x):
        if isinstance(x, np.ndarray):
            packed = msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True)
            return msgpack.ExtType(_NDARRAY_EXT, packed)
        raise TypeError(f"cannot pack {type(x)}")

    blob = msgpack.packb({"params": params_tree(model)}, default=default, strict_types=True)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
