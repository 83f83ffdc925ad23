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
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.gaot3d import GAOT3D
from ..weights import (io_channels, load_numpy_state_dict,
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


def _magno_path(key: str, parts, model: GAOT3D) -> Tuple[str, ...]:
    """`tree_path` of an encoder or decoder key: the inverse of
    gaot3d_tpu/torch_export.py `state_dict_from_params` for the model's
    MAGNO config (fused or modular sides, geoembed method, dot-product
    attention, scale weights)."""
    leaf = parts[-1]
    dense = ("Dense_0", "kernel" if leaf == "weight" else "bias")
    top, mod = parts[0], parts[1]
    side = model.encoder if top == "encoder" else model.decoder
    fused = side.use_fused
    scale = f"{'Encoder' if top == 'encoder' else 'Decoder'}Scale_0"
    # flax numbers a side's TorchLinear modules in construction order
    order = []
    if top == "encoder":
        order += ["lifting"] if side.lifting is not None else []
        order += ["recovery"] if side.recovery is not None else []
    else:
        order += ["recovery"] if side.recovery is not None else []
    if getattr(side, "scale_weighting", None) is not None:
        order += ["scale_weighting.2", "scale_weighting.0"]
    if top == "decoder":
        order += ["projection.0", "projection.1"]
    if mod == "gno":
        owner = f"Fused{scale}" if fused else "IntegralTransform_0"
        if parts[2] == "channel_mlp":  # gno.channel_mlp.fcs.{i}
            return (top, owner, f"kernel_{leaf[0]}{parts[4]}")
        proj = {"query_proj": "q", "key_proj": "k"}[parts[2]]
        return (top, owner, f"{proj}_{leaf[0]}")
    if mod == "geoembed":
        if fused:  # geoembed.mlp.{0,2}
            return (top, f"Fused{scale}", f"geo_{leaf[0]}{int(parts[3]) // 2}")
        if parts[2] == "mlp":
            return (top, "GeometricEmbedding_0", f"mlp_{leaf[0]}{int(parts[3]) // 2}")
        if parts[2] == "pointnet_mlp":
            return (top, "GeometricEmbedding_0", f"pn_{leaf[0]}{int(parts[3]) // 2}")
        return (top, "GeometricEmbedding_0", f"fc_{leaf[0]}")  # geoembed.fc.0
    name = {"lifting": "lifting", "recovery": "recovery",
            "scale_weighting": f"scale_weighting.{parts[2]}",
            "projection": f"projection.{parts[3] if len(parts) > 3 else ''}"}.get(mod)
    if name in order:
        return (top, f"TorchLinear_{order.index(name)}") + dense
    raise KeyError(f"no JAX counterpart known for {key}")


def tree_path(key: str, model: GAOT3D) -> Tuple[str, ...]:
    """The path in the JAX parameter tree of the port's state-dict entry `key`.
    flax numbers sibling modules of one class in construction order, which is
    what the counters reproduce; `model` gives the config that decides
    which modules exist."""
    parts = key.split(".")
    leaf = parts[-1]  # 'weight' | 'bias'
    dense = ("Dense_0", "kernel" if leaf == "weight" else "bias")
    top = parts[0]
    if top == "patch_linear":
        return ("patch_linear",) + dense
    if top in ("encoder", "decoder"):
        return _magno_path(key, parts, model)
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
    # the encoder's first TorchLinear is the lifting, the decoder's last the
    # head's second layer; kernels are [in, out] in the JAX tree
    dec = node["decoder"]
    last = max(int(k.rsplit("_", 1)[1]) for k in dec if k.startswith("TorchLinear_"))
    lifting = node["encoder"]["TorchLinear_0"]["Dense_0"]["kernel"]
    head = dec[f"TorchLinear_{last}"]["Dense_0"]["kernel"]
    return int(np.shape(lifting)[0]), int(np.shape(head)[1])


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
