"""Typed-config helpers (port of gaot3d_tpu/utils/dataclass_utils.py).

A small dependency-free recursive dataclass merge: user YAML/TOML/JSON dicts
are merged onto dataclass defaults with unknown-key errors and
nested-dataclass recursion. YAML needs PyYAML, which is imported only when a
`.yaml` file is loaded; TOML and JSON need the standard library only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Type, TypeVar, get_args, get_origin, Union

T = TypeVar("T")


def shallow_asdict(obj: Any) -> dict:
    """Non-recursive dataclass -> dict (reference: src/utils/dataclass.py:5-12)."""
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"expected dataclass, got {type(obj)}")
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _is_optional_dataclass(tp) -> Any:
    """If tp is Optional[SomeDataclass] or a dataclass type, return the dataclass."""
    if dataclasses.is_dataclass(tp):
        return tp
    if get_origin(tp) is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1 and dataclasses.is_dataclass(args[0]):
            return args[0]
    return None


def _coerce(value: Any, tp) -> Any:
    """Light type coercion for scalar config fields (e.g. "1e-4" -> float)."""
    if value is None:
        return None
    if get_origin(tp) is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            tp = args[0]
    if tp is float and isinstance(value, (int, str)):
        return float(value)
    if tp is int and isinstance(value, (float, str)):
        iv = int(float(value))
        return iv
    if tp is tuple and isinstance(value, list):
        return tuple(value)
    if get_origin(tp) is tuple and isinstance(value, list):
        return tuple(value)
    return value


def dataclass_from_dict(cls: Type[T], data: dict, path: str = "") -> T:
    """Build `cls` from defaults, overriding with entries of `data` (recursive)."""
    return merge_config(cls(), data, path=path)


def merge_config(default: T, user: Any, path: str = "") -> T:
    """Merge a user dict onto a dataclass instance, returning a new instance.

    Matches the semantics the reference gets from
    ``OmegaConf.merge(OmegaConf.structured(defaults), user_config)``:
    per-field override, recursion into nested dataclasses, unknown keys rejected.
    """
    if user is None:
        return default
    if not dataclasses.is_dataclass(default):
        raise TypeError(f"merge target at '{path}' is not a dataclass: {type(default)}")
    if dataclasses.is_dataclass(user):
        user = shallow_asdict(user)
    if not isinstance(user, dict):
        raise TypeError(f"config override at '{path}' must be a mapping, got {type(user)}")

    fields = {f.name: f for f in dataclasses.fields(default)}
    try:
        import typing

        hints = typing.get_type_hints(type(default))
    except Exception:
        hints = {}
    updates = {}
    for key, value in user.items():
        if key not in fields:
            raise KeyError(f"unknown config key '{path + key}'")
        ftype = hints.get(key, fields[key].type)
        current = getattr(default, key)
        try:
            nested_cls = _is_optional_dataclass(ftype)
        except TypeError:
            nested_cls = None
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = merge_config(current, value, path=f"{path}{key}.")
        elif nested_cls is not None and isinstance(value, dict):
            updates[key] = dataclass_from_dict(nested_cls, value, path=f"{path}{key}.")
        else:
            updates[key] = _coerce(value, ftype)
    return dataclasses.replace(default, **updates)


def load_config_file(filename: str) -> dict:
    """Load a YAML/TOML/JSON config file into a dict (reference: main.py:41-66)."""
    if filename.endswith((".yaml", ".yml")):
        import yaml

        with open(filename) as f:
            return yaml.safe_load(f) or {}
    if filename.endswith(".toml"):
        import tomllib

        with open(filename, "rb") as f:
            return tomllib.load(f)
    if filename.endswith(".json"):
        import json

        with open(filename) as f:
            return json.load(f)
    raise NotImplementedError(f"unsupported config file type: {filename}")
