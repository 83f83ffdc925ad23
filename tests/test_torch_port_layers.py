"""The port's import graph points one way (README, "The port's layers").

Every module of gaot3d_tpu_torch/ is parsed, function-local imports
included, and each module it imports from the package is held to the layer
order: a module may import from a lower layer, or from its own layer's
group, and nothing else.

    0  edges, tracing, metadata, utils/*, kernels/build (and the package root)
    1  kernels/*
    2  ops/*
    3  parallel/*
    4  models/* | data/*   (two groups: neither imports the other)
    5  train/*, serve, weights, config, cli, __main__, tools/*

The edge formats and the rules every layer agrees on sit at the bottom, so
a kernel's plain version, the data feed and the sharding need nothing from
the layers above them.
"""
import ast
import pathlib

import pytest

PACKAGE = "gaot3d_tpu_torch"
ROOT = pathlib.Path(__file__).resolve().parent.parent / PACKAGE

# (module or package prefix, layer, group); the first match wins
LAYERS = (
    ("kernels.build", 0, "base"),
    ("edges", 0, "base"),
    ("tracing", 0, "base"),
    ("metadata", 0, "base"),
    ("utils", 0, "base"),
    ("kernels", 1, "kernels"),
    ("ops", 2, "ops"),
    ("parallel", 3, "parallel"),
    ("models", 4, "models"),
    ("data", 4, "data"),
    ("train", 5, "entry"),
    ("serve", 5, "entry"),
    ("weights", 5, "entry"),
    ("config", 5, "entry"),
    ("cli", 5, "entry"),
    ("__main__", 5, "entry"),
    ("tools", 5, "entry"),
    ("", 0, "base"),  # the package's own __init__
)


def _name(path: pathlib.Path) -> str:
    """The dotted name inside the package: 'ops.grid_graph', 'kernels' for
    kernels/__init__.py, '' for the package's own __init__.py."""
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


MODULES = {_name(p): p for p in sorted(ROOT.rglob("*.py"))}


def _place(name: str):
    for prefix, layer, group in LAYERS:
        if name == prefix or name.startswith(prefix + "."):
            return layer, group
    raise AssertionError(name)


def _imports(name: str, path: pathlib.Path):
    """(line, imported module) for every import of the package in the
    module, at any depth, as names inside the package."""
    package = name.split(".") if path.name == "__init__.py" else name.split(".")[:-1]
    package = [p for p in package if p]
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == PACKAGE or alias.name.startswith(PACKAGE + "."):
                    yield node.lineno, alias.name[len(PACKAGE) + 1:]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - (node.level - 1)] + \
                    (node.module.split(".") if node.module else [])
            elif node.module == PACKAGE or node.module.startswith(PACKAGE + "."):
                base = node.module.split(".")[1:]
            else:
                continue
            for alias in node.names:
                sub = ".".join(base + [alias.name])
                # `from pkg import mod` imports the module pkg.mod
                yield node.lineno, sub if sub in MODULES else ".".join(base)


def test_every_module_has_a_layer():
    assert len(MODULES) > 50
    for name in MODULES:
        _place(name)


@pytest.mark.parametrize("name", sorted(MODULES), ids=lambda n: n or PACKAGE)
def test_module_imports_point_down(name):
    layer, group = _place(name)
    wrong = []
    for line, target in _imports(name, MODULES[name]):
        assert target in MODULES, f"{name}:{line} imports {target}, not a module of the package"
        t_layer, t_group = _place(target)
        if not (t_layer < layer or t_group == group):
            wrong.append(f"line {line}: {target} (layer {t_layer}, {t_group})")
    assert not wrong, (f"{name} (layer {layer}, {group}) imports from above or across its "
                       f"layer: " + "; ".join(wrong))
