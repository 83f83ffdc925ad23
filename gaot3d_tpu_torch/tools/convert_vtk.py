"""VTK/mesh -> sample-store converter (the port's twin of tools/convert_vtk.py).

Reads surface meshes (.vtk/.vtp/.vtu/.stl/.obj/...) through meshio or pyvista
where one is installed, and legacy ASCII .vtk through the built-in reader
without either; takes the point coordinates and the chosen point-data
fields, and writes one .npz sample per mesh plus the order file the dataset
loader expects.

    python -m gaot3d_tpu_torch.tools.convert_vtk --input DIR --output DIR \
        --fields pressure [wallShearStress ...] [--folder-name processed] [--limit N]
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Optional, Sequence

import numpy as np

from ..data.dataset import save_sample

logger = logging.getLogger("convert_vtk")

MESH_EXTS = (".vtk", ".vtp", ".vtu", ".stl", ".obj", ".ply", ".off")


def read_legacy_vtk(path: str):
    """Reader for legacy ASCII VTK (what OpenFOAM's foamToVTK and DrivAerNet's
    published surface meshes use): POINTS and POINT_DATA with SCALARS,
    VECTORS / NORMALS and FIELD arrays. Binary or XML VTK needs meshio or
    pyvista."""
    with open(path, "r", errors="strict") as f:
        tokens = f.read().split()
    i, n_pts = 0, None
    points = None
    fields = {}
    in_point_data = False

    def take_floats(count):
        nonlocal i
        vals = np.asarray(tokens[i:i + count], dtype=np.float32)
        if vals.size != count:
            raise ValueError(f"{path}: truncated data block")
        i += count
        return vals

    while i < len(tokens):
        t = tokens[i].upper()
        if t == "ASCII":
            i += 1
        elif t == "BINARY":
            raise ValueError(f"{path}: binary legacy VTK needs meshio/pyvista")
        elif t == "POINTS":
            n_pts = int(tokens[i + 1])
            i += 3  # POINTS n dtype
            points = take_floats(n_pts * 3).reshape(n_pts, 3)
        elif t == "POINT_DATA":
            if int(tokens[i + 1]) != n_pts:
                raise ValueError(f"{path}: POINT_DATA size != POINTS size")
            in_point_data = True
            i += 2
        elif t == "CELL_DATA":
            in_point_data = False
            i += 2
        elif in_point_data and t == "SCALARS":
            name = tokens[i + 1]
            ncomp = 1
            j = i + 3  # SCALARS name dtype [numComp]; numComp is optional
            if j < len(tokens) and tokens[j].isdigit():
                ncomp = int(tokens[j])
                j += 1
            if j < len(tokens) and tokens[j].upper() == "LOOKUP_TABLE":
                j += 2
            i = j
            v = take_floats(n_pts * ncomp)
            fields[name] = v if ncomp == 1 else v.reshape(n_pts, ncomp)
        elif in_point_data and t in ("VECTORS", "NORMALS"):
            name = tokens[i + 1]
            i += 3
            fields[name] = take_floats(n_pts * 3).reshape(n_pts, 3)
        elif in_point_data and t == "FIELD":
            n_arrays = int(tokens[i + 2])
            i += 3
            for _ in range(n_arrays):
                name, ncomp, ntup = tokens[i], int(tokens[i + 1]), int(tokens[i + 2])
                i += 4  # name numComp numTuples dtype
                v = take_floats(ntup * ncomp)
                fields[name] = v if ncomp == 1 else v.reshape(ntup, ncomp)
        else:
            i += 1
    if points is None:
        raise ValueError(f"{path}: no POINTS section found")
    return points, fields


def read_mesh(path: str):
    """(points [N, 3], {field: [N, ...]}). Tries meshio, then the built-in
    legacy-ASCII reader for .vtk, then pyvista; each imported when tried."""
    try:
        import meshio

        mesh = meshio.read(path)
        return np.asarray(mesh.points, np.float32), {
            k: np.asarray(v) for k, v in mesh.point_data.items()}
    except ImportError:
        pass
    if path.lower().endswith(".vtk"):
        try:
            return read_legacy_vtk(path)
        except ValueError:
            pass  # binary or exotic legacy file: pyvista may read it
    try:
        import pyvista as pv

        mesh = pv.read(path)
        return np.asarray(mesh.points, np.float32), {
            k: np.asarray(mesh.point_data[k]) for k in mesh.point_data.keys()}
    except ImportError as e:
        raise RuntimeError(
            "neither meshio nor pyvista is available (and the file is not legacy ASCII "
            ".vtk); install one to convert this mesh, or preprocess to .npz/.pt "
            "externally") from e


def convert(input_dir: str, output_dir: str, fields, folder_name: str, limit=None) -> None:
    """Convert every mesh under `input_dir` (sorted, at most `limit`) into
    `output_dir/folder_name/<name>.npz` with `pos` and `x` (the `fields`
    stacked as columns) and write `output_dir/order_<folder_name>.txt`. A
    mesh that fails is logged and left out."""
    files = sorted(
        f for f in glob.glob(os.path.join(input_dir, "**", "*"), recursive=True)
        if f.lower().endswith(MESH_EXTS))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no mesh files under {input_dir}")
    processed = os.path.join(output_dir, folder_name)
    os.makedirs(processed, exist_ok=True)
    names = []
    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            points, data = read_mesh(path)
            cols = []
            for f in fields:
                if f not in data:
                    raise KeyError(f"field '{f}' not in {path} (has: {list(data)})")
                v = data[f].astype(np.float32)
                cols.append(v[:, None] if v.ndim == 1 else v)
            x = np.concatenate(cols, axis=-1)
            save_sample(os.path.join(processed, name + ".npz"), {"pos": points, "x": x})
            names.append(name)
            logger.info("converted %s: %d points, x %s", name, len(points), x.shape)
        except Exception as e:  # one bad mesh must not stop the batch: logged, left out
            logger.error("failed to convert %s: %s", path, e)
    order_file = os.path.join(output_dir, f"order_{folder_name}.txt")
    with open(order_file, "w") as f:
        f.write("\n".join(names) + "\n")
    logger.info("wrote %d samples + %s", len(names), order_file)


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--fields", nargs="+", required=True,
                    help="point-data field names to stack into x (e.g. pressure)")
    ap.add_argument("--folder-name", default="processed")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    convert(args.input, args.output, args.fields, args.folder_name, args.limit)


if __name__ == "__main__":
    main()
