"""Result rendering (port of gaot3d_tpu/train/plotting.py; reference:
src/trainer/utils/plot.py, src/utils/viz.py). matplotlib is imported inside
the calls, so the package does not need it to import; the optional PyVista
render of the JAX package is not carried over (nothing calls it).

4-panel 3D scatter: input geometry / ground truth / prediction / absolute
difference (plot.py:120-204 plot_3d_comparison_matplotlib), and the loss
curves.
"""
from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None (with one warning for the
    process) when matplotlib is not installed: the callers then skip their
    PNG, the `.npz` files beside it are written regardless."""
    global _warned
    try:
        import matplotlib
    except ImportError:
        if not _warned:
            logger.warning("matplotlib is not installed: PNG plots are skipped")
            _warned = True
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


_warned = False


def plot_loss_curves(result: dict, path: str) -> None:
    """Train and validation loss over the epochs, log scale, as a PNG."""
    plt = _pyplot()
    if plt is None:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(result["train"]["epoch"], result["train"]["loss"], label="train")
    ax.plot(result["valid"]["epoch"], result["valid"]["loss"], label="valid")
    ax.set_xlabel("epoch")
    ax.set_ylabel("MSE loss")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_3d_comparison(
    coords: np.ndarray,
    u_gtr: np.ndarray,
    u_prd: np.ndarray,
    save_path: str,
    variable_name: str = "u",
    point_size: float = 2.0,
    view_angle=(25, -135),
    hide_grid: bool = True,
    show_diff: bool = True,
    max_points: int = 50000,
) -> None:
    plt = _pyplot()
    if plt is None:
        return
    coords = np.asarray(coords)
    u_gtr = np.asarray(u_gtr).reshape(-1)
    u_prd = np.asarray(u_prd).reshape(-1)
    if coords.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(coords.shape[0], max_points, replace=False)
        coords, u_gtr, u_prd = coords[sel], u_gtr[sel], u_prd[sel]

    vmin = min(u_gtr.min(), u_prd.min())
    vmax = max(u_gtr.max(), u_prd.max())
    npanels = 4 if show_diff else 3
    fig = plt.figure(figsize=(4 * npanels, 4.2))
    panels = [
        ("input geometry", None, None, None),
        (f"ground truth {variable_name}", u_gtr, vmin, vmax),
        (f"prediction {variable_name}", u_prd, vmin, vmax),
    ]
    if show_diff:
        diff = np.abs(u_gtr - u_prd)
        panels.append(("abs error", diff, 0.0, diff.max() if diff.size else 1.0))

    for i, (title, vals, lo, hi) in enumerate(panels):
        ax = fig.add_subplot(1, npanels, i + 1, projection="3d")
        if vals is None:
            ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], s=point_size, c="gray")
        else:
            sc = ax.scatter(
                coords[:, 0], coords[:, 1], coords[:, 2],
                s=point_size, c=vals, cmap="jet", vmin=lo, vmax=hi,
            )
            fig.colorbar(sc, ax=ax, shrink=0.6)
        ax.set_title(title)
        ax.view_init(*view_angle)
        if hide_grid:
            ax.set_axis_off()
        ax.set_box_aspect(
            (np.ptp(coords[:, 0]) or 1, np.ptp(coords[:, 1]) or 1, np.ptp(coords[:, 2]) or 1)
        )
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    logger.info("Saved 3D comparison plot to %s", save_path)
