"""2D field animation (port of gaot3d_tpu/utils/viz.py; the reference's
src/utils/viz.py:9-41 anim_row). Host-side matplotlib."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def anim_row(frames_list: Sequence[np.ndarray], titles=None, save_path=None, interval=150):
    """Animate a row of 2D field sequences side by side.

    frames_list: arrays [T, H, W]; returns the matplotlib animation (and
    saves a gif when save_path is given)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    n = len(frames_list)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    if n == 1:
        axes = [axes]
    ims = []
    for i, (ax, frames) in enumerate(zip(axes, frames_list)):
        im = ax.imshow(frames[0], cmap="jet", vmin=frames.min(), vmax=frames.max())
        if titles:
            ax.set_title(titles[i])
        ax.set_axis_off()
        ims.append(im)

    def update(t):
        for im, frames in zip(ims, frames_list):
            im.set_data(frames[t])
        return ims

    anim = FuncAnimation(fig, update, frames=frames_list[0].shape[0], interval=interval,
                         blit=True)
    if save_path:
        anim.save(save_path, writer="pillow")
        plt.close(fig)
    return anim
