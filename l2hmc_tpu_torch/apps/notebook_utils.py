"""Notebook helpers (counterpart of ``l2hmc_tpu/apps/notebook_utils.py``):
the image grid. ``plot_line`` and ``get_hmc_samples`` are not ported yet."""

from __future__ import annotations

import numpy as np


def plot_grid(images: np.ndarray, n: int = 8, shape=(28, 28), path=None):
    """n x n grid of images; saved to ``path`` when given, else shown."""
    import matplotlib

    if path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)[: n * n].reshape(-1, *shape)
    k = int(np.ceil(np.sqrt(images.shape[0])))
    fig, axes = plt.subplots(k, k, figsize=(k, k))
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        if i < images.shape[0]:
            ax.imshow(images[i], cmap="gray")
        ax.axis("off")
    if path:
        fig.savefig(path)
        plt.close(fig)
    else:
        plt.show()
    return fig
