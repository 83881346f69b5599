"""Plotting for the reconstruction API's progress display (port of
``plot_image`` from lenslesspicam_tpu/utils/plot.py).

matplotlib is imported inside :func:`plot_image`, so importing this module
needs none.
"""

from __future__ import annotations

import numpy as np

from .._device import as_host
from ..data.image import gamma_correction


def plot_image(img, ax=None, gamma=None, normalize=True):
    """Show a (H, W, C) or (D, H, W, C) image (depths side by side) on
    ``ax`` (a new figure's axes if None) and return the axes.  ``img`` may
    be a tensor on any device or an array."""
    import matplotlib.pyplot as plt

    img = as_host(img)
    if img.ndim == 4:
        img = img[0] if img.shape[0] == 1 else np.concatenate(list(img), axis=1)
    if ax is None:
        _, ax = plt.subplots()
    disp = img.astype(np.float32)
    if normalize and disp.max() > 0:
        disp = disp / disp.max()
    if gamma is not None:
        disp = gamma_correction(disp, gamma)
    if disp.shape[-1] == 1:
        ax.imshow(disp[..., 0], cmap="gray")
    else:
        ax.imshow(np.clip(disp, 0, 1))
    ax.set_xticks([])
    ax.set_yticks([])
    return ax
