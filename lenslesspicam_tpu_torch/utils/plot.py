"""Plotting utilities (port of lenslesspicam_tpu/utils/plot.py): 2D/3D-aware
image display with optional gamma (the reconstruction API's progress
display), pixel histograms, cross sections with a -N dB width, 2-D
autocorrelations and training-curve comparison from ``metrics.json``
files.

matplotlib is imported inside each function, so importing this module
needs none.  Images may be tensors on any device or arrays.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np

from .._device import as_host
from ..data.image import autocorr2d, gamma_correction


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


def pixel_histogram(img, ax=None, nbits=None, log_scale=True):
    """Per-channel pixel histogram (100 bins up to 2**nbits - 1, else the
    image's max)."""
    import matplotlib.pyplot as plt

    img = as_host(img, None)
    if ax is None:
        _, ax = plt.subplots()
    max_val = 2**nbits - 1 if nbits else (img.max() or 1)
    if img.ndim == 3 and img.shape[-1] == 3:
        for i, color in enumerate("rgb"):
            ax.hist(img[..., i].ravel(), bins=100, range=(0, max_val),
                    color=color, alpha=0.5)
    else:
        ax.hist(img.ravel(), bins=100, range=(0, max_val), color="gray")
    if log_scale:
        ax.set_yscale("log")
    return ax


def plot_cross_section(img, row=None, ax=None, log_scale=True,
                       plot_db_drop=None, min_val=1e-4, max_val=None,
                       plot_width=None, **kwargs):
    """Horizontal cross section, by default through the row of the global
    maximum (a PSF's peak); with ``plot_db_drop`` the symmetric -N dB width
    about the peak is estimated, marked with dashed lines and printed.
    Returns ``(ax, cross_section)``."""
    import matplotlib.pyplot as plt

    img = as_host(img, np.float32)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    if row is None:
        row = int(np.unravel_index(np.argmax(img), img.shape)[0])
    if ax is None:
        _, ax = plt.subplots()
    vals = img[row].astype(np.float32)
    if max_val is None:
        max_val = vals.max() or 1.0
    vals = vals / max_val
    floor = max(min_val, float(vals.min()))
    if log_scale:
        vals = 10 * np.log10(np.maximum(vals, floor))
        floor = 10 * np.log10(floor)
        ax.set_ylabel("dB")
    x_vals = np.arange(len(vals)) - int(np.argmax(vals))
    ax.plot(x_vals, vals, **kwargs)
    if log_scale:
        ax.set_ylim([floor, 0])
    if plot_width is not None:
        half_width = plot_width // 2 + 1
        ax.set_xlim([-half_width, half_width])
    ax.grid()
    ax.set_title("Cross-section")
    if log_scale and plot_db_drop:
        rel = vals - np.max(vals)
        zero_crossings = np.where(np.diff(np.signbit(rel + plot_db_drop)))[0]
        if len(zero_crossings) >= 2:
            zero_crossings -= int(np.argmax(rel))
            first = np.abs(zero_crossings[np.argmin(np.abs(zero_crossings))])
            width = 2 * int(np.abs(first))
            ax.axvline(x=-first, c="k", linestyle="--")
            ax.axvline(x=+first, c="k", linestyle="--")
            print(f"-{plot_db_drop}dB width = {width} pixels")
            ax.set_xlabel(f"-{plot_db_drop}dB width = {width}")
        else:
            warnings.warn(
                f"Width could not be determined; did not detect two "
                f"-{plot_db_drop}dB points: {zero_crossings}")
    return ax, vals


def plot_autocorr2d(vals, ax=None):
    """2-D autocorrelation (channels averaged first); returns ``(ax,
    autocorr)``."""
    import matplotlib.pyplot as plt

    vals = as_host(vals, None)
    if vals.ndim == 3:
        vals = vals.mean(axis=-1)
    autocorr = autocorr2d(vals)
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(autocorr, cmap="gray")
    ax.set_xticks([])
    ax.set_yticks([])
    return ax, autocorr


def plot_autocorr_rgb(img, ax=None):
    """The autocorrelation of each channel of an RGB image."""
    import matplotlib.pyplot as plt

    img = as_host(img, None)
    assert img.ndim == 3 and img.shape[-1] == 3
    if ax is None:
        _, ax = plt.subplots(1, 3, figsize=(12, 4))
    for i in range(3):
        plot_autocorr2d(img[..., i], ax=ax[i])
        ax[i].set_title("RGB"[i])
    return ax


def compare_models(model_paths, metric="PSNR", ax=None, labels=None):
    """Training curves of ``metric`` read from each run's ``metrics.json``
    (a folder holding one, or the file)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    for i, path in enumerate(model_paths):
        fp = os.path.join(path, "metrics.json") if os.path.isdir(path) else path
        with open(fp) as f:
            metrics = json.load(f)
        epochs, vals = [], []
        for epoch, entry in sorted(metrics.items(), key=lambda kv: int(kv[0])):
            ev = entry.get("eval", entry)
            if metric in ev:
                epochs.append(int(epoch))
                vals.append(ev[metric])
        label = labels[i] if labels else os.path.basename(os.path.normpath(path))
        ax.plot(epochs, vals, marker="o", label=label)
    ax.set_xlabel("epoch")
    ax.set_ylabel(metric)
    ax.legend()
    return ax
