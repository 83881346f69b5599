"""Programmable-mask (SLM) modeling — DigiCam's Adafruit LCD (port of
lenslesspicam_tpu/hardware/slm.py; reference: lensless/hardware/slm.py).

The differentiable pipeline that turns programmable-cell values into a
full-sensor mask and a simulated PSF (slm.py:126-273
get_programmable_mask, slm.py:316-408 get_intensity_psf), plus the
sub-pattern layout converters (slm.py:276-313).  The SSH
device-programming path (set_programmable_mask, slm.py:45-123) is
host-side and gated on paramiko (hardware/remote.py).

Cell placement indices (deadspace-aware) are precomputed in numpy at build
time; the value scatter is one ``scatter_reduce`` (the maximum, as the JAX
package's ``.at[].max``), keeping the mask -> PSF chain differentiable for
mask learning.  The mask lies on the device of the cell values.

Device data: Adafruit 1.8" TFT LCD (ST7735R) geometry from the DigiCam
paper (128 x 160 cells, 0.18 mm pitch, RGB stripe subcells of
0.06 x 0.18 mm).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# SLM device table (waveprop.devices analog)
slm_dict = {
    "adafruit": {
        "size": np.array([128 * 0.18e-3, 160 * 0.18e-3]),
        "resolution": np.array([128 * 3, 160]),  # RGB subcells stacked vertically
        "pitch": np.array([0.06e-3, 0.18e-3]),
        "cell_size": np.array([0.06e-3, 0.18e-3]),
        # rows cycle through R, G, B stripes
        "color_filter": np.array([[[1.0, 0, 0]], [[0, 1.0, 0]], [[0, 0, 1.0]]]),
    },
}


class SLMLayout(NamedTuple):
    """Static cell-placement geometry on the sensor grid."""

    rows: np.ndarray  # (n_cells, cell_h, cell_w) int
    cols: np.ndarray
    color_weights: np.ndarray  # (n_cells, 3) float
    sensor_shape: tuple


def get_centers(n_cells, pitch):
    """Cell centers on a regular grid about the origin (waveprop
    get_centers analog)."""
    ny, nx = n_cells
    cy = (np.arange(ny) - (ny - 1) / 2.0) * pitch[0]
    cx = (np.arange(nx) - (nx - 1) / 2.0) * pitch[1]
    yy, xx = np.meshgrid(cy, cx, indexing="ij")
    return np.stack([yy.ravel(), xx.ravel()], axis=1)


def build_layout(n_active, sensor, slm_param=None, deadspace=True) -> SLMLayout:
    """Precompute scatter indices for cell placement (slm.py:186-213)."""
    if slm_param is None:
        slm_param = slm_dict["adafruit"]
    pitch = slm_param["pitch"]
    cell_size = slm_param["cell_size"] if deadspace else pitch
    d1 = np.asarray(sensor.pitch)
    res = np.asarray(sensor.resolution)
    color_filter = np.asarray(slm_param["color_filter"])
    n_color = color_filter.shape[0]

    centers = get_centers(n_active, pitch)
    ch, cw = np.maximum((cell_size / d1).astype(int), 1)

    rows = np.zeros((len(centers), ch, cw), np.int32)
    cols = np.zeros((len(centers), ch, cw), np.int32)
    cweights = np.zeros((len(centers), 3), np.float32)
    for i, center in enumerate(centers):
        cpix = (center / d1 + res / 2).astype(int)
        top = int(cpix[0] - ch // 2)
        left = int(cpix[1] + 1 - cw // 2)
        r = np.clip(np.arange(top, top + ch), 0, res[0] - 1)
        c = np.clip(np.arange(left, left + cw), 0, res[1] - 1)
        rows[i] = r[:, None]
        cols[i] = c[None, :]
        cf_idx = (i // n_active[1]) % n_color
        cweights[i] = color_filter[cf_idx][0]
    return SLMLayout(rows, cols, cweights, tuple(int(v) for v in res))


def get_programmable_mask(vals: torch.Tensor, layout: SLMLayout,
                          color_filter=None, flipud: bool = False) -> torch.Tensor:
    """Differentiable cell-values -> full-sensor RGB mask
    (slm.py:126-273).  Returns (3, H, W) on the device of ``vals``."""
    flat = vals.reshape(-1)
    # per-cell (n_cells, 3) color weights; pass color_filter to override
    # (e.g. a learnable filter, trainable_mask.py:168-190)
    weights = torch.as_tensor(
        layout.color_weights if color_filter is None else color_filter,
        dtype=vals.dtype, device=vals.device).reshape(flat.shape[0], 3)
    ch, cw = layout.rows.shape[1], layout.rows.shape[2]
    cell_vals = (flat[:, None, None, None] * weights[:, :, None, None]).expand(
        flat.shape[0], 3, ch, cw)
    h, w = layout.sensor_shape
    pix = torch.from_numpy((layout.rows * w + layout.cols).astype(np.int64)).to(vals.device)
    index = pix[:, None].expand(cell_vals.shape).movedim(1, 0).reshape(3, -1)
    mask = torch.zeros((3, h * w), dtype=vals.dtype, device=vals.device).scatter_reduce(
        1, index, cell_vals.movedim(1, 0).reshape(3, -1), reduce="amax")
    mask = mask.reshape(3, h, w)
    if flipud:
        mask = torch.flip(mask, dims=(1,))
    return mask


def get_intensity_psf(mask: torch.Tensor, sensor, scene2mask: float,
                      mask2sensor: float,
                      wavelengths=(460e-9, 550e-9, 640e-9)) -> torch.Tensor:
    """Mask -> intensity PSF: spherical illumination x mask, angular
    spectrum to the sensor, |.|^2 per wavelength (slm.py:316-408).

    mask: (3, H, W) or (H, W); returns (H, W, C) on its device.
    """
    from ..ops.propagation import angular_spectrum, spherical_wavefront

    if mask.ndim == 2:
        mask = mask[None]
    shape = (int(mask.shape[-2]), int(mask.shape[-1]))
    pitch = (float(sensor.pitch[0]), float(sensor.pitch[1]))

    psfs = []
    for i in range(mask.shape[0]):
        wv = wavelengths[min(i, len(wavelengths) - 1)]
        spherical = spherical_wavefront(shape, pitch, wv, scene2mask, device=mask.device)
        u_in = spherical * mask[i]
        u_out = angular_spectrum(u_in.to(torch.complex64), wv, pitch, mask2sensor)
        psfs.append(torch.abs(u_out) ** 2)
    return torch.stack(psfs, dim=-1)


def adafruit_sub2full(subpattern, center):
    """Place a subpattern at a center on the full Adafruit grid
    (slm.py:276-295)."""
    sub = np.asarray(subpattern)
    controllable_shape = (3, sub.shape[0], sub.shape[1])
    pattern = np.zeros((3, 128, 160), dtype=sub.dtype)
    top = center[0] - sub.shape[0] // 2
    left = center[1] - sub.shape[1] // 2
    pattern[:, top : top + sub.shape[0], left : left + sub.shape[1]] = sub[None]
    return pattern


def adafruit_full2subpattern(pattern, shape, center):
    """Extract the controllable subpattern (slm.py:297-313)."""
    pattern = np.asarray(pattern)
    top = center[0] - shape[0] // 2
    left = center[1] - shape[1] // 2
    return pattern[..., top : top + shape[0], left : left + shape[1]]
