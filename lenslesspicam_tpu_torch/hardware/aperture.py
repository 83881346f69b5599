"""Apertures on a virtual SLM grid (port of
lenslesspicam_tpu/hardware/aperture.py, numpy host code copied; reference:
lensless/hardware/aperture.py).

``Aperture`` models an RGB-valued virtual SLM with physical-unit
addressing; ``rect/line/square/circ_aperture`` build the standard
aperture shapes (aperture.py:26-280).
"""

from __future__ import annotations

from enum import Enum

import numpy as np


class ApertureOptions(Enum):
    RECT = "rect"
    SQUARE = "square"
    LINE = "line"
    CIRC = "circ"

    @staticmethod
    def values():
        return [a.value for a in ApertureOptions]


class Aperture:
    """Virtual SLM with (3, H, W) uint8 values and physical-coordinate
    addressing (aperture.py:26-101)."""

    def __init__(self, shape, pixel_pitch):
        assert np.all(np.asarray(shape) > 0)
        assert np.all(np.asarray(pixel_pitch) > 0)
        self._shape = tuple(shape)
        self._pixel_pitch = tuple(pixel_pitch)
        self._values = np.zeros((3,) + self._shape, dtype=np.uint8)

    @property
    def size(self):
        return int(np.prod(self._shape))

    @property
    def shape(self):
        return self._shape

    @property
    def pixel_pitch(self):
        return self._pixel_pitch

    @property
    def dim(self):
        """Physical dimensions (m)."""
        return np.array(self._shape) * np.array(self._pixel_pitch)

    @property
    def height(self):
        return self.dim[0]

    @property
    def width(self):
        return self.dim[1]

    @property
    def center(self):
        return np.array([self.height / 2, self.width / 2])

    @property
    def values(self):
        return self._values

    @property
    def grayscale_values(self):
        return self._values.mean(axis=0)

    def at(self, physical_coord, value=None):
        """Read or set cells addressed by physical slices (m)
        (aperture.py:78-101)."""
        idx = []
        for sl, pitch in zip(physical_coord, self._pixel_pitch):
            if isinstance(sl, slice):
                start = int(sl.start / pitch) if sl.start else None
                stop = int(sl.stop / pitch) if sl.stop else None
                idx.append(slice(start, stop))
            else:
                idx.append(int(sl / pitch))
        key = (slice(None),) + tuple(idx)
        if value is None:
            return self._values[key]
        self._values[key] = value
        return None

    def __getitem__(self, key):
        return self._values[key]

    def __setitem__(self, key, value):
        self._values[key] = value


def _center_to_pixels(center, shape, pixel_pitch):
    if center is None:
        return np.array(shape) // 2
    return (np.asarray(center) / np.asarray(pixel_pitch)).astype(int)


def rect_aperture(slm_shape, pixel_pitch, apert_dim, center=None):
    """Rectangular aperture of physical dimensions ``apert_dim``
    (aperture.py:147-203)."""
    apert = Aperture(slm_shape, pixel_pitch)
    dim_px = np.maximum((np.asarray(apert_dim) / np.asarray(pixel_pitch)).astype(int), 1)
    c = _center_to_pixels(center, slm_shape, pixel_pitch)
    top = int(c[0] - dim_px[0] // 2)
    left = int(c[1] - dim_px[1] // 2)
    assert top >= 0 and left >= 0, "aperture exceeds SLM"
    assert top + dim_px[0] <= slm_shape[0] and left + dim_px[1] <= slm_shape[1]
    apert[:, top : top + dim_px[0], left : left + dim_px[1]] = 255
    return apert


def line_aperture(slm_shape, pixel_pitch, length, vertical=True, center=None):
    """1-cell-wide line of physical ``length`` (aperture.py:206-227)."""
    width = pixel_pitch[1] if vertical else pixel_pitch[0]
    dim = (length, width) if vertical else (width, length)
    return rect_aperture(slm_shape, pixel_pitch, dim, center)


def square_aperture(slm_shape, pixel_pitch, side, center=None):
    """Square of physical ``side`` (aperture.py:230-247)."""
    return rect_aperture(slm_shape, pixel_pitch, (side, side), center)


def circ_aperture(slm_shape, pixel_pitch, radius, center=None):
    """Circle of physical ``radius`` (aperture.py:250-280)."""
    apert = Aperture(slm_shape, pixel_pitch)
    c = _center_to_pixels(center, slm_shape, pixel_pitch)
    yy, xx = np.mgrid[0 : slm_shape[0], 0 : slm_shape[1]]
    dist = np.sqrt(
        ((yy - c[0]) * pixel_pitch[0]) ** 2 + ((xx - c[1]) * pixel_pitch[1]) ** 2
    )
    apert[:, dist <= radius] = 255
    return apert
