"""Far-field simulation of lensless measurements (port of
lenslesspicam_tpu/data/simulation.py).

1. the object at ``scene2mask`` meters is imaged with magnification
   ``m = mask2sensor / scene2mask``; its physical height maps to
   ``object_height * m / pixel_height`` sensor pixels;
2. the resized object is pasted centered (or randomly shifted) onto a
   sensor-resolution canvas -> the "lensed" / object-plane image (host
   numpy, ``data.image.resize``);
3. if a PSF is given, the canvas is convolved with it (same-size FFT
   convolution, ``ops.fft_conv.FFTConvolver``) on ``device`` (None: the
   CUDA card) -> the lensless measurement;
4. optional shot noise at ``snr_db``, a resize to ``output_dim`` and
   quantization to ``max_val``.

An explicit ``torch.Generator`` replaces the JAX package's ``jax.random``
keys: it draws the object height (when ``object_height`` is a range), the
random shift and the shot noise's normal sample, in that order.  The
arithmetic after each draw takes the draw itself (``_height``, and
``ops.noise``'s), so one draw gives both packages one result.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .._device import as_host, resolve_device
from ..hardware.sensor import VirtualSensor
from ..models.unet import resize_bilinear
from ..ops.fft_conv import FFTConvolver
from ..ops.noise import add_shot_noise
from .image import resize as _np_resize


def _uniform(generator: torch.Generator) -> float:
    return float(torch.rand((), generator=generator, device=generator.device))


def _randint(generator: torch.Generator, high: int) -> int:
    """A draw from [0, high)."""
    return int(torch.randint(0, high, (), generator=generator, device=generator.device))


def _height(lo, hi, u) -> float:
    """The object height for the uniform draw ``u`` in [0, 1), in float32
    as ``jax.random.uniform(key, minval=lo, maxval=hi)`` computes it."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return float(max(lo32, np.float32(u) * (hi32 - lo32) + lo32))


class FarFieldSimulator:
    """Propagate object images through a lensless camera forward model."""

    def __init__(self, object_height: Union[float, Tuple[float, float]], scene2mask: float,
                 mask2sensor: float, sensor: Union[str, "VirtualSensor"], psf=None,
                 output_dim=None, snr_db: Optional[float] = None, max_val: int = 255,
                 random_shift: bool = False, quantize: bool = True,
                 vertical_shift: Optional[int] = None, horizontal_shift: Optional[int] = None,
                 device=None, **kwargs):
        self.object_height = object_height
        self.scene2mask = scene2mask
        self.mask2sensor = mask2sensor
        self.sensor = VirtualSensor.from_name(sensor) if isinstance(sensor, str) else sensor
        self.snr_db = snr_db
        self.max_val = max_val
        self.random_shift = random_shift
        self.quantize = quantize
        self.output_dim = output_dim
        self.vertical_shift = vertical_shift
        self.horizontal_shift = horizontal_shift
        self.device = resolve_device(device)

        self.magnification = mask2sensor / scene2mask
        self.conv = None
        self.psf = None
        if psf is not None:
            self.set_psf(psf)

        # what re-creates this simulator
        self.params = {
            "object_height": object_height,
            "scene2mask": scene2mask,
            "mask2sensor": mask2sensor,
            "sensor": sensor if isinstance(sensor, str) else None,
            "output_dim": output_dim,
            "snr_db": snr_db,
            "max_val": max_val,
            "random_shift": random_shift,
            "quantize": quantize,
        }
        self.params.update(kwargs)

    def set_psf(self, psf):
        psf = torch.as_tensor(as_host(psf)).to(self.device)
        if psf.ndim != 4 or psf.shape[-1] not in (1, 3):
            raise ValueError("PSF must be (depth, H, W, C) with 1 or 3 channels")
        self.psf = psf
        self.conv = FFTConvolver.from_psf(psf, pad=True, norm="backward", device=self.device)
        return self

    set_point_spread_function = set_psf

    def get_psf(self):
        return self.psf

    def _object_plane(self, obj: np.ndarray, generator=None) -> np.ndarray:
        """Resize by magnification and paste onto the sensor canvas (the
        PSF's grid when a PSF is set, else ``output_dim``, else the
        sensor's resolution); physical sizes come from the sensor."""
        if self.psf is not None:
            sensor_res = tuple(int(v) for v in self.psf.shape[-3:-1])
        elif self.output_dim is not None:
            sensor_res = tuple(int(v) for v in self.output_dim)
        else:
            sensor_res = tuple(int(v) for v in self.sensor.resolution)
        sensor_h_m = float(self.sensor.size[0])

        if isinstance(self.object_height, (tuple, list)):
            lo, hi = self.object_height
            height_m = (_height(lo, hi, _uniform(generator)) if generator is not None
                        else (lo + hi) / 2.0)
        else:
            height_m = float(self.object_height)

        scene_h_m = height_m * self.magnification
        obj_h_px = int(round(scene_h_m / sensor_h_m * sensor_res[0]))
        obj_h_px = max(min(obj_h_px, sensor_res[0]), 1)
        scale = obj_h_px / obj.shape[-3]
        obj_w_px = max(min(int(round(obj.shape[-2] * scale)), sensor_res[1]), 1)

        obj4 = obj if obj.ndim == 4 else obj[None]
        resized = _np_resize(np.asarray(obj4), shape=(obj_h_px, obj_w_px, obj4.shape[-1]))

        canvas = np.zeros((obj4.shape[0],) + sensor_res + (obj4.shape[-1],), np.float32)
        if self.random_shift and generator is not None:
            y0 = _randint(generator, sensor_res[0] - obj_h_px + 1)
            x0 = _randint(generator, sensor_res[1] - obj_w_px + 1)
        else:
            y0 = (sensor_res[0] - obj_h_px) // 2
            x0 = (sensor_res[1] - obj_w_px) // 2
        canvas[:, y0:y0 + obj_h_px, x0:x0 + obj_w_px, :] = resized
        if self.vertical_shift:
            canvas = np.roll(canvas, self.vertical_shift, axis=-3)
        if self.horizontal_shift:
            canvas = np.roll(canvas, self.horizontal_shift, axis=-2)
        return canvas if obj.ndim == 4 else canvas[0]

    def propagate_image(self, obj, return_object_plane: bool = False,
                        generator: Optional[torch.Generator] = None):
        """Simulate the measurement of an HWC (or DHWC) object image: a
        tensor on the simulator's device (the object plane, numpy, when no
        PSF is set).  ``generator`` (on that device) draws the random
        height, shift and noise; None: the range's midpoint, no shift, and
        noise from a generator seeded with 0."""
        obj = as_host(obj)
        if obj.shape[-1] not in (1, 3):
            raise ValueError("image must have 1 or 3 channels")
        if self.psf is not None and self.psf.shape[-1] == 3 and obj.shape[-1] == 1:
            obj = np.repeat(obj, 3, axis=-1)  # grayscale object, RGB PSF
        obj_plane = self._object_plane(obj, generator)

        if self.conv is None:
            return (obj_plane, obj_plane) if return_object_plane else obj_plane

        x = torch.from_numpy(obj_plane).to(self.device)
        if x.ndim == 3:
            x = x[None]  # add depth
        image = self.conv.convolve(x)

        if self.snr_db is not None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            image = add_shot_noise(image, self.snr_db, generator)

        if self.output_dim is not None:
            hw = tuple(int(v) for v in self.output_dim)
            image = resize_bilinear(image.movedim(-1, -3), hw).movedim(-3, -1)

        if self.quantize:
            m = torch.max(image)
            image = torch.where(m > 0, image / m, image) * self.max_val
            image = torch.clamp(torch.round(image), 0, self.max_val)

        if obj.ndim == 3:
            image = image[0]
        if return_object_plane:
            return image, obj_plane
        return image

    propagate = propagate_image
