"""Virtual sensors (port of lenslesspicam_tpu/hardware/sensor.py).

Physical sensor specifications (public datasheet facts) for the five
supported sensors, plus a ``VirtualSensor`` with deadspace-aware
geometry, aspect-preserving virtual capture, and downsampling.  Host
numpy code; the capture's resize is ``data.image.resize_hw`` (what
``cv2.resize`` with INTER_LINEAR computes for a float scene; an integer
scene is resized in float64 and rounded, where OpenCV's 11-bit fixed
point can differ by one level).
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from ..data.image import resize_hw, rgb2gray


class SensorOptions(Enum):
    RPI_HQ = "rpi_hq"
    RPI_GS = "rpi_gs"
    RPI_V2 = "rpi_v2"
    BASLER_287 = "basler_287"
    BASLER_548 = "basler_548"

    @staticmethod
    def values():
        return [dev.value for dev in SensorOptions]


class SensorParam:
    PIXEL_SIZE = "pixel_size"
    RESOLUTION = "resolution"
    DIAGONAL = "diagonal"
    COLOR = "color"
    BIT_DEPTH = "bit_depth"
    MAX_EXPOSURE = "max_exposure"
    MIN_EXPOSURE = "min_exposure"


# landscape orientation; specs from the respective datasheets
# (sensor.py:70-129)
sensor_dict = {
    "rpi_hq": {  # Sony IMX477
        SensorParam.PIXEL_SIZE: np.array([1.55e-6, 1.55e-6]),
        SensorParam.RESOLUTION: np.array([3040, 4056]),
        SensorParam.DIAGONAL: 7.857e-3,
        SensorParam.COLOR: True,
        SensorParam.BIT_DEPTH: [8, 12],
        SensorParam.MAX_EXPOSURE: 670.74,
        SensorParam.MIN_EXPOSURE: 0.02,
    },
    "rpi_gs": {  # Sony IMX296
        SensorParam.PIXEL_SIZE: np.array([3.45e-6, 3.45e-6]),
        SensorParam.RESOLUTION: np.array([1088, 1456]),
        SensorParam.DIAGONAL: 6.3e-3,
        SensorParam.COLOR: True,
        SensorParam.BIT_DEPTH: [8, 10],
        SensorParam.MAX_EXPOSURE: 15534385e-6,
        SensorParam.MIN_EXPOSURE: 29e-6,
    },
    "rpi_v2": {  # Sony IMX219
        SensorParam.PIXEL_SIZE: np.array([1.12e-6, 1.12e-6]),
        SensorParam.RESOLUTION: np.array([2464, 3280]),
        SensorParam.DIAGONAL: 4.6e-3,
        SensorParam.COLOR: True,
        SensorParam.BIT_DEPTH: [8],
        SensorParam.MAX_EXPOSURE: 11.76,
        SensorParam.MIN_EXPOSURE: 0.02,
    },
    "basler_287": {  # Sony IMX287
        SensorParam.PIXEL_SIZE: np.array([6.9e-6, 6.9e-6]),
        SensorParam.RESOLUTION: np.array([540, 720]),
        SensorParam.COLOR: False,
        SensorParam.BIT_DEPTH: [8, 12],
    },
    "basler_548": {  # Sony IMX548
        SensorParam.PIXEL_SIZE: np.array([2.74e-6, 2.74e-6]),
        SensorParam.RESOLUTION: np.array([2048, 2448]),
        SensorParam.DIAGONAL: 8.8e-3,
        SensorParam.COLOR: True,
        SensorParam.BIT_DEPTH: [8, 10, 12],
    },
}


class VirtualSensor:
    """Sensor geometry + virtual capture (sensor.py:132-326)."""

    def __init__(self, pixel_size, resolution, diagonal=None, color=True,
                 bit_depth=None, downsample=None, **kwargs):
        if len(resolution) != 2:
            raise ValueError("resolution must be (height, width)")
        self.resolution = np.asarray(resolution).copy()
        if isinstance(pixel_size, float):
            pixel_size = np.array([pixel_size, pixel_size])
        self.pixel_size = np.asarray(pixel_size).copy()
        self.diagonal = diagonal
        self.color = color
        self.bit_depth = bit_depth or [8]

        if diagonal is not None:
            # deadspace-aware physical size from the diagonal (sensor.py:184-190)
            self.size = self.diagonal / np.linalg.norm(self.resolution) * self.resolution
        else:
            self.size = self.pixel_size * self.resolution
        self.pitch = self.size / self.resolution

        self.image_shape = np.append(self.resolution, 3) if color else self.resolution
        if downsample is not None:
            self.downsample(downsample)

    @classmethod
    def from_name(cls, name, downsample=None):
        if name not in SensorOptions.values():
            raise ValueError(f"Sensor {name} not supported.")
        return cls(**sensor_dict[name], downsample=downsample)

    def capture(self, scene=None, bit_depth=None, bayer=False):
        """Aspect-preserving resize + center-pad of a scene (an array, or
        the path of an image file read by ``data.io.load_image``) to sensor
        resolution, gray/color handling, bit-depth quantization
        (sensor.py:221-305)."""
        if bayer:
            raise NotImplementedError("Bayer capture not implemented.")
        if scene is None:
            scene = np.random.rand(*self.image_shape)
        else:
            if isinstance(scene, str):
                from ..data.io import load_image

                scene = load_image(scene)
            scale = np.min(np.array(self.resolution) / np.array(scene.shape[:2]))
            dsize = tuple((np.array(scene.shape[:2]) * scale).astype(int))
            scene = resize_hw(scene, dsize, "linear")
            diff = np.array(self.resolution) - np.array(scene.shape[:2])
            if np.any(diff):
                pad_width = (
                    (diff[0] // 2, diff[0] - diff[0] // 2),
                    (diff[1] // 2, diff[1] - diff[1] // 2),
                )
                if scene.ndim == 3:
                    pad_width = pad_width + ((0, 0),)
                scene = np.pad(scene, pad_width, mode="constant")

        if not self.color:
            if scene.ndim == 3:
                scene = rgb2gray(scene, keepchanneldim=False)
        elif scene.ndim == 2:
            scene = np.repeat(scene[:, :, None], 3, axis=2)

        scene = scene.astype(np.float32)
        if scene.max() > 0:
            scene /= scene.max()

        if bit_depth is None:
            bit_depth = self.bit_depth[0]
        elif bit_depth not in self.bit_depth:
            raise ValueError(f"Bit depth {bit_depth} not supported.")
        scene = (2**bit_depth - 1) * scene
        return scene.astype(np.uint8 if bit_depth == 8 else np.uint16)

    def downsample(self, factor):
        """Rescale pixel size / resolution (sensor.py:306-326)."""
        if not factor > 1:
            raise ValueError("downsample factor must be > 1")
        self.pixel_size = self.pixel_size * factor
        self.pitch = self.pitch * factor
        self.resolution = (self.resolution / factor).astype(int)
        self.size = self.pixel_size * self.resolution
        self.image_shape = np.append(self.resolution, 3) if self.color else self.resolution
