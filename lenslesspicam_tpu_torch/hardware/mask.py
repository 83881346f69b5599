"""Mask designs + PSF simulation (port of lenslesspicam_tpu/hardware/mask.py;
reference: lensless/hardware/mask.py).

Four mask families with the reference's designs and geometry:

* ``CodedAperture`` (FlatCam): MURA / MLS patterns, separable
  measurement model ``P X Q^T`` (mask.py:288-473);
* ``MultiLensArray``: random non-overlapping micro-lenses with
  spherical-cap height maps (mask.py:476-703);
* ``PhaseContour`` (PhlatCam): Canny edges of Perlin noise as target
  PSF + Fresnel phase retrieval (mask.py:706-820);
* ``FresnelZoneAperture``: binarized cosine FZA (mask.py:823-856).

Geometry is host numpy.  PSF simulation uses the port's bandlimited
angular-spectrum propagator (ops/propagation.py) per wavelength, intensity
|.|^2 (mask.py:196-245), on ``device`` (None: the CUDA card) —
differentiable, so mask -> PSF -> reconstruction chains can be trained
end-to-end.  OpenCV (``cv2.Canny``, PhaseContour's target) is imported
where it is used.
"""

from __future__ import annotations

import abc
from math import sqrt

import numpy as np
import torch

from .._device import resolve_device
from ..data.image import INTER_NEAREST
from ..data.image import resize as _resize
from ..ops.noise import add_shot_noise
from ..ops.propagation import angular_spectrum, fresnel_conv
from .sensor import VirtualSensor


class Mask(abc.ABC):
    """Mask geometry + PSF computation (mask.py:45-285); the PSF lies on
    ``device`` (None: the CUDA card)."""

    def __init__(self, resolution, distance_sensor=None, size=None,
                 feature_size=None, psf_wavelength=(460e-9, 550e-9, 640e-9),
                 refractive_index=None, device=None, **kwargs):
        self.device = resolve_device(device)
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.size = np.asarray(size) if size is not None else None
        if feature_size is None:
            assert size is not None
            self.feature_size = self.size / np.asarray(self.resolution)
        else:
            if np.isscalar(feature_size):
                feature_size = np.array([feature_size, feature_size])
            self.feature_size = np.asarray(feature_size)
            if self.size is None:
                self.size = self.feature_size * np.asarray(self.resolution)
        assert np.all(np.asarray(self.feature_size) > 0)
        self.distance_sensor = distance_sensor
        self.refractive_index = refractive_index
        self.psf_wavelength = list(psf_wavelength)

        if not hasattr(self, "height_map"):
            self.height_map = None
        if not hasattr(self, "mask"):
            self.mask = None
        self.create_mask()
        self.shape = self.height_map.shape if self.height_map is not None else self.mask.shape

        self.psf = None
        if self.distance_sensor is not None:
            self.compute_psf()

    @classmethod
    def from_sensor(cls, sensor_name, downsample=None, **kwargs):
        """Constructor copying a sensor's geometry (mask.py:134-163)."""
        sensor = VirtualSensor.from_name(sensor_name, downsample)
        return cls(
            resolution=tuple(sensor.resolution),
            size=np.asarray(sensor.size),
            feature_size=sensor.pixel_size,
            **kwargs,
        )

    @abc.abstractmethod
    def create_mask(self):
        ...

    def height_map_to_field(self, wavelength, return_phase=False):
        """Phase from height map (mask.py:172-194)."""
        assert self.height_map is not None
        assert self.refractive_index is not None
        phase = self.height_map * (self.refractive_index - 1) * 2 * np.pi / wavelength
        return phase if return_phase else np.exp(1j * phase)

    def compute_psf(self, distance_sensor=None, wavelength=None, intensity=True):
        """Per-wavelength bandlimited angular-spectrum PSF
        (mask.py:196-245). Returns (H, W, n_wavelengths)."""
        if distance_sensor is not None:
            self.distance_sensor = distance_sensor
        assert self.distance_sensor is not None, "distance_sensor required"
        if wavelength is None:
            wavelength = self.psf_wavelength
        elif not hasattr(wavelength, "__len__"):
            wavelength = [wavelength]

        pitch = (float(self.feature_size[0]), float(self.feature_size[1]))
        fields = []
        for wv in wavelength:
            u_in = (self.mask if self.height_map is None
                    else self.height_map_to_field(wv))
            u_out = angular_spectrum(
                torch.from_numpy(np.asarray(u_in, np.complex64)).to(self.device), wv, pitch,
                self.distance_sensor)
            fields.append(u_out)
        psf = torch.stack(fields, dim=-1)
        self.psf = torch.abs(psf) ** 2 if intensity else psf
        return self.psf


def quadratic_residues(p: int):
    """Quadratic residues mod p, including 0 (sympy.ntheory convention,
    as used by the reference MURA generator)."""
    return sorted({(i * i) % p for i in range(0, p // 2 + 1)})


def _max_len_seq(nbits: int) -> np.ndarray:
    from scipy.signal import max_len_seq

    return max_len_seq(nbits)[0]


class CodedAperture(Mask):
    """FlatCam MURA / MLS coded aperture (mask.py:288-473)."""

    def __init__(self, method="MLS", n_bits=8, **kwargs):
        self.row = None
        self.col = None
        self.method = method.upper()
        self.n_bits = n_bits
        assert self.method in ("MURA", "MLS")

        if self.method == "MURA":
            self.mask = self.generate_mura(n_bits)
        else:
            seq = _max_len_seq(n_bits) * 2 - 1
            self.row = seq.astype(np.float32)
            self.col = seq.astype(np.float32)
        super().__init__(**kwargs)

    def create_mask(self, row=None, col=None, mask=None):
        if mask is not None:
            self.mask = mask
        elif row is not None:
            assert col is not None
            self.row, self.col = row, col
        if self.row is not None:
            self.mask = np.round((np.outer(self.row, self.col) + 1) / 2).astype(np.uint8)
        assert self.mask is not None
        if np.any(np.asarray(self.resolution) != self.mask.shape):
            self.mask = _resize(
                self.mask[None, :, :, None].astype(np.float32),
                shape=tuple(self.resolution) + (1,),
                interpolation=INTER_NEAREST,
            )[0, :, :, 0]

    @staticmethod
    def is_prime(n):
        if n % 2 == 0 and n > 2:
            return False
        return all(n % i for i in range(3, int(sqrt(n)) + 1, 2))

    def generate_mura(self, p):
        """p x p MURA pattern via quadratic residues (behavioral parity
        with reference mask.py:391-410, vectorized: the inner (p-1)^2
        block is the XNOR outer product of one residue-indicator
        vector; first row dark, first column lit below the corner)."""
        if not self.is_prime(p):
            raise ValueError("MURA requires a prime number of bits")
        is_qr = np.zeros(p, dtype=bool)
        is_qr[quadratic_residues(p)] = True
        A = np.zeros((p, p), dtype=int)
        A[1:, 0] = 1
        A[1:, 1:] = is_qr[: p - 1, None] == is_qr[None, : p - 1]
        return A

    def get_conv_matrices(self, img_shape):
        """Circulant P, Q such that measurement = P X Q^T (reference
        mask.py:412-435).  Built by index arithmetic — entry (i, j) of a
        circulant of s is s[(i - j) mod n] — truncated to the scene's
        row/column counts."""

        def _circulant_cols(seq, n, m):
            s = np.resize(seq, n)
            return s[(np.arange(n)[:, None] - np.arange(m)[None, :]) % n]

        P = _circulant_cols(self.col, self.resolution[0], img_shape[0])
        Q = _circulant_cols(self.row, self.resolution[1], img_shape[1])
        return P, Q

    def simulate(self, obj, snr_db=20, generator=None):
        """Separable measurement P X Q^T + shot noise (mask.py:437-473) on
        the mask's device; ``generator`` (a ``torch.Generator`` there) draws
        the noise, None: one seeded with 0."""
        assert obj.ndim == 3, "object must be (H, W, C)"
        P, Q = self.get_conv_matrices(obj.shape)
        P = torch.as_tensor(P, dtype=torch.float32, device=self.device)
        Q = torch.as_tensor(Q, dtype=torch.float32, device=self.device)
        obj = torch.as_tensor(np.asarray(obj), dtype=torch.float32).to(self.device)
        meas = torch.einsum("mh,hwc,nw->mnc", P, obj, Q)
        if snr_db is not None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            meas = add_shot_noise(meas, snr_db, generator)
        return meas


class MultiLensArray(Mask):
    """Random micro-lens array (mask.py:476-703)."""

    def __init__(self, N=30, radius=None, loc=None, refractive_index=1.2,
                 min_height=1e-5, seed=0, size_rng=(1e-4, 4e-4), **kwargs):
        self.N = N
        self.radius = radius
        self.loc = loc
        self.min_height = min_height
        self.seed = seed
        self.size_rng = size_rng
        super().__init__(refractive_index=refractive_index, **kwargs)

    def create_mask(self):
        rng = np.random.RandomState(self.seed)
        h, w = self.resolution
        size_m = np.asarray(self.size, np.float64)
        if self.radius is None:
            radius = rng.uniform(self.size_rng[0], self.size_rng[1], self.N)
            radius = np.sort(radius)[::-1]  # place large first
            locs = []
            placed_r = []
            for r in radius:  # rejection sampling (mask.py:584-632)
                for _ in range(1000):
                    y = rng.uniform(r, size_m[0] - r)
                    x = rng.uniform(r, size_m[1] - r)
                    if all((y - yy) ** 2 + (x - xx) ** 2 >= (r + rr) ** 2
                           for (yy, xx), rr in zip(locs, placed_r)):
                        locs.append((y, x))
                        placed_r.append(r)
                        break
            self.radius = np.asarray(placed_r)
            self.loc = np.asarray(locs)
        else:
            self.radius = np.asarray(self.radius)
            self.loc = np.asarray(self.loc)

        # spherical-cap height map (mask.py:656-694)
        y = (np.arange(h) + 0.5) * self.feature_size[0]
        x = (np.arange(w) + 0.5) * self.feature_size[1]
        yy, xx = np.meshgrid(y, x, indexing="ij")
        height = np.zeros((h, w), np.float64)
        for (cy, cx), r in zip(self.loc, self.radius):
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            cap = np.sqrt(np.maximum(r**2 - d2, 0.0))
            height = np.maximum(height, cap)
        self.height_map = height + self.min_height
        self.mask = np.ones((h, w), np.float32)

    @property
    def focal_length(self):
        """f = r / (n - 1) per lens (mask.py:696-703)."""
        return self.radius / (self.refractive_index - 1)


def perlin_noise_2d(shape, res, seed=0):
    """Classic 2-D gradient (Perlin) noise in [-1, 1]; native replacement
    for the perlin_numpy dependency (PhaseContour, mask.py:741-757)."""
    rng = np.random.RandomState(seed)
    d0, d1 = shape[0] // res[0], shape[1] // res[1]
    grid_y, grid_x = np.mgrid[0 : res[0] : 1 / d0, 0 : res[1] : 1 / d1]
    grid_y %= 1
    grid_x %= 1
    angles = 2 * np.pi * rng.rand(res[0] + 1, res[1] + 1)
    gradients = np.dstack((np.cos(angles), np.sin(angles)))
    g00 = gradients[:-1, :-1].repeat(d0, 0).repeat(d1, 1)
    g10 = gradients[1:, :-1].repeat(d0, 0).repeat(d1, 1)
    g01 = gradients[:-1, 1:].repeat(d0, 0).repeat(d1, 1)
    g11 = gradients[1:, 1:].repeat(d0, 0).repeat(d1, 1)
    n00 = g00[..., 0] * grid_y + g00[..., 1] * grid_x
    n10 = g10[..., 0] * (grid_y - 1) + g10[..., 1] * grid_x
    n01 = g01[..., 0] * grid_y + g01[..., 1] * (grid_x - 1)
    n11 = g11[..., 0] * (grid_y - 1) + g11[..., 1] * (grid_x - 1)
    t = 6 * np.stack([grid_y, grid_x]) ** 5 - 15 * np.stack([grid_y, grid_x]) ** 4 \
        + 10 * np.stack([grid_y, grid_x]) ** 3
    n0 = n00 * (1 - t[0]) + t[0] * n10
    n1 = n01 * (1 - t[0]) + t[0] * n11
    return np.sqrt(2) * ((1 - t[1]) * n0 + t[1] * n1)


def phase_retrieval(target_psf, wv, d1, dz, n=1.2, n_iter=10,
                    height_map=False, phase_wrap=1, device=None):
    """Iterative Fresnel phase retrieval (mask.py:775-820): alternate
    unit-amplitude constraint at the mask and sqrt(PSF) amplitude at the
    sensor, on ``device`` (None: the CUDA card)."""
    assert isinstance(phase_wrap, int)
    if hasattr(d1, "__len__"):
        d1 = float(d1[0])
    pitch = (d1, d1)
    target = torch.as_tensor(np.asarray(target_psf), dtype=torch.float32).to(
        resolve_device(device))
    M_p = torch.sqrt(target).to(torch.complex64)
    M_phi = None
    for _ in range(n_iter):
        M_phi = fresnel_conv(M_p, wv, pitch, -dz)
        M_phi = torch.exp(1j * torch.angle(M_phi))
        M_p = fresnel_conv(M_phi, wv, pitch, dz)
        M_p = torch.sqrt(target) * torch.exp(1j * torch.angle(M_p))
    phi = torch.remainder(torch.angle(M_phi) + 2 * np.pi, 2 * np.pi * phase_wrap)
    if height_map:
        return phi, wv * phi / (2 * np.pi * (n - 1))
    return phi


class PhaseContour(Mask):
    """PhlatCam phase mask (mask.py:706-820)."""

    def __init__(self, noise_period=(16, 16), refractive_index=1.2,
                 n_iter=10, design_wv=532e-9, seed=0, **kwargs):
        self.target_psf = None
        self.noise_period = noise_period
        self.n_iter = n_iter
        self.design_wv = design_wv
        self.seed = seed
        super().__init__(refractive_index=refractive_index, **kwargs)

    def create_mask(self):
        d0 = (self.resolution[0] // self.noise_period[0]) * self.noise_period[0]
        d1 = (self.resolution[1] // self.noise_period[1]) * self.noise_period[1]
        noise = perlin_noise_2d((d0, d1), self.noise_period, self.seed)
        if (d0, d1) != tuple(self.resolution):
            noise = _resize(noise[None, :, :, None],
                            shape=tuple(self.resolution) + (1,))[0, :, :, 0]
        binary = np.clip(np.round(np.interp(noise, (-1, 1), (0, 1))), 0, 1)
        import cv2

        self.target_psf = cv2.Canny(
            np.interp(binary, (-1, 1), (0, 255)).astype(np.uint8), 0, 255
        )
        assert self.distance_sensor is not None, "distance_sensor required"
        _, hm = phase_retrieval(
            self.target_psf, self.design_wv, self.feature_size,
            self.distance_sensor, n=self.refractive_index,
            n_iter=self.n_iter, height_map=True, device=self.device,
        )
        self.height_map = hm.cpu().numpy()
        self.mask = np.ones_like(self.height_map, np.float32)


class FresnelZoneAperture(Mask):
    """Binarized-cosine FZA (mask.py:823-856)."""

    def __init__(self, radius=0.56e-3, **kwargs):
        self.radius = radius
        super().__init__(**kwargs)

    def create_mask(self):
        dim = self.resolution
        x, y = np.meshgrid(
            np.linspace(-dim[1] / 2, dim[1] / 2 - 1, dim[1]),
            np.linspace(-dim[0] / 2, dim[0] / 2 - 1, dim[0]),
        )
        radius_px = self.radius / self.feature_size[0]
        mask = 0.5 * (1 + np.cos(np.pi * (x**2 + y**2) / radius_px**2))
        self.mask = np.round(mask)
