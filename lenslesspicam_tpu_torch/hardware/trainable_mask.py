"""Trainable masks — learnable physical masks co-optimized with the
reconstruction (port of lenslesspicam_tpu/hardware/trainable_mask.py;
reference: lensless/hardware/trainable_mask.py).

The reference couples ``torch.nn.Module`` masks with their own optimizer
and a post-step projection (trainable_mask.py:31-73).  As in the JAX
package, a trainable mask is a plain protocol consumed by train.Trainer:

* ``params``          — a dict of leaf tensors that require grad, on the
  mask's ``device`` (None: the CUDA card);
* ``get_psf(params)`` — differentiable params -> (D, H, W, C) PSF;
* ``project(params)`` — the feasibility projection, a new dict; the
  trainer runs it under ``torch.no_grad()`` after each step and copies
  it into the leaves;
* ``make_optimizer(params)`` — the mask's own ``torch.optim`` optimizer
  over the leaves (separate from the reconstruction optimizer,
  trainable_mask.py:51-61), with optax's hyper-parameters: Adam, AdamW
  with optax's weight decay 1e-4 on every leaf, or plain SGD.

Implementations:

* ``TrainablePSF``            — directly learnable PSF tensor, projection
  clamps to [0, 1] (trainable_mask.py:76-114);
* ``AdafruitLCD``             — differentiable DigiCam model: cell values ->
  full-sensor mask (deadspace + color filter) -> roll alignment shifts ->
  spherical-wave + angular-spectrum PSF -> flip -> L2 normalization
  (trainable_mask.py:117-260);
* ``TrainableCodedAperture``  — learnable separable row/col (or full)
  coded aperture; projection clamps + optional binarization, PSF by wave
  propagation (trainable_mask.py:263-335);
* ``prep_trainable_mask``     — config factory (trainable_mask.py:351-445).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import as_host, resolve_device
from ..ops.propagation import angular_spectrum
from .sensor import VirtualSensor
from .slm import SLMLayout, build_layout, get_intensity_psf, get_programmable_mask


class TrainableMask:
    """Base: holds params + its own optimizer config (trainable_mask.py:20-73)."""

    def __init__(self, optimizer="Adam", lr=1e-3, device=None, **kwargs):
        self._optimizer_type = optimizer
        self._lr = lr
        self.device = resolve_device(device)
        self.params = None

    def _leaf(self, x, requires_grad=True) -> torch.Tensor:
        """A float32 copy of ``x`` (an array or a tensor) on the mask's
        device, a leaf that requires grad."""
        return torch.from_numpy(as_host(x)).to(self.device, copy=True).requires_grad_(
            requires_grad)

    def make_optimizer(self, params=None) -> torch.optim.Optimizer:
        """The mask's optimizer over ``params`` (default: ``self.params``)'s
        leaves: optax's ``adam(lr)``, ``adamw(lr)`` (weight decay 1e-4) or
        ``sgd(lr)``."""
        leaves = list((self.params if params is None else params).values())
        if self._optimizer_type == "AdamW":
            return torch.optim.AdamW(leaves, lr=self._lr, weight_decay=1e-4)
        if self._optimizer_type == "SGD":
            return torch.optim.SGD(leaves, lr=self._lr)
        return torch.optim.Adam(leaves, lr=self._lr)

    def get_psf(self, params):
        raise NotImplementedError

    def project(self, params):
        return params


class TrainablePSF(TrainableMask):
    """Directly learnable PSF; projection clamps to [0, 1]
    (trainable_mask.py:76-114)."""

    def __init__(self, initial_psf, grayscale: bool = False, **kwargs):
        super().__init__(**kwargs)
        psf = as_host(initial_psf)
        assert psf.ndim == 4, "initial PSF must be (depth, H, W, C)"
        self.grayscale = grayscale
        if grayscale:
            psf = psf.mean(axis=-1, keepdims=True)
        self.params = {"psf": self._leaf(psf)}

    def get_psf(self, params):
        psf = params["psf"]
        if self.grayscale:
            psf = psf.repeat_interleave(3, dim=-1)
        return psf

    def project(self, params):
        return {"psf": torch.clamp(params["psf"], 0.0, 1.0)}


class AdafruitLCD(TrainableMask):
    """Differentiable DigiCam LCD -> PSF model (trainable_mask.py:117-260)."""

    def __init__(
        self,
        initial_vals,
        sensor: str | VirtualSensor = "rpi_hq",
        downsample: Optional[int] = None,
        scene2mask: float = 0.55,
        mask2sensor: float = 0.004,
        vertical_shift: int = 0,
        horizontal_shift: int = 0,
        flipud: bool = True,
        train_mask_vals: bool = True,
        color_filter=None,
        train_color_filter: bool = False,
        min_val: float = 0.0,
        deadspace: bool = True,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.sensor = (
            VirtualSensor.from_name(sensor, downsample)
            if isinstance(sensor, str) else sensor
        )
        vals = self._leaf(initial_vals)
        self.layout: SLMLayout = build_layout(tuple(vals.shape), self.sensor,
                                              deadspace=deadspace)
        self.scene2mask = scene2mask
        self.mask2sensor = mask2sensor
        self.vertical_shift = vertical_shift
        self.horizontal_shift = horizontal_shift
        self.flipud = flipud
        self.min_val = min_val
        self.train_mask_vals = train_mask_vals
        self.train_color_filter = train_color_filter and color_filter is not None

        self.params = {}
        if train_mask_vals:
            self.params["vals"] = vals
        else:
            self._fixed_vals = vals.detach()
        if self.train_color_filter:
            self.params["color_filter"] = self._leaf(color_filter)
        else:
            self._fixed_color_filter = (
                self._leaf(color_filter, requires_grad=False)
                if color_filter is not None else None
            )

    def get_psf(self, params):
        vals = params["vals"] if self.train_mask_vals else self._fixed_vals
        cf = (params["color_filter"] if self.train_color_filter
              else getattr(self, "_fixed_color_filter", None))
        mask = get_programmable_mask(vals, self.layout, color_filter=cf)

        # alignment shifts (trainable_mask.py:224-228)
        if self.vertical_shift:
            mask = torch.roll(mask, self.vertical_shift, dims=-2)
        if self.horizontal_shift:
            mask = torch.roll(mask, self.horizontal_shift, dims=-1)

        psf = get_intensity_psf(mask, self.sensor, self.scene2mask, self.mask2sensor)
        if self.flipud:
            psf = torch.flip(psf, dims=(0,))
        psf = psf[None]  # depth axis (trainable_mask.py:243)
        return psf / torch.linalg.vector_norm(psf)

    def project(self, params):
        out = dict(params)
        if self.train_mask_vals:
            out["vals"] = torch.clamp(params["vals"], self.min_val, 1.0)
        if self.train_color_filter:
            cf = torch.clamp(params["color_filter"], 0.0, 1.0)
            # normalize rows to sum 1 (trainable_mask.py:256-260)
            cf = cf / torch.clamp(cf.sum(dim=-1, keepdim=True), min=1e-12)
            out["color_filter"] = cf
        return out


class TrainableCodedAperture(TrainableMask):
    """Learnable separable (or full) coded aperture with wave-propagated
    PSF (trainable_mask.py:263-335)."""

    def __init__(self, sensor_name="rpi_hq", downsample=8, binary: bool = True,
                 separable: bool = True, n_bits: int = 4,
                 distance_sensor: float = 4e-3,
                 wavelengths=(460e-9, 550e-9, 640e-9), seed=0, **kwargs):
        super().__init__(**kwargs)
        from .mask import CodedAperture

        self.binary = binary
        self.separable = separable
        self.wavelengths = wavelengths
        self.distance_sensor = distance_sensor
        self._mask_obj = CodedAperture.from_sensor(
            sensor_name, downsample, method="MLS", n_bits=n_bits,
            distance_sensor=None, device=self.device,
        )
        self.sensor = VirtualSensor.from_name(sensor_name, downsample)
        rng = np.random.RandomState(seed)
        if separable:
            self.params = {
                "row": self._leaf(rng.rand(self._mask_obj.resolution[0])),
                "col": self._leaf(rng.rand(self._mask_obj.resolution[1])),
            }
        else:
            self.params = {"mask": self._leaf(rng.rand(*self._mask_obj.resolution))}

    def _mask_from(self, params):
        if self.separable:
            return torch.outer(params["row"], params["col"])
        return params["mask"]

    def get_psf(self, params):
        mask = self._mask_from(params)
        pitch = (float(self._mask_obj.feature_size[0]), float(self._mask_obj.feature_size[1]))
        psfs = []
        for wv in self.wavelengths:
            u = angular_spectrum(mask.to(torch.complex64), wv, pitch, self.distance_sensor)
            psfs.append(torch.abs(u) ** 2)
        psf = torch.stack(psfs, dim=-1)[None]
        return psf / torch.linalg.vector_norm(psf)

    def project(self, params):
        out = {k: torch.clamp(v, 0.0, 1.0) for k, v in params.items()}
        if self.binary:
            out = {k: torch.round(v) for k, v in out.items()}
        return out


def prep_trainable_mask(config: dict, psf=None):
    """Config factory (trainable_mask.py:351-445 analog).

    config keys: mask_type in {TrainablePSF, AdafruitLCD,
    TrainableCodedAperture}, plus per-type kwargs.
    """
    mask_type = config.get("mask_type")
    if mask_type is None:
        return None
    kwargs = {k: v for k, v in config.items() if k != "mask_type"}
    if mask_type == "TrainablePSF":
        assert psf is not None
        return TrainablePSF(psf, **kwargs)
    if mask_type == "AdafruitLCD":
        return AdafruitLCD(**kwargs)
    if mask_type == "TrainableCodedAperture":
        return TrainableCodedAperture(**kwargs)
    raise ValueError(f"unknown mask_type: {mask_type}")
