"""User-facing reconstruction API (port of
lenslesspicam_tpu/recon/base.py:32-247, ADMM only).

    recon = ADMM(psf)          # setup on the CUDA card (device="cpu" to ask for the CPU)
    recon.set_data(data)
    image = recon.apply(n_iter=100)

``ADMM`` runs the exact solver (``recon/admm.py``) with ``torch.fft`` on
its device.  Returned images are ``(depth, H, W, C)`` tensors.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from .._device import as_device, resolve_device
from ..ops.fft_conv import FFTConvolver
from . import admm as _admm


class ReconstructionAlgorithm(abc.ABC):
    """PSF validation, data management and the apply loop."""

    def __init__(self, psf, dtype=torch.float32, n_iter=100, pad_policy="ref",
                 device=None):
        if not isinstance(psf, torch.Tensor):
            psf = np.asarray(psf)
        if psf.ndim != 4:
            raise ValueError("PSF must be 4D: (depth, height, width, channels).")
        if psf.shape[3] not in (1, 3):
            raise ValueError("PSF must be rgb (3) or grayscale (1)")
        self._device = resolve_device(device)
        self._dtype = dtype
        self._psf = as_device(psf, dtype, self._device)
        self._psf_shape = tuple(psf.shape)
        self._n_iter = n_iter
        self._pad_policy = pad_policy
        self._data = None
        self._convolver = self._make_convolver()

    @abc.abstractmethod
    def _make_convolver(self) -> FFTConvolver:
        ...

    @abc.abstractmethod
    def _run(self, data, n_iter):
        """Return the (batch, depth, H, W, C) reconstruction."""

    def set_data(self, data):
        """Set the lensless measurement; promoted to 5-D."""
        data = as_device(data, self._dtype, self._device)
        if data.ndim < 3:
            raise ValueError("Data must be at least 3D: [..., H, W, C].")
        if tuple(data.shape[-3:-1]) != self._psf_shape[-3:-1]:
            raise ValueError("PSF and data shape mismatch")
        if data.ndim == 3:
            data = data[None, None]
        elif data.ndim == 4:
            data = data[None]
        self._data = data

    def apply(self, n_iter=None, background=None):
        """Run the reconstruction; returns ``(depth, H, W, C)``."""
        if self._data is None:
            raise RuntimeError("Must set data with `set_data()`")
        if self._data.shape[0] != 1:
            raise ValueError("apply() processes a single image; use batch_apply()")
        data = self._data
        if background is not None:
            bg = as_device(background, self._dtype, self._device)
            data = torch.clamp(data - bg, min=0.0)
        return self._run(data, self._n_iter if n_iter is None else n_iter)[0]

    def batch_apply(self, data, n_iter=None):
        """Batched reconstruction ``(B, D, H, W, C) -> (B, D, H, W, C)``."""
        data = as_device(data, self._dtype, self._device)
        return self._run(data, self._n_iter if n_iter is None else n_iter)


class ADMM(ReconstructionAlgorithm):
    """ADMM with TV prior and non-negativity (exact solver)."""

    def __init__(self, psf, dtype=torch.float32, mu1=1e-6, mu2=1e-5, mu3=4e-5,
                 tau=1e-4, **kwargs):
        self._params = _admm.ADMMParams(mu1, mu2, mu3, tau)
        super().__init__(psf, dtype=dtype, **kwargs)

    def _make_convolver(self):
        return _admm.make_convolver(self._psf, dtype=self._dtype,
                                    pad_policy=self._pad_policy,
                                    device=self._device)

    def _run(self, data, n_iter):
        return _admm.run(self._convolver, data, self._params, n_iter)


def apply_admm(psf, data, n_iter=100, **kwargs):
    """One-shot ADMM."""
    recon = ADMM(psf, **kwargs)
    recon.set_data(data)
    return recon.apply(n_iter=n_iter)
