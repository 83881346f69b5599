"""User-facing reconstruction API (port of
lenslesspicam_tpu/recon/base.py).

The reference's three-step protocol:

    recon = ADMM(psf)          # setup on the CUDA card (device="cpu" to ask for the CPU)
    recon.set_data(data)
    image = recon.apply(n_iter=100)

``ADMM`` runs the exact solver (``recon/admm.py``), ``GradientDescent``,
``NesterovGradientDescent`` and ``FISTA`` the projected GD family
(``recon/gd.py``), each as one Python loop on its device with the
iteration count an argument.  Returned images are ``(depth, H, W, C)``
tensors; ``apply(disp_iter=k)`` runs the solve in chunks of k iterations
that continue the exact state, with a callback and an optional plot after
each.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from .._device import as_device, resolve_device
from ..ops.fft_conv import FFTConvolver
from . import admm as _admm
from . import gd as _gd


def _as_5d(x):
    return x[None] if x.ndim == 4 else x


class ReconstructionAlgorithm(abc.ABC):
    """PSF validation, data management and the apply loop."""

    def __init__(self, psf, dtype=torch.float32, n_iter=100, initial_est=None,
                 pad_policy="ref", device=None, **kwargs):
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
        self._npix = int(np.prod(psf.shape))
        self._n_iter = n_iter
        self._pad_policy = pad_policy
        self._data = None
        self._initial_est = None
        if initial_est is not None:
            self._set_initial_estimate(initial_est)
        self._convolver = self._make_convolver(**kwargs)

    @abc.abstractmethod
    def _make_convolver(self, **kwargs) -> FFTConvolver:
        ...

    @abc.abstractmethod
    def _run(self, data, n_iter):
        """Return the (batch, depth, H, W, C) reconstruction."""

    def _run_chunk(self, data, k, state):
        """``(image, state)`` after k more iterations from ``state`` (None:
        a fresh start)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support disp_iter chunking")

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

    def _set_initial_estimate(self, image_est):
        image_est = as_device(image_est, self._dtype, self._device)
        if image_est.ndim < 4:
            raise ValueError("Initial estimate must be at least 4D")
        self._initial_est = _as_5d(image_est)

    def apply(self, n_iter=None, background=None, disp_iter=None, plot=False, save=False,
              gamma=None, callback=None, **_ignored):
        """Run the reconstruction; returns ``(depth, H, W, C)``.

        ``disp_iter`` chunks the solve, each chunk continuing the exact
        state of the last, and after every chunk calls ``callback(image,
        iteration)`` and plots or saves the image (``save``: a directory,
        or a ``.png`` path).  Unknown keywords are ignored, as the
        reference's ``apply`` ignores them."""
        if self._data is None:
            raise RuntimeError("Must set data with `set_data()`")
        if self._data.shape[0] != 1:
            raise ValueError("apply() processes a single image; use batch_apply()")
        data = self._data
        if background is not None:
            bg = as_device(background, self._dtype, self._device)
            data = torch.clamp(data - bg, min=0.0)
        n_iter = self._n_iter if n_iter is None else int(n_iter)
        if not disp_iter:
            return self._run(data, n_iter)[0]
        disp_iter = int(disp_iter)
        state, done, image = None, 0, None
        while done < n_iter:
            k = min(disp_iter, n_iter - done)
            image, state = self._run_chunk(data, k, state)
            done += k
            if callback is not None:
                callback(image[0], done)
            if plot or save:
                self._display(image[0], done, save=save, gamma=gamma)
        return image[0]

    def _display(self, img, iteration, save=False, gamma=None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..utils.plot import plot_image

        ax = plot_image(img, gamma=gamma)
        ax.set_title(f"iteration {iteration}")
        if save:
            fn = save if isinstance(save, str) else "."
            plt.savefig(fn if str(fn).endswith(".png") else f"{fn}/recon_iter{iteration}.png")
        plt.close(ax.figure)

    def batch_apply(self, data, n_iter=None):
        """Batched reconstruction ``(B, D, H, W, C) -> (B, D, H, W, C)``."""
        data = as_device(data, self._dtype, self._device)
        return self._run(data, self._n_iter if n_iter is None else n_iter)

    def reconstruction_error(self, prediction, lensless, normalize=True):
        """``||H x - y||^2 / npix`` per batch element, with ``H x``
        min-max normalized first when ``normalize``; shape ``(batch,)``."""
        conv = FFTConvolver.from_psf(self._psf, pad=True, norm=self._convolver.norm,
                                     dtype=self._dtype, pad_policy=self._pad_policy,
                                     device=self._device)
        prediction = _as_5d(as_device(prediction, self._dtype, self._device))
        lensless = _as_5d(as_device(lensless, self._dtype, self._device))
        Hx = conv.convolve(prediction)
        if normalize:
            Hx = Hx - Hx.amin(dim=(-1, -2, -3), keepdim=True)
            Hx = Hx / Hx.amax(dim=(-1, -2, -3), keepdim=True)
        return torch.sum((Hx - lensless) ** 2, dim=(-1, -2, -3, -4)) / self._npix


class ADMM(ReconstructionAlgorithm):
    """ADMM with TV prior and non-negativity (exact solver).  3-D PSFs
    reconstruct their depths independently.  An initial estimate (sensor
    sized) is placed on the padded grid as the solver's start."""

    def __init__(self, psf, dtype=torch.float32, mu1=1e-6, mu2=1e-5, mu3=4e-5,
                 tau=1e-4, **kwargs):
        self._params = _admm.ADMMParams(mu1, mu2, mu3, tau)
        super().__init__(psf, dtype=dtype, **kwargs)

    def _make_convolver(self, **kwargs):
        return _admm.make_convolver(self._psf, dtype=self._dtype,
                                    pad_policy=self._pad_policy, device=self._device)

    def _initial_padded(self):
        if self._initial_est is None:
            return None
        return self._convolver.pad_input(self._initial_est)[0]

    def _run(self, data, n_iter):
        return _admm.run(self._convolver, data, self._params, n_iter,
                         initial_est=self._initial_padded())

    def _run_chunk(self, data, k, state):
        return _admm.run_state(self._convolver, data, self._params, k, state,
                               initial_est=self._initial_padded())


class _GDBase(ReconstructionAlgorithm):
    _method = "vanilla"

    def __init__(self, psf, dtype=torch.float32, lip_fact=1.8, mu=0.9, tk=1.0, **kwargs):
        self._config = _gd.GDConfig(lip_fact=lip_fact, mu=mu, tk=tk)
        super().__init__(psf, dtype=dtype, **kwargs)

    def _make_convolver(self, **kwargs):
        return _gd.make_convolver(self._psf, dtype=self._dtype, pad_policy=self._pad_policy,
                                  norm=kwargs.get("norm", "ortho"), device=self._device)

    def _run(self, data, n_iter):
        return _gd.run(self._convolver, self._psf, data, n_iter, self._method,
                       self._config, self._initial_est)

    def _run_chunk(self, data, k, state):
        return _gd.run(self._convolver, self._psf, data, k, self._method, self._config,
                       self._initial_est, initial_state=state, return_state=True)


class GradientDescent(_GDBase):
    """Projected gradient descent."""

    _method = "vanilla"


class NesterovGradientDescent(_GDBase):
    """Projected gradient descent with Nesterov momentum."""

    _method = "nesterov"


class FISTA(_GDBase):
    """Projected gradient descent with FISTA acceleration."""

    _method = "fista"


def apply_admm(psf, data, n_iter=100, **kwargs):
    """One-shot ADMM."""
    recon = ADMM(psf, **kwargs)
    recon.set_data(data)
    return recon.apply(n_iter=n_iter)
