"""Accelerated proximal gradient descent (port of
lenslesspicam_tpu/recon/apgd.py).

FISTA-accelerated proximal gradient on

    min_x  1/2 ||S H x - y||^2 + lambda_d ||x||^2 + g(x)

with ``g`` one of ``APGDPriors``: non-negativity (clip), L1 (soft
threshold) or None, and ``S`` an optional strided subsampling so that the
measurement may live at a lower resolution than the reconstruction.  Step
1/L with L = max |H|^2 (+ 2 lambda_d).  One Python loop on the device.
With ``rel_error`` the loop stops at the first iteration whose relative
step ||x_{k+1} - x_k|| / ||x_k|| is at most ``rel_error`` (read on the
host each iteration), after at least one iteration, as the JAX package's
``while_loop`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import as_host, as_tensor
from ..ops.fft_conv import FFTConvolver
from ..ops.tv import soft_thresh


class APGDPriors:
    """Priors for APGD."""

    L2 = "l2"
    L1 = "l1"
    NONNEG = "nonneg"

    @staticmethod
    def all_values():
        return [APGDPriors.L2, APGDPriors.L1, APGDPriors.NONNEG]


def make_convolver(psf, dtype=torch.float32, pad_policy: str = "ref",
                   device=None) -> FFTConvolver:
    return FFTConvolver.from_psf(psf, pad=True, norm="ortho", dtype=dtype,
                                 pad_policy=pad_policy, device=device)


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 (``jax.image.resize``'s "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    """The triangle kernel (``jax.image.resize``'s "linear" / "bilinear")."""
    return np.maximum(0.0, 1.0 - x)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle, "bilinear": _triangle}


def resize_weights(n_in: int, n_out: int, method: str = "cubic") -> np.ndarray:
    """(n_out, n_in) float64 weights of ``jax.image.resize(method=method)``
    ("cubic", or "linear" / "bilinear") along one axis: half-pixel sample
    positions, the kernel widened by the scale when downsampling
    (antialias), each row renormalized over the taps inside the input, rows
    sampling outside it zero."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    w = _KERNELS[method](np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
                         / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def resize_cubic(psf, hw) -> np.ndarray:
    """A (D, H, W, C) array resized to ``hw`` over its spatial axes as
    ``jax.image.resize(..., method="cubic")`` resizes it: two products with
    float64 weight matrices on the host; an axis whose size does not change
    is left as it is."""
    out = np.asarray(psf, np.float64)
    if out.shape[1] != hw[0]:
        out = np.einsum("yh,dhwc->dywc", resize_weights(out.shape[1], hw[0]), out)
    if out.shape[2] != hw[1]:
        out = np.einsum("xw,dywc->dyxc", resize_weights(out.shape[2], hw[1]), out)
    return out


def make_downsampling_convolver(psf, img_shape, dtype=torch.float32,
                                pad_policy: str = "ref", device=None):
    """Convolver and integer subsampling factors for a measurement of
    ``img_shape`` (H, W) smaller than the PSF grid: the PSF is resized
    (cubic, :func:`resize_cubic`) to an integer multiple of the measurement
    shape and the forward model becomes ``subsample(conv(x))``.

    Returns ``(conv, ds_factor)`` with ``ds_factor`` an (fy, fx) tuple."""
    psf = as_host(psf)
    rec_shape = np.array(psf.shape[1:3])
    meas_shape = np.array(img_shape[:2])
    if not np.all(meas_shape <= rec_shape):
        raise ValueError("Image shape must be smaller than PSF shape")
    ds = np.round(rec_shape / meas_shape).astype(int)
    new_hw = tuple(int(n) for n in meas_shape * ds)
    if tuple(rec_shape) != new_hw:
        psf = resize_cubic(psf, new_hw).astype(np.float32)
    return make_convolver(psf, dtype, pad_policy, device), (int(ds[0]), int(ds[1]))


def _subsample(x, ds):
    """Strided subsampling on (H, W)."""
    return x[..., :: ds[0], :: ds[1], :]


def _subsample_adj(y, ds, full_hw):
    """Adjoint of :func:`_subsample`: zero-filled upsampling."""
    out = torch.zeros(y.shape[:-3] + tuple(full_hw) + y.shape[-1:], dtype=y.dtype,
                      device=y.device)
    out[..., :: ds[0], :: ds[1], :] = y
    return out


def run(conv: FFTConvolver, data, n_iter: int = 500,
        prox_penalty: Optional[str] = APGDPriors.NONNEG,
        diff_penalty: Optional[str] = None, prox_lambda: float = 1e-5,
        diff_lambda: float = 1e-3, acceleration: bool = True,
        ds_factor: Optional[tuple] = None, rel_error: Optional[float] = None):
    """APGD reconstruction; returns (batch, depth, H, W, C).

    ds_factor: (fy, fx) when the measurement is subsampled relative to the
        reconstruction grid (pair with :func:`make_downsampling_convolver`).
    rel_error: stop tolerance on ||x_{k+1} - x_k|| / ||x_k||; None runs
        exactly ``n_iter`` iterations.
    """
    dtype, device = conv.H.real.dtype, conv.H.device
    data = as_tensor(data, dtype, device)
    if data.ndim == 3:
        data = data[None, None]
    elif data.ndim == 4:
        data = data[None]
    full_hw = conv.psf_shape[-3:-1]

    lip = torch.amax(conv.mag_sq())
    if diff_penalty == APGDPriors.L2:
        lip = lip + 2.0 * diff_lambda
    alpha = 1.0 / lip

    if prox_penalty == APGDPriors.L1:
        def prox(x):
            return soft_thresh(x, alpha * prox_lambda)
    elif prox_penalty == APGDPriors.NONNEG:
        def prox(x):
            return torch.clamp(x, min=0.0)
    else:
        def prox(x):
            return x

    def grad(x):
        if ds_factor is None:
            g = conv.deconvolve(conv.convolve(x) - data)
        else:
            r = _subsample(conv.convolve(x), ds_factor) - data
            g = conv.deconvolve(_subsample_adj(r, ds_factor, full_hw))
        if diff_penalty == APGDPriors.L2:
            g = g + 2.0 * diff_lambda * x
        return g

    x = torch.zeros((data.shape[0],) + tuple(conv.psf_shape), dtype=dtype, device=device)
    z = x
    tk = torch.tensor(1.0, dtype=dtype, device=device)
    for _ in range(int(n_iter)):
        if acceleration:
            x_new = prox(z - alpha * grad(z))
            tk_new = (1.0 + torch.sqrt(1.0 + 4.0 * tk ** 2)) / 2.0
            z = x_new + (tk - 1.0) / tk_new * (x_new - x)
            tk = tk_new
        else:
            x_new = z = prox(x - alpha * grad(x))
        if rel_error is not None:
            rel = torch.linalg.norm(x_new - x) / torch.clamp(torch.linalg.norm(x), min=1e-12)
        x = x_new
        if rel_error is not None and float(rel) <= rel_error:
            break
    return x


def apgd(psf, data, n_iter=500, img_shape=None, device=None, **kwargs):
    """One-shot APGD from a raw PSF on ``device`` (None: the CUDA card);
    ``img_shape`` enables the downsampling composition (data at
    ``img_shape``, the reconstruction at the PSF grid)."""
    if img_shape is not None:
        conv, kwargs["ds_factor"] = make_downsampling_convolver(psf, img_shape,
                                                                device=device)
    else:
        conv = make_convolver(psf, device=device)
    return run(conv, data, n_iter, **kwargs)
