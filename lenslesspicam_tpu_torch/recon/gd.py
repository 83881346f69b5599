"""Projected gradient descent, Nesterov and FISTA (port of
lenslesspicam_tpu/recon/gd.py).

One Python loop on the device, the iteration count an argument.  Numerics
as in the JAX package:

* padded convolver with ``norm="ortho"`` on H only (the data's FFTs keep
  the backward norm);
* start at the PSF's per-channel half intensity ``(max + min) / 2``;
* step ``alpha = lip_fact / max_k |H_k|^2`` per channel;
* gradient ``H^T (H x - y)``; projection: clip at 0;
* FISTA's t_k sequence (Beck & Teboulle eq. 4.2), Nesterov momentum.

3-D PSFs broadcast the measurement over the depth axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import as_tensor
from ..ops.fft_conv import FFTConvolver


def make_convolver(psf, dtype=torch.float32, pad_policy: str = "ref",
                   norm: str = "ortho", device=None) -> FFTConvolver:
    return FFTConvolver.from_psf(psf, pad=True, norm=norm, dtype=dtype,
                                 pad_policy=pad_policy, device=device)


def half_intensity_init(conv: FFTConvolver, psf, batch_size: int = 1) -> torch.Tensor:
    """Per-channel (max + min) / 2 of the PSF, broadcast to the image shape."""
    psf = as_tensor(psf, conv.H.real.dtype, conv.H.device)
    flat = psf.reshape(-1, psf.shape[-1])
    pixel_start = (flat.amax(dim=0) + flat.amin(dim=0)) / 2.0
    return torch.ones((batch_size,) + tuple(conv.psf_shape), dtype=psf.dtype,
                      device=psf.device) * pixel_start


def step_size(conv: FFTConvolver, lip_fact: float = 1.8) -> torch.Tensor:
    """alpha = lip_fact / max |H|^2, per channel."""
    mag = conv.mag_sq()
    return lip_fact / mag.reshape(-1, mag.shape[-1]).amax(dim=0)


def _promote(data, conv: FFTConvolver):
    data = as_tensor(data, conv.H.real.dtype, conv.H.device)
    if data.ndim == 3:
        data = data[None, None]
    elif data.ndim == 4:
        data = data[None]
    return data


def _grad(conv: FFTConvolver, image, data):
    return conv.deconvolve(conv.convolve(image) - data)


def _nonneg(x):
    return torch.clamp(x, min=0.0)


class GDConfig(NamedTuple):
    lip_fact: float = 1.8
    mu: float = 0.9   # Nesterov momentum
    tk: float = 1.0   # FISTA's initial t_k


def run(conv: FFTConvolver, psf, data, n_iter: int = 100, method: str = "fista",
        config: GDConfig = GDConfig(), initial_est=None, proj=_nonneg,
        initial_state=None, return_state: bool = False):
    """Projected GD family; returns ``(batch, depth, H, W, C)``.

    ``method``: "vanilla", "nesterov" or "fista".  ``initial_state`` and
    ``return_state`` continue a solve exactly where an earlier call left
    it (``apply(disp_iter=...)``): the state is the image for "vanilla",
    ``(image, momentum)`` for "nesterov", ``(image, x_k, t_k)`` for
    "fista"; with ``return_state`` the result is ``(image, state)``."""
    dtype = conv.H.real.dtype
    data = _promote(data, conv)
    batch = data.shape[0]
    alpha = step_size(conv, config.lip_fact)
    if initial_est is not None:
        image = as_tensor(initial_est, dtype, conv.H.device).expand(
            (batch,) + tuple(conv.psf_shape))
    else:
        image = half_intensity_init(conv, psf, batch)
    n_iter = int(n_iter)

    if method == "vanilla":
        im = image if initial_state is None else initial_state
        for _ in range(n_iter):
            im = proj(im - alpha * _grad(conv, im, data))
        return (im, im) if return_state else im

    if method == "nesterov":
        mu = config.mu
        im, p = (image, torch.zeros_like(image)) if initial_state is None else initial_state
        for _ in range(n_iter):
            p_new = mu * p - alpha * _grad(conv, im, data)
            im = proj(im - mu * p + (1 + mu) * p_new)
            p = p_new
        return (im, (im, p)) if return_state else im

    if method == "fista":
        if initial_state is None:
            im, xk = image, image
            tk = torch.tensor(config.tk, dtype=dtype, device=conv.H.device)
        else:
            im, xk, tk = initial_state
        for _ in range(n_iter):
            xk_new = proj(im - alpha * _grad(conv, im, data))
            tk_new = (1.0 + torch.sqrt(1.0 + 4.0 * tk ** 2)) / 2.0
            im = xk_new + (tk - 1.0) / tk_new * (xk_new - xk)
            xk, tk = xk_new, tk_new
        # the viewable image is proj(image_est), as in the reference's apply
        return (proj(im), (im, xk, tk)) if return_state else proj(im)

    raise ValueError(f"unknown method: {method!r}")


def fista(psf, data, n_iter=100, device=None, **kwargs):
    """One-shot FISTA from a raw PSF, on ``device`` (None: the CUDA card)."""
    conv = make_convolver(psf, device=device, **kwargs)
    return run(conv, psf, data, n_iter, method="fista")
