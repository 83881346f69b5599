"""Noise models (port of lenslesspicam_tpu/ops/noise.py).

Each entry point draws its standard normal sample from an explicit
``torch.Generator`` on the image's device.  The arithmetic that turns the
draw into noise at the target SNR lives in a private helper that takes the
draw, so the same draw gives the same result in both packages (the JAX
package's ``jax.random`` stream has no counterpart in torch).
"""

from __future__ import annotations

import torch

from .._device import as_tensor


def _normal(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def _shot_noise(image: torch.Tensor, snr_db: float, normal: torch.Tensor) -> torch.Tensor:
    noise = normal * torch.sqrt(torch.clamp(image, min=0.0))
    sig_var = torch.mean(image ** 2)
    noise_var = torch.mean(noise ** 2)
    factor = torch.sqrt(sig_var / torch.clamp(noise_var, min=1e-20) / (10 ** (snr_db / 10.0)))
    return torch.clamp(image + factor * noise, min=0.0)


def _gaussian_noise(x: torch.Tensor, snr_db: float, normal: torch.Tensor) -> torch.Tensor:
    noise_var = torch.mean(x ** 2) / (10 ** (snr_db / 10.0))
    return x + torch.sqrt(noise_var) * normal


def add_shot_noise(image, snr_db: float, generator: torch.Generator,
                   device=None) -> torch.Tensor:
    """Poisson-like shot noise at ``snr_db``: noise ~ sqrt(image) N(0, 1),
    scaled so that 10 log10(P_signal / P_noise) = snr_db, output clipped
    non-negative (the waveprop recipe)."""
    image = as_tensor(image, None, device)
    return _shot_noise(image, snr_db, _normal(image, generator))


def add_gaussian_noise_snr(x, snr_db: float, generator: torch.Generator,
                           device=None) -> torch.Tensor:
    """Additive white gaussian noise at a target SNR in dB."""
    x = as_tensor(x, None, device)
    return _gaussian_noise(x, snr_db, _normal(x, generator))
