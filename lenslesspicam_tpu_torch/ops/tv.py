"""Total-variation operators and the soft-threshold prox, on the
``(..., depth, H, W, C)`` layout (port of lenslesspicam_tpu/ops/tv.py)."""

from __future__ import annotations

import math

import torch


def soft_thresh(x, thresh):
    """sign(x) * max(|x| - thresh, 0)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - thresh, min=0.0)


def finite_diff(x):
    """Circular forward differences along H and W, stacked on a new
    trailing axis of size 2."""
    return torch.stack(
        (torch.roll(x, 1, dims=-3) - x, torch.roll(x, 1, dims=-2) - x),
        dim=x.ndim,
    )


def finite_diff_adj(u):
    """Adjoint of :func:`finite_diff`."""
    d1 = torch.roll(u[..., 0], -1, dims=-3) - u[..., 0]
    d2 = torch.roll(u[..., 1], -1, dims=-2) - u[..., 1]
    return d1 + d2


def finite_diff_gram_spectrum(padded_shape, dtype=torch.float32, device=None):
    """|rfft2(4-point laplacian)| on the padded grid in closed form:
    4 - 2cos(2 pi ky / ph) - 2cos(2 pi kx / pw), shaped
    ``(depth, ph, pw // 2 + 1, ch)``."""
    depth, ph, pw, ch = padded_shape
    wy = 2.0 * math.pi * torch.arange(ph, dtype=torch.float32, device=device) / ph
    wx = 2.0 * math.pi * torch.arange(pw // 2 + 1, dtype=torch.float32,
                                      device=device) / pw
    spec = 4.0 - 2.0 * torch.cos(wy)[:, None] - 2.0 * torch.cos(wx)[None, :]
    spec = torch.clamp(spec, min=0.0).to(dtype)
    return spec[None, :, :, None].expand(depth, ph, pw // 2 + 1, ch)
