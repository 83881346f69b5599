"""Image-quality metrics (port of lenslesspicam_tpu/eval/metrics.py:22-38)."""

from __future__ import annotations

import torch


def max_normalize(img, axis=(-1, -2, -3)):
    """Divide by the per-image max (images whose max is 0 pass through)."""
    m = torch.amax(img, dim=axis, keepdim=True)
    return torch.where(m != 0, img / torch.where(m == 0, torch.ones_like(m), m), img)


def mse(pred, target):
    """Mean squared error over all elements."""
    return torch.mean((pred - target) ** 2)


def psnr(pred, target, data_range: float = 1.0, reduce_axes=(-1, -2, -3)):
    """Peak SNR in dB, per image over ``reduce_axes``."""
    err = torch.mean((pred - target) ** 2, dim=reduce_axes)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(err, min=1e-20))
