"""Image-quality metrics: MSE, PSNR, SSIM (port of
lenslesspicam_tpu/eval/metrics.py).

Functions of ``(..., H, W, C)`` tensors, computed on the tensors' device
(numpy inputs go to the CUDA card unless ``device="cpu"`` is named where
an entry point takes it).  SSIM is the Wang et al. formulation with an
11-tap gaussian window (sigma 1.5, K1 = .01, K2 = .03) applied as a
separable 'valid' filter, one ``conv1d`` an axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor


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


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_sep(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' filter over the spatial axes (-3, -2) of an
    (..., H, W, C) tensor."""
    size = k1d.shape[0]

    def conv_axis(x, axis):
        moved = torch.movedim(x, axis, -1)
        n = moved.shape[-1]
        out = F.conv1d(moved.reshape(-1, 1, n), k1d.view(1, 1, size))
        return torch.movedim(out.reshape(moved.shape[:-1] + (n - size + 1,)), -1, axis)

    return conv_axis(conv_axis(img, -3), -2)


def ssim(pred, target, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Structural similarity per image (mean over space and channels) of
    ``(..., H, W, C)`` inputs; returns shape ``(...)``."""
    pred = as_tensor(pred)
    target = as_tensor(target, device=pred.device)
    k = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(pred.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _filter2d_sep(pred, k)
    mu_y = _filter2d_sep(target, k)
    mu_xx = _filter2d_sep(pred * pred, k)
    mu_yy = _filter2d_sep(target * target, k)
    mu_xy = _filter2d_sep(pred * target, k)

    var_x = mu_xx - mu_x ** 2
    var_y = mu_yy - mu_y ** 2
    cov = mu_xy - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2))
    return torch.mean(ssim_map, dim=(-1, -2, -3))


def _collapse_depth(x):
    if x.ndim == 5:
        return x[:, 0] if x.shape[1] == 1 else x.mean(dim=1)
    return x


def compute_metrics(pred, target, normalize: bool = True) -> dict:
    """MSE / PSNR / SSIM with the reference's pre-metric max-normalization.
    ``pred`` / ``target``: (B, D, H, W, C) or (B, H, W, C); depth is
    collapsed (the only plane, or the mean over depths).  Values are 0-d
    tensors on the inputs' device."""
    pred = _collapse_depth(as_tensor(pred))
    target = _collapse_depth(as_tensor(target, device=pred.device))
    if normalize:
        pred = max_normalize(pred)
        target = max_normalize(target)
    return {"MSE": mse(pred, target),
            "PSNR": torch.mean(psnr(pred, target)),
            "SSIM": torch.mean(ssim(pred, target))}
