"""Numpy-facing metric API (port of lenslesspicam_tpu/eval/metric.py).

Single-image metrics with the reference's normalization (both images
divided by their max before comparison), and ``extract``, the ROI and
rescale helper that compares a reconstruction with the displayed image.
MSE and PSNR are host numpy; SSIM and LPIPS run on ``device`` (None: the
CUDA card).
"""

from __future__ import annotations

import numpy as np

from .._device import as_host, as_tensor
from ..data.image import resize as _resize, rotate_bilinear
from . import metrics as _tm


def _prep(est, truth, normalize=True):
    est, truth = as_host(est), as_host(truth)
    if normalize:
        if est.max() > 0:
            est = est / est.max()
        if truth.max() > 0:
            truth = truth / truth.max()
    return est, truth


def mse(true, est, normalize=True):
    """Mean squared error."""
    est, true = _prep(est, true, normalize)
    return float(np.mean((est - true) ** 2))


def psnr(true, est, normalize=True, data_range=1.0):
    """Peak SNR in dB."""
    err = mse(true, est, normalize)
    return float(10 * np.log10(data_range ** 2 / max(err, 1e-20)))


def ssim(true, est, normalize=True, channel_axis=2, device=None):
    """Structural similarity (gaussian window, ``eval.metrics.ssim``)."""
    est, true = _prep(est, true, normalize)
    if est.ndim == 2:
        est, true = est[:, :, None], true[:, :, None]
    val = _tm.ssim(as_tensor(est[None], device=device), as_tensor(true[None], device=device))
    return float(val[0])


def lpips(true, est, normalize=True, lpips_variables=None, net="vgg", device=None):
    """LPIPS perceptual distance; ``lpips_variables`` is an LPIPS
    ``state_dict`` (``eval.lpips``: a converted checkpoint, a fixture file,
    ``convert.lpips_state_dict``)."""
    if lpips_variables is None:
        raise RuntimeError(
            "LPIPS needs VGG weights: load a torch LPIPS checkpoint with "
            "lenslesspicam_tpu_torch.eval.lpips.load_torch_lpips")
    from .lpips import model_from_state_dict

    est, true = _prep(est, true, normalize)
    model = model_from_state_dict(lpips_variables, net, device)
    return float(model(as_tensor(est[None], device=device),
                       as_tensor(true[None], device=device))[0])


def extract(estimate, original, vertical_crop, horizontal_crop, rotation=0, verbose=False):
    """Extract a rotated and cropped region from the reconstruction and
    resize the original to match; returns ``(est_roi, original_resized)``
    as host arrays."""
    estimate = as_host(estimate)
    if rotation:
        estimate = rotate_bilinear(estimate, rotation)
    est_roi = estimate[vertical_crop[0]:vertical_crop[1], horizontal_crop[0]:horizontal_crop[1]]
    original = as_host(original)
    if original.ndim == 2:
        original = original[:, :, None]
    target_shape = est_roi.shape[:2] + (original.shape[-1],)
    orig_resized = _resize(original[None], shape=target_shape)[0]
    if verbose:
        print(f"extracted ROI {est_roi.shape}, original resized {orig_resized.shape}")
    return est_roi, orig_resized
