"""DiffuserCam-MirFlickr ADMM (port of lenslesspicam_tpu/recon/mirflickr.py):
the same solver with the dataset's post-processing, BGR -> RGB, a
vertical flip and the crop of the Waller-Lab LenslessLearning benchmark."""

from __future__ import annotations

import torch

from .._device import as_tensor
from .base import ADMM


def postprocess(image, device=None) -> torch.Tensor:
    """BGR -> RGB, flip up-down, clip to [0, 1], crop, of an (H, W, C)
    image; a tensor stays on its device."""
    image = as_tensor(image, torch.float32, device)
    out = torch.flip(torch.clamp(torch.flip(image, dims=(-1,)), 0, 1), dims=(0,))
    return out[60:, 62:-38, :]


class ADMM_MIRFLICKR(ADMM):
    """ADMM with the MirFlickr post-processing applied to the output."""

    def apply(self, n_iter=None, **kwargs):
        res = super().apply(n_iter=n_iter, **kwargs)
        if res.shape[0] != 1:
            raise ValueError("expects 2-D reconstruction")
        return postprocess(res[0])
