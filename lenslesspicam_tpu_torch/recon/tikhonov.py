"""Closed-form Tikhonov reconstruction for separable coded-aperture
systems, FlatCam (port of lenslesspicam_tpu/recon/tikhonov.py).

Measurement model ``Y = P X Q^T``.  The SVDs of P and Q run once, on the
host in float64, when the object is built; ``apply`` runs the analytic
inverse

    X = V_L [ (D_L^T U_L^T Y U_R D_R) / (s_L^2 (x) s_R^2 + lambda) ] V_R^T

on the device as one chain of products over every channel, clips at 0 and
min-max normalizes.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, resolve_device


class CodedApertureReconstruction:
    """Tikhonov solver for ``Y = P X Q^T`` systems.  ``mask`` is any object
    with ``get_conv_matrices(image_shape)`` and ``resolution`` (it is read
    only when ``P`` or ``Q`` is None)."""

    def __init__(self, mask, image_shape, P=None, Q=None, lmbd=3e-4, device=None):
        self.lmbd = float(lmbd)
        if P is None or Q is None:
            P, Q = mask.get_conv_matrices(image_shape)
        P, Q = np.asarray(P, np.float64), np.asarray(Q, np.float64)
        if P.shape != (mask.resolution[0], image_shape[0]):
            raise ValueError("P shape mismatch")
        if Q.shape != (mask.resolution[1], image_shape[1]):
            raise ValueError("Q shape mismatch")
        self._device = resolve_device(device)
        UL, SL, VLh = np.linalg.svd(P, full_matrices=True)
        UR, SR, VRh = np.linalg.svd(Q, full_matrices=True)
        nL, nR = SL.size, SR.size

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self._device)

        # D^T U^T Y U D == diag(S) @ (U^T Y U)[:n, :n] @ diag(S)
        self.UL, self.SL, self.VL = t(UL[:, :nL]), t(SL), t(VLh.T[:, :nL])
        self.UR, self.SR, self.VR = t(UR[:, :nR]), t(SR), t(VRh.T[:, :nR])

    def apply(self, img):
        """Reconstruct from an (H, W, C) measurement; returns (H', W', C)
        min-max normalized."""
        img = as_tensor(img, torch.float32, self._device)
        if img.ndim != 3:
            raise ValueError("measurement must be (H, W, C)")
        Y = torch.movedim(img, -1, 0)
        core = torch.einsum("hm,chw,wn->cmn", self.UL, Y, self.UR)
        core = self.SL[None, :, None] * core * self.SR[None, None, :]
        denom = torch.outer(self.SL ** 2, self.SR ** 2) + self.lmbd
        X = torch.einsum("hm,cmn,wn->chw", self.VL, core / denom[None], self.VR)
        X = torch.clamp(torch.movedim(X, 0, -1), min=0.0)
        return (X - X.min()) / (X.max() - X.min())
