"""One-shot camera inversions: the FlatNet-style trainable inversion and
PhoCoLens' spatially-varying deconvolution (port of
lenslesspicam_tpu/models/inversion.py), with the camera-inversion
signature ``forward(conv, data, psf)``."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .._device import module_input, resolve_device, same_device
from ..ops.fft_conv import FFTConvolver


class TrainableInversion(nn.Module):
    """Deconvolution by ``conj(H) / (||H||_F^2 + K)`` (the reference's
    global-Frobenius rescale), then a clip at 0.  No parameters of its
    own: it runs on its convolver's device, where the measurement must lie
    (a numpy measurement is placed there)."""

    def __init__(self, K: float = 1e-4):
        super().__init__()
        self.K = K

    @staticmethod
    def make_convolver(psf, dtype=torch.float32, pad_policy="ref", device=None):
        return FFTConvolver.from_psf(psf, pad=True, norm="ortho", dtype=dtype,
                                     pad_policy=pad_policy, device=device)

    def forward(self, conv: FFTConvolver, data, psf=None):
        data = module_input(data, conv.H.device, dtype=None)
        norm_sq = torch.sum(torch.abs(conv.H) ** 2)
        # conv.H carries the folded ifftshift mask (real), so its conjugate
        # is the reference's rescaled adjoint and "convolve" applies it
        scaled = conv.with_filter(torch.conj(conv.H) / (norm_sq + self.K))
        return torch.clamp(scaled.convolve(data), min=0.0)


def compute_weight_matrices(spatial_shape, K: int) -> np.ndarray:
    """Inverse-distance weights to the K x K patch centres, normalized to
    sum to 1 per pixel (sv_deconvnet.py:13-39); (K*K, Nx, Ny) float32."""
    nx, ny = spatial_shape
    centers = [(int((i + 0.5) * nx / K), int((j + 0.5) * ny / K))
               for i in range(K) for j in range(K)]
    Y, X = np.meshgrid(np.arange(ny), np.arange(nx))
    weights = np.stack([((X - cx) ** 2 + (Y - cy) ** 2 + 1e-4) ** (-0.5)
                        for cx, cy in centers])
    weights /= weights.sum(axis=0, keepdims=True)
    return weights.astype(np.float32)


class SVDeconvNet(nn.Module):
    """K x K PSF copies deconvolve the measurement; the outputs are blended
    with fixed inverse-distance weight maps (sv_deconvnet.py:42-84).

    ``multipsf`` is a parameter made on the first call by tiling the PSF
    (or loaded with a state dict); ``learn_multipsf=False`` tiles the
    given PSF on every call instead.  It lies on ``device`` (None: the CUDA
    card), held by an empty buffer until ``multipsf`` exists; the
    convolver and the inputs must lie there too (numpy inputs are placed
    there)."""

    def __init__(self, K: int = 3, learn_multipsf: bool = True, reg: float = 1e-4,
                 device=None):
        super().__init__()
        self.K = K
        self.learn_multipsf = learn_multipsf
        self.reg = reg
        self.register_parameter("multipsf", None)
        self.register_buffer("_anchor", torch.empty(0, device=resolve_device(device)),
                             persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self.multipsf is None and prefix + "multipsf" in state_dict:
            self.multipsf = nn.Parameter(torch.empty_like(state_dict[prefix + "multipsf"],
                                                          device=self._anchor.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, conv: FFTConvolver, data, psf):
        kk = self.K * self.K
        same_device(self._anchor.device, conv.H)
        data = module_input(data, conv.H.device, dtype=None)
        psf = module_input(psf, data.device, dtype=data.dtype)
        nh, nw = psf.shape[-3], psf.shape[-2]
        if not self.learn_multipsf:
            multipsf = psf.repeat(kk, 1, 1, 1)
        else:
            if self.multipsf is None:
                with torch.inference_mode(False):
                    self.multipsf = nn.Parameter(psf.detach().repeat(kk, 1, 1, 1).clone())
            multipsf = self.multipsf
        weights = torch.from_numpy(compute_weight_matrices((nh, nw), self.K)).to(data.device)
        mconv = FFTConvolver.from_psf(multipsf, pad=True, norm="ortho", dtype=data.dtype,
                                      device=data.device)
        # data (B, 1, H, W, C) broadcast over the K*K "depth" of the copies
        out = mconv.deconvolve(data)
        out = torch.sum(weights[None, :, :, :, None] * out, dim=1, keepdim=True)
        return torch.clamp(out, min=0.0)
