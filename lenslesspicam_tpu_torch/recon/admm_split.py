"""Fused half-spectrum ADMM: the system's hot path (port of
lenslesspicam_tpu/recon/admm_split.py:205-442, v3 placement, f32 io
and carries).

Spatial planes ride in the even/odd split lane layout; spectra, filter
constants and all H-axis work are half width (``ops/split_fft.py``).
The packed DC/Nyquist lane (Z[0] + i Z[M]) is not separable under the
filter multiply, so its two spatial columns are convolved exactly on the
side with ``torch.fft`` (``dc_patch``) and patched in before the inverse.
One iteration is K3 ``e1_rtv`` -> ``dc_patch`` -> K4/K5/K4
``fft_h_combine_dual`` -> K6 ``irfft_w_dual_state``; K1 ``rfft_w`` runs
once before the loop.  The state algebra is the exact solver's
(``recon/admm.py``) with the TV dual update deferred to the next
iteration's K3, which holds the new image and its halo rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import kernels
from ..ops import split_fft as sf
from ..ops.padding import padded_size
from .admm import ADMMParams


class RSplitPrecomp(NamedTuple):
    Hr: torch.Tensor        # (Ph, Pw/2) half-spectrum planes, split order
    Hi: torch.Tensor
    R: torch.Tensor
    mask: torch.Tensor      # (Ph, Pw) {0,1} support mask, split lane layout
    data_pad: torch.Tensor
    H0r: torch.Tensor       # (Ph,) filter columns at kw = 0 / M
    H0i: torch.Tensor
    HMr: torch.Tensor
    HMi: torch.Tensor
    R0: torch.Tensor        # (Ph,)
    RM: torch.Tensor
    psf_shape: tuple
    padded_shape: tuple
    start: tuple


ARRAY_FIELDS = ("Hr", "Hi", "R", "mask", "data_pad",
                "H0r", "H0i", "HMr", "HMi", "R0", "RM")


def precompute_rsplit_np(psf2d: np.ndarray, data2d: np.ndarray,
                         params: ADMMParams = ADMMParams()) -> dict:
    """The loop-invariant arrays as numpy, computed exactly as the JAX
    package computes them (so both start from identical constants)."""
    nh, nw = psf2d.shape
    ph, pw = padded_size(nh), padded_size(nw)
    if ph % 2 or pw % 2:
        raise ValueError(f"padded grid {ph}x{pw} must be even on both axes")
    sy, sx = (ph - nh) // 2, (pw - nw) // 2
    mh = pw // 2

    pad = np.zeros((ph, pw), np.float32)
    pad[sy : sy + nh, sx : sx + nw] = psf2d
    H_nat = np.fft.fft2(pad).astype(np.complex64)
    mask = np.outer((-1.0) ** np.arange(ph), (-1.0) ** np.arange(pw)).astype(np.float32)
    H_nat = H_nat * mask

    kern = np.zeros((ph, pw), np.float32)
    kern[0, 0] = 4.0
    kern[0, 1] = kern[0, -1] = kern[1, 0] = kern[-1, 0] = -1.0
    psi = np.abs(np.fft.fft2(kern))
    R_nat = 1.0 / (params.mu1 * np.abs(H_nat) ** 2 + params.mu2 * psi + params.mu3)
    R_nat = R_nat.astype(np.float32)

    H_half = sf.spectrum_to_half_split(H_nat)
    R_half = sf.spectrum_to_half_split(R_nat)

    def to_split(x):
        return np.ascontiguousarray(np.concatenate([x[:, 0::2], x[:, 1::2]], axis=1))

    ones_pad = np.zeros((ph, pw), np.float32)
    ones_pad[sy : sy + nh, sx : sx + nw] = 1.0
    data_pad = np.zeros((ph, pw), np.float32)
    data_pad[sy : sy + nh, sx : sx + nw] = data2d

    c = np.ascontiguousarray
    return dict(
        Hr=c(H_half.real), Hi=c(H_half.imag), R=c(R_half),
        mask=to_split(ones_pad), data_pad=to_split(data_pad),
        H0r=c(H_nat[:, 0].real), H0i=c(H_nat[:, 0].imag),
        HMr=c(H_nat[:, mh].real), HMi=c(H_nat[:, mh].imag),
        R0=c(R_nat[:, 0]), RM=c(R_nat[:, mh]),
        psf_shape=(nh, nw), padded_shape=(ph, pw), start=(sy, sx),
    )


def precompute_rsplit(psf2d, data2d, params: ADMMParams = ADMMParams(),
                      device=None) -> RSplitPrecomp:
    """Half-spectrum precompute for a (H, W) grayscale PSF and
    measurement, placed on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    arrs = precompute_rsplit_np(np.asarray(psf2d, np.float32),
                                np.asarray(data2d, np.float32), params)
    return RSplitPrecomp(
        *[torch.from_numpy(arrs[f]).to(device) for f in ARRAY_FIELDS],
        psf_shape=arrs["psf_shape"], padded_shape=arrs["padded_shape"],
        start=arrs["start"])


def run_split_rfused(pre: RSplitPrecomp, params: ADMMParams = ADMMParams(),
                     n_iter: int = 100, return_sat: bool = False, ops=None):
    """Grayscale ADMM on the half-spectrum fused path; returns the cropped,
    clipped (H, W) image, and with ``return_sat`` also the running max of
    the carry-saturation channel (0.0: f32 carries cannot clip).

    ``ops`` is the kernel set, ``kernels.KERNELS`` by default;
    ``kernels.PLAIN`` runs the same loop through the plain PyTorch
    versions, against which the kernels are held on the card."""
    ops = ops or kernels.KERNELS
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau
    ph, pw = pre.padded_shape
    dev = pre.Hr.device
    H0 = torch.complex(pre.H0r, pre.H0i)
    HM = torch.complex(pre.HMr, pre.HMi)

    def dc_patch(rkr, rki, vr, vi):
        # exact DC (kw = 0) and Nyquist (kw = M) columns, convolved on the
        # side: one batched length-ph FFT for the four analysis columns
        # and one for the four synthesis columns
        cols = torch.stack([rkr[:, 0], rki[:, 0], vr[:, 0], vi[:, 0]])
        A0, AM, B0, BM = torch.fft.fft(cols, dim=-1)
        F0 = pre.R0 * (A0 + torch.conj(H0) * B0)
        FM = pre.RM * (AM + torch.conj(HM) * BM)
        outs = torch.fft.ifft(torch.stack([F0, FM, H0 * F0, HM * FM]),
                              dim=-1).real.contiguous()
        return outs[0], outs[1], outs[2], outs[3]

    # iteration-0 v carry: with all other state zero the first X update
    # gives v = mu1 * X_divmat * data
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
    xdv = c_out + (c_in - c_out) * pre.mask
    v_init = mu1 * xdv * pre.data_pad
    vwr, vwi = ops.rfft_w(v_init)
    v = kernels.encode_v(v_init, mu1)
    zeros = torch.zeros((ph, pw), dtype=torch.float32, device=dev)
    image, a0, a1, b = zeros, zeros, zeros, zeros
    sat = 0.0
    for _ in range(int(n_iter)):
        rkr, rki, a0, a1, b, sat_tv = ops.e1_rtv(image, a0, a1, b, mu2, mu3, tau)
        i0, iM, f0, fM = dc_patch(rkr, rki, vwr, vwi)
        (a0r, a0i), (a1r, a1i) = kernels.fft_h_combine_dual(
            rkr, rki, vwr, vwi, pre.Hr, pre.Hi, pre.R, ph, ops=ops)
        image, v, vwr, vwi = ops.irfft_w_dual_state(
            a0r, a0i, a1r, a1i, i0, iM, f0, fM, v, pre.mask, pre.data_pad, mu1)
        sat = max(sat, sat_tv)
    img = sf.from_split_layout(image)
    sy, sx = pre.start
    nh, nw = pre.psf_shape
    out = torch.clamp(img[sy : sy + nh, sx : sx + nw], min=0.0)
    if return_sat:
        return out, sat
    return out


def run_rsplit(pre: RSplitPrecomp, params: ADMMParams = ADMMParams(),
               n_iter: int = 100, return_sat: bool = False):
    """Entry of the half-spectrum fused solver (the JAX package's
    ``run_rsplit_jit``)."""
    return run_split_rfused(pre, params, n_iter, return_sat=return_sat)
