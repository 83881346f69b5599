"""ADMM with TV prior and non-negativity: the exact solver (port of
lenslesspicam_tpu/recon/admm.py:43-275), and its plug-and-play form
:func:`run_pnp`.

All state lives on the padded grid.  The accumulating duals are never
carried: each is rebuilt in :func:`step` from one identity (xi = mu1*fwd
- v, rho = mu3*image - b, eta = mu2*psi - a).  Four real FFTs per
iteration through ``torch.fft`` (cuFFT on the card); this solver is the
port's oracle for the fused one in ``admm_split``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.fft_conv import FFTConvolver, filtered_synthesis
from ..ops.tv import (finite_diff, finite_diff_adj, finite_diff_gram_spectrum,
                      soft_thresh)


class ADMMParams(NamedTuple):
    """Hyper-parameters (reference admm.py:39-42 defaults)."""

    mu1: float = 1e-6
    mu2: float = 1e-5
    mu3: float = 4e-5
    tau: float = 1e-4


class ADMMPrecomp(NamedTuple):
    """Loop-invariant tensors."""

    R_divmat: torch.Tensor   # real (D, Ph, Pw/2+1, C)
    X_divmat: torch.Tensor   # real (D, Ph, Pw, C)
    data_pad: torch.Tensor   # (B, D, Ph, Pw, C)


class ADMMState(NamedTuple):
    """Carry-rebuild state (see the module docstring)."""

    image_est: torch.Tensor
    forward_out: torch.Tensor
    v: torch.Tensor          # mu1*X - xi of the previous iteration
    b: torch.Tensor          # mu3*W - rho of the previous iteration
    a: torch.Tensor          # mu2*U - eta of the previous iteration (2ch)


def make_convolver(psf, dtype=torch.float32, pad_policy: str = "ref",
                   device=None) -> FFTConvolver:
    """ADMM's convolver: unpadded, backward norm."""
    return FFTConvolver.from_psf(psf, pad=False, norm="backward", dtype=dtype,
                                 pad_policy=pad_policy, device=device)


def _as_5d(data, conv: FFTConvolver):
    data = torch.as_tensor(data, dtype=conv.H.real.dtype).to(conv.H.device)
    if data.ndim == 3:
        data = data[None, None]
    elif data.ndim == 4:
        data = data[None]
    return data


def precompute(conv: FFTConvolver, data, params: ADMMParams) -> ADMMPrecomp:
    """Loop-invariant operators plus the padded measurement."""
    dtype = conv.H.real.dtype
    psi_tpsi = finite_diff_gram_spectrum(conv.padded_shape, dtype, conv.H.device)
    R_divmat = 1.0 / (params.mu1 * conv.mag_sq() + params.mu2 * psi_tpsi + params.mu3)
    ones = torch.ones(conv.psf_shape, dtype=dtype, device=conv.H.device)
    X_divmat = 1.0 / (conv.pad_input(ones) + params.mu1)
    data_pad = conv.pad_input(_as_5d(data, conv))
    return ADMMPrecomp(R_divmat.to(dtype), X_divmat.to(dtype), data_pad)


def init_state(conv: FFTConvolver, batch_size: int = 1, initial_est=None,
               params: ADMMParams = ADMMParams()) -> ADMMState:
    """Zero-dual state on the padded grid."""
    dtype = conv.H.real.dtype
    device = conv.H.device
    shape = (batch_size,) + tuple(conv.padded_shape)
    if initial_est is not None:
        image = torch.as_tensor(initial_est, dtype=dtype).to(device).expand(shape)
        forward_out = conv.convolve(image)
        psi0 = finite_diff(image)
    else:
        image = torch.zeros(shape, dtype=dtype, device=device)
        forward_out = torch.zeros(shape, dtype=dtype, device=device)
        psi0 = torch.zeros(shape + (2,), dtype=dtype, device=device)
    return ADMMState(image, forward_out, params.mu1 * forward_out,
                     params.mu3 * image, params.mu2 * psi0)


def step(state: ADMMState, conv: FFTConvolver, pre: ADMMPrecomp,
         params: ADMMParams) -> ADMMState:
    """One ADMM iteration: 4 padded-grid real FFTs (the deconvolve term of
    rk is added in the frequency domain, and the forward convolve reuses
    the image's spectrum)."""
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau
    ph, pw = conv.padded_spatial_shape

    psi = finite_diff(state.image_est)
    eta_eff = mu2 * psi - state.a
    xi = mu1 * state.forward_out - state.v
    rho = mu3 * state.image_est - state.b

    U = soft_thresh(psi + eta_eff / mu2, tau / mu2)
    a = mu2 * U - eta_eff
    X = pre.X_divmat * (xi + mu1 * state.forward_out + pre.data_pad)
    v = mu1 * X - xi
    W = torch.clamp(rho / mu3 + state.image_est, min=0.0)
    b = mu3 * W - rho
    rk_spatial = b + finite_diff_adj(a)
    F_rk = (torch.fft.rfft2(rk_spatial, dim=(-3, -2))
            + torch.conj(conv.H) * torch.fft.rfft2(v, dim=(-3, -2)))
    F_image = pre.R_divmat * F_rk
    image_est = torch.fft.irfft2(F_image, s=(ph, pw), dim=(-3, -2))
    forward_out = torch.fft.irfft2(F_image * conv.H, s=(ph, pw), dim=(-3, -2))
    return ADMMState(image_est, forward_out, v, b, a)


def form_image(state: ADMMState, conv: FFTConvolver):
    """Crop to the sensor grid and clip negatives."""
    return torch.clamp(conv.crop(state.image_est), min=0.0)


def run_state(conv: FFTConvolver, data, params: ADMMParams = ADMMParams(),
              n_iter: int = 100, state: ADMMState | None = None,
              initial_est=None):
    """Run ``n_iter`` steps from ``state`` (or a fresh state) and return
    ``(image, state)``; the image is ``(batch, depth, H, W, C)``."""
    pre = precompute(conv, data, params)
    if state is None:
        state = init_state(conv, pre.data_pad.shape[0], initial_est, params)
    for _ in range(int(n_iter)):
        state = step(state, conv, pre, params)
    return form_image(state, conv), state


def run(conv: FFTConvolver, data, params: ADMMParams = ADMMParams(),
        n_iter: int = 100, initial_est=None):
    """Full reconstruction: returns ``(batch, depth, H, W, C)``."""
    return run_state(conv, data, params, n_iter, initial_est=initial_est)[0]


def run_state_jit(conv, data, params, n_iter, state):
    """The JAX package's compiled entry of :func:`run_state` under its
    name and signature.  The port has no trace step: this runs
    :func:`run_state` where its inputs are, and exists so that code written
    for the JAX package runs.  ``n_iter`` is an int or a 0-d tensor."""
    return run_state(conv, data, params, n_iter, state)


# the JAX package's compiled entry of ``run``, whose signature and defaults
# ``run`` already has: the port has no trace step, and the name exists so
# that code written for the JAX package runs (``n_iter`` an int or a 0-d
# tensor)
run_jit = run


def run_pnp(conv: FFTConvolver, data, denoiser, params: ADMMParams = ADMMParams(),
            n_iter: int = 100, noise_level: float = 10.0, use_dual: bool = False,
            initial_est=None):
    """Plug-and-play ADMM: the TV prox is replaced by a denoiser.

    ``denoiser(image, noise_level) -> image`` works on the padded grid
    (B, D, Ph, Pw, C).  With ``use_dual`` the denoiser takes ``U + eta /
    mu2`` and the eta dual is tracked; otherwise it denoises the current
    image estimate and eta stays zero.  Returns the cropped image
    ``(batch, depth, H, W, C)`` clipped at 0."""
    mu1, mu2, mu3 = params.mu1, params.mu2, params.mu3
    pre = precompute(conv, data, params)
    shape = (pre.data_pad.shape[0],) + tuple(conv.padded_shape)
    ph, pw = conv.padded_spatial_shape
    dtype, device = conv.H.real.dtype, conv.H.device
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    # U and eta are image-shaped here (Psi is the identity)
    if initial_est is not None:
        image = torch.as_tensor(initial_est, dtype=dtype).to(device).expand(shape)
        forward_out = conv.convolve(image)
    else:
        image, forward_out = zeros, zeros
    U, xi, eta, rho = zeros, zeros, zeros, zeros
    for _ in range(int(n_iter)):
        U = denoiser(U + eta / mu2 if use_dual else image, noise_level)
        X = pre.X_divmat * (xi + mu1 * forward_out + pre.data_pad)
        W = torch.clamp(rho / mu3 + image, min=0.0)
        prior = mu2 * U - eta if use_dual else mu2 * U
        rk = (mu3 * W - rho) + prior + conv.deconvolve(mu1 * X - xi)
        image = filtered_synthesis(rk, pre.R_divmat, (ph, pw))
        forward_out = conv.convolve(image)
        if use_dual:
            eta = eta + mu2 * (image - U)
        xi = xi + mu1 * (forward_out - X)
        rho = rho + mu3 * (image - W)
    return torch.clamp(conv.crop(image), min=0.0)
