"""Unrolled ADMM / FISTA with learnable per-iteration hyper-parameters
(port of lenslesspicam_tpu/models/unrolled.py).

The JAX package's ``lax.scan`` over the iterations is a Python loop here;
``remat=True`` checkpoints each step (``torch.utils.checkpoint``).  The
schedules are named as in the reference LenslessPiCam modules
(``_mu1_p``, ``_mu2_p``, ``_mu3_p``, ``_tau_p``; FISTA ``_alpha_p``,
``_tk_p``): parameters, or buffers when they are not learned, made
positive with ``abs`` at use.  They lie on the constructor's ``device``
(None: the CUDA card); the convolver and the measurement must lie there
too (a numpy measurement is placed there).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import module_input, resolve_device, same_device
from ..ops.fft_conv import FFTConvolver, filtered_synthesis
from ..ops.tv import finite_diff, finite_diff_adj, finite_diff_gram_spectrum, soft_thresh


def _promote_batch(data):
    if data.ndim == 3:
        return data[None, None]
    if data.ndim == 4:
        return data[None]
    return data


def _run(step, state, per_iter, remat):
    """``state = step(state, *per_iter[i])`` for each i, each step under
    ``torch.utils.checkpoint`` when ``remat``; returns the last state and
    each step's second output."""
    outs = []
    for args in per_iter:
        if remat:
            state, out = checkpoint(step, state, *args, use_reentrant=False)
        else:
            state, out = step(state, *args)
        outs.append(out)
    return state, outs


class UnrolledADMM(nn.Module):
    """Le-ADMM: ADMM (TV prior, non-negativity) unrolled for ``n_iter``
    iterations with learnable mu1, mu2, mu3, tau per iteration.

    ``forward(conv, data)`` takes the unpadded, backward-norm convolver
    (:meth:`make_convolver`) and a measurement ``(B, D, H, W, C)`` and
    returns the cropped, clipped reconstruction of the same shape.  The
    duals are rebuilt each step from ``{v, b, a}`` with the previous
    step's mus (``mu_prev``, ones at the start, where the carries are
    zero), as in the JAX package.
    """

    def __init__(self, n_iter: int = 5, mu1: float = 1e-6, mu2: float = 1e-5,
                 mu3: float = 4e-5, tau: float = 1e-4, learn_params: bool = True,
                 remat: bool = False, device=None):
        super().__init__()
        self.n_iter = n_iter
        self.learn_params = learn_params
        self.remat = remat
        for name, value in (("mu1", mu1), ("mu2", mu2), ("mu3", mu3), ("tau", tau)):
            t = torch.full((n_iter,), value, dtype=torch.float32)
            if learn_params:
                self.register_parameter(f"_{name}_p", nn.Parameter(t))
            else:
                self.register_buffer(f"_{name}_p", t)
        self.to(resolve_device(device))

    @staticmethod
    def make_convolver(psf, dtype=torch.float32, pad_policy="ref", device=None):
        return FFTConvolver.from_psf(psf, pad=False, norm="backward", dtype=dtype,
                                     pad_policy=pad_policy, device=device)

    def forward(self, conv: FFTConvolver, data, psf=None, return_intermediates: bool = False):
        same_device(self._mu1_p.device, conv.H)
        data = _promote_batch(module_input(data, conv.H.device, dtype=None))
        dtype = data.dtype
        ph, pw = conv.padded_spatial_shape
        mag_sq = conv.mag_sq()
        psi_tpsi = finite_diff_gram_spectrum(conv.padded_shape, dtype, data.device)
        ones_pad = conv.pad_input(torch.ones(conv.psf_shape, dtype=dtype, device=data.device))
        data_pad = conv.pad_input(data)
        shape = (data.shape[0],) + tuple(conv.padded_shape)
        zeros = torch.zeros(shape, dtype=dtype, device=data.device)
        state = (zeros, zeros, zeros, zeros, torch.zeros(shape + (2,), dtype=dtype,
                                                        device=data.device),
                 torch.ones(3, dtype=dtype, device=data.device))

        def step(s, mu1, mu2, mu3, tau):
            image, forward_out, v, b, a, (p1, p2, p3) = s
            R_divmat = 1.0 / (mu1 * mag_sq + mu2 * psi_tpsi + mu3)
            X_divmat = 1.0 / (ones_pad + mu1)
            psi = finite_diff(image)
            eta = p2 * psi - a
            xi = p1 * forward_out - v
            rho = p3 * image - b
            U = soft_thresh(psi + eta / mu2, tau / mu2)
            a = mu2 * U - eta
            X = X_divmat * (xi + mu1 * forward_out + data_pad)
            v = mu1 * X - xi
            W = torch.clamp(rho / mu3 + image, min=0.0)
            b = mu3 * W - rho
            rk = b + finite_diff_adj(a) + conv.deconvolve(v)
            image = filtered_synthesis(rk, R_divmat, (ph, pw))
            forward_out = conv.convolve(image)
            out = torch.clamp(conv.crop(image), min=0.0) if return_intermediates else None
            return (image, forward_out, v, b, a, torch.stack([mu1, mu2, mu3])), out

        mus = [torch.abs(getattr(self, f"_{n}_p")) for n in ("mu1", "mu2", "mu3", "tau")]
        state, inters = _run(step, state, list(zip(*mus)), self.remat)
        final = torch.clamp(conv.crop(state[0]), min=0.0)
        if return_intermediates:
            # the estimates of every iteration but the last (recon.py:575-578)
            return final, inters[:-1]
        return final


def _nonneg(x):
    return torch.clamp(x, min=0.0)


class UnrolledFISTA(nn.Module):
    """Unrolled FISTA with learnable per-iteration, per-channel step sizes,
    initialized at ``lip_fact / max |H|^2`` on the first call, and a
    learnable t_k sequence (computed on the host in float64, then cast);
    the half-intensity start (unrolled_fista.py:55-80)."""

    def __init__(self, n_iter: int = 5, tk: float = 1.0, learn_tk: bool = True,
                 learn_params: bool = True, lip_fact: float = 1.8,
                 proj: Callable = _nonneg, remat: bool = False, device=None):
        super().__init__()
        self.n_iter = n_iter
        self.learn_params = learn_params
        self.lip_fact = lip_fact
        self.proj = proj
        self.remat = remat
        tks = [tk]
        for i in range(n_iter):
            tks.append((1 + float(np.sqrt(1 + 4 * tks[i] ** 2))) / 2)
        tk_init = torch.tensor(tks, dtype=torch.float32)
        if learn_tk and learn_params:
            self._tk_p = nn.Parameter(tk_init)
        else:
            self.register_buffer("_tk_p", tk_init)
        # (n_iter, C), made on the first call from the convolver
        self.register_parameter("_alpha_p", None)
        self.to(resolve_device(device))

    @staticmethod
    def make_convolver(psf, dtype=torch.float32, pad_policy="ref", device=None):
        return FFTConvolver.from_psf(psf, pad=True, norm="ortho", dtype=dtype,
                                     pad_policy=pad_policy, device=device)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self._alpha_p is None and prefix + "_alpha_p" in state_dict:
            self._alpha_p = nn.Parameter(torch.empty_like(state_dict[prefix + "_alpha_p"],
                                                          device=self._tk_p.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, conv: FFTConvolver, data, psf, return_intermediates: bool = False):
        same_device(self._tk_p.device, conv.H)
        data = _promote_batch(module_input(data, conv.H.device, dtype=None))
        dtype = data.dtype
        ch = conv.psf_shape[-1]
        alpha0 = self.lip_fact / conv.mag_sq().reshape(-1, ch).amax(dim=0)
        if not self.learn_params:
            alpha = torch.ones((self.n_iter, ch), dtype=dtype, device=data.device) * alpha0
        else:
            if self._alpha_p is None:
                with torch.inference_mode(False):
                    init = torch.ones((self.n_iter, ch), device=data.device) * alpha0.detach()
                    self._alpha_p = nn.Parameter(init.clone())
            alpha = torch.abs(self._alpha_p)
        tk_seq = torch.abs(self._tk_p)

        flat = module_input(psf, data.device, dtype=dtype).reshape(-1, ch)
        pixel_start = (flat.amax(dim=0) + flat.amin(dim=0)) / 2.0
        image = torch.ones((data.shape[0],) + tuple(conv.psf_shape), dtype=dtype,
                           device=data.device) * pixel_start

        def step(carry, a, tk_i, tk_ip1):
            im, xk = carry
            grad = conv.deconvolve(conv.convolve(im) - data)
            im = im - a * grad
            xk_new = self.proj(im)
            im = xk_new + (tk_i - 1.0) / tk_ip1 * (xk_new - xk)
            out = self.proj(im) if return_intermediates else None
            return (im, xk_new), out

        (image, _), inters = _run(step, (image, image),
                                  list(zip(alpha, tk_seq[:-1], tk_seq[1:])), self.remat)
        if return_intermediates:
            return self.proj(image), inters[:-1]
        return self.proj(image)
