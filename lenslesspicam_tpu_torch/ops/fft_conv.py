"""Real-FFT 2-D convolution operator (port of
lenslesspicam_tpu/ops/fft_conv.py:96-266).

Layout ``(depth, H, W, C)`` for PSFs and ``(batch, depth, H, W, C)`` for
data.  Each spatial dim is padded to at least ``2N - 1`` so circular
convolution equals linear convolution.  When both padded sizes are even
the trailing ``ifftshift`` is folded into ``H`` as the real
``(-1)^(ky + kx)`` mask, so ``deconvolve`` uses ``conj(H)`` of the same
stored spectrum.  ``norm`` applies to ``H`` only: the data's FFTs keep
the backward norm, as in the JAX package (and the reference's
``RealFFTConvolve2D``).  ``filtered_synthesis`` has the JAX package's
hand-written backward (fft_conv.py:49-93): the adjoint of a circular
convolution is the circular convolution with ``conj(H)``, so the backward
runs the forward's FFT pattern again and keeps only ``rfft2(x)`` and
``H`` from the forward.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .padding import padded_size


class _FilteredSynthesis(torch.autograd.Function):
    """``irfft2(rfft2(x) * H)`` with the JAX package's VJP: ``dx =
    irfft2(rfft2(g) conj(H))`` and JAX's spectrum cotangent ``w / N
    conj(rfft2(g)) rfft2(x)``, ``w`` the half-spectrum weights (1 at DC
    and, for an even width, at Nyquist, 2 elsewhere), summed over the axes
    ``H`` was broadcast along and made real for a real ``H``.  PyTorch's
    gradient of a complex tensor is the conjugate of JAX's cotangent, so
    ``dH`` is ``w / N rfft2(g) conj(rfft2(x))``."""

    @staticmethod
    def forward(ctx, x, H, s):
        X = torch.fft.rfft2(x, dim=(-3, -2))
        ctx.save_for_backward(X, H)
        ctx.s = s
        return torch.fft.irfft2(X * H, s=s, dim=(-3, -2))

    @staticmethod
    def backward(ctx, g):
        X, H = ctx.saved_tensors
        ph, pw = ctx.s
        G = torch.fft.rfft2(g, dim=(-3, -2))
        dx = dH = None
        if ctx.needs_input_grad[0]:
            dx = torch.fft.irfft2(G * torch.conj(H), s=ctx.s, dim=(-3, -2))
        if ctx.needs_input_grad[1]:
            w = torch.full((pw // 2 + 1,), 2.0, device=G.device)
            w[0] = 1.0
            if pw % 2 == 0:
                w[-1] = 1.0
            dH = (w[None, :, None] / (ph * pw)) * G * torch.conj(X)
            extra = dH.ndim - H.ndim
            if extra:
                dH = dH.sum(dim=tuple(range(extra)))
            for axis, (da, hb) in enumerate(zip(dH.shape, H.shape)):
                if hb == 1 and da != 1:
                    dH = dH.sum(dim=axis, keepdim=True)
            if not H.is_complex():
                dH = dH.real     # a real filter (ADMM's R_divmat): a real cotangent
            dH = dH.to(H.dtype)
        return dx, dH, None


def filtered_synthesis(x, H, s):
    """``irfft2(rfft2(x) * H)`` over axes (-3, -2), differentiated by the
    hand-written backward of :class:`_FilteredSynthesis`."""
    return _FilteredSynthesis.apply(x, H, tuple(s))


def _spatial_pad(x, pad_widths):
    """Zero-pad the two spatial axes (-3, -2) by the given (lo, hi) pairs."""
    (ylo, yhi), (xlo, xhi) = pad_widths
    return F.pad(x, (0, 0, xlo, xhi, ylo, yhi))


def _compute_spectrum(psf, pad_widths, norm, fold):
    H = torch.fft.rfft2(_spatial_pad(psf, pad_widths), dim=(-3, -2), norm=norm)
    if fold:
        ph = psf.shape[-3] + pad_widths[0][0] + pad_widths[0][1]
        pw = psf.shape[-2] + pad_widths[1][0] + pad_widths[1][1]
        ky = 1.0 - 2.0 * (torch.arange(ph, device=psf.device) % 2).float()
        kx = 1.0 - 2.0 * (torch.arange(pw // 2 + 1, device=psf.device) % 2).float()
        H = H * (ky[:, None] * kx[None, :])[:, :, None]
    return H


@dataclasses.dataclass(frozen=True)
class FFTConvolver:
    """Precomputed frequency-domain convolution operator.

    H : complex tensor ``(depth, Ph, Pw // 2 + 1, C)``, rfft2 of the
        padded PSF, with the ifftshift mask folded in when
        ``shift_folded``.
    psf_shape, padded_shape : ``(depth, H, W, C)`` tuples.
    start : ``(sy, sx)`` top-left crop index on the padded grid.
    pad : whether convolve/deconvolve pad (and crop) their input.
    norm : FFT norm applied to ``H`` only.
    """

    H: torch.Tensor
    psf_shape: tuple
    padded_shape: tuple
    start: tuple
    pad: bool
    norm: str
    shift_folded: bool

    @staticmethod
    def from_psf(psf, pad=True, norm="ortho", dtype=torch.float32,
                 pad_policy="ref", device=None) -> "FFTConvolver":
        """Build the operator from a ``(depth, H, W, C)`` PSF on ``device``
        (None: the CUDA card)."""
        device = resolve_device(device)
        psf = torch.as_tensor(psf, dtype=dtype).to(device)
        if psf.ndim not in (4, 5):
            raise ValueError("PSF must be (depth, H, W, C) or batched (B, depth, H, W, C)")
        if psf.shape[-1] not in (1, 3):
            raise ValueError("PSF must be grayscale (1) or rgb (3)")
        depth, nh, nw, ch = psf.shape[-4:]
        ph = padded_size(nh, pad_policy)
        pw = padded_size(nw, pad_policy)
        sy, sx = (ph - nh) // 2, (pw - nw) // 2
        pad_widths = ((sy, ph - nh - sy), (sx, pw - nw - sx))
        shift_folded = ph % 2 == 0 and pw % 2 == 0
        return FFTConvolver(
            H=_compute_spectrum(psf, pad_widths, norm, shift_folded),
            psf_shape=tuple(psf.shape),
            padded_shape=(depth, ph, pw, ch),
            start=(sy, sx),
            pad=pad,
            norm=norm,
            shift_folded=shift_folded,
        )

    @property
    def spatial_shape(self):
        return self.psf_shape[-3:-1]

    @property
    def padded_spatial_shape(self):
        return self.padded_shape[-3:-1]

    def pad_input(self, x):
        """Center-place ``x`` on the padded grid."""
        nh, nw = self.spatial_shape
        ph, pw = self.padded_spatial_shape
        sy, sx = self.start
        return _spatial_pad(x, ((sy, ph - nh - sy), (sx, pw - nw - sx)))

    def crop(self, x):
        """Center-crop from the padded grid."""
        nh, nw = self.spatial_shape
        sy, sx = self.start
        return x[..., sy : sy + nh, sx : sx + nw, :]

    def _apply_filter(self, x, filter_freq):
        if self.pad:
            x = self.pad_input(x)
        ph, pw = self.padded_spatial_shape
        out = filtered_synthesis(x, filter_freq, (ph, pw))
        if not self.shift_folded:
            out = torch.roll(out, (-(ph // 2), -(pw // 2)), dims=(-3, -2))
        if self.pad:
            out = self.crop(out)
        return out

    def convolve(self, x):
        """Forward model ``H x``."""
        return self._apply_filter(x, self.H)

    def deconvolve(self, y):
        """Adjoint ``H^T y``."""
        return self._apply_filter(y, torch.conj(self.H))

    def convolve_fft(self, x):
        """Frequency-domain output ``rfft2(pad(x)) * H`` (the reference's
        return_fft path; with ``shift_folded`` it carries the sign mask)."""
        if self.pad:
            x = self.pad_input(x)
        return torch.fft.rfft2(x, dim=(-3, -2)) * self.H

    def mag_sq(self):
        """|H|^2, real."""
        return torch.real(self.H * torch.conj(self.H))

    def with_filter(self, H_new) -> "FFTConvolver":
        """Same geometry, another frequency response (e.g. Wiener)."""
        return dataclasses.replace(self, H=H_new)


def make_convolver(psf, **kwargs) -> FFTConvolver:
    """Convenience alias for :meth:`FFTConvolver.from_psf`."""
    return FFTConvolver.from_psf(psf, **kwargs)
