"""Free-space wave propagation on ``torch.fft`` (port of
lenslesspicam_tpu/ops/propagation.py): bandlimited angular spectrum,
Fresnel transfer-function propagation, spherical point-source wavefronts.

Conventions: fields are complex tensors (..., H, W); ``pitch`` is the
sampling pitch (dy, dx) in meters; ``wv`` the wavelength in meters; ``dz``
the propagation distance in meters.  A field is complex64 (a real or
complex64 input) or complex128 (a complex128 input), and the transfer
function is computed in the matching real precision, with ``wv`` and
``dz`` rounded to it first.  In float32 each step rounds as the JAX
package's compiled code rounds it (``_kz_arg``, ``_sqrt``): the phase
``kz dz`` reaches 1e4 rad and more, where one unit in the last place of
float32 is 1e-3 rad, so a phase rounded otherwise would move the field by
far more than float32 round-off.  A tensor
input stays on its device; anything else goes to ``device`` (None: the
CUDA card).  The functions are differentiable with respect to the field.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device


def _freq_grids(shape, pitch):
    ny, nx = shape
    fy = np.fft.fftfreq(ny, d=pitch[0])
    fx = np.fft.fftfreq(nx, d=pitch[1])
    return np.meshgrid(fy, fx, indexing="ij")


def _field(u_in, device):
    if isinstance(u_in, torch.Tensor):
        u = u_in if device is None else u_in.to(resolve_device(device))
    else:
        u = torch.from_numpy(np.array(u_in)).to(resolve_device(device))
    return u if u.dtype in (torch.complex64, torch.complex128) else u.to(torch.complex64)


def _real(u):
    return torch.float64 if u.dtype == torch.complex128 else torch.float32


def _scalar(x, like):
    return torch.as_tensor(x, dtype=_real(like), device=like.device)


def _sqrt(x):
    """sqrt correctly rounded (float32 through float64: torch's
    vectorized float32 sqrt on the CPU can land one unit lower)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _kz_arg(wv, fxx, fyy):
    """``1 - (wv fx)^2 - (wv fy)^2`` as XLA evaluates the JAX expression
    in float32: ``wv^2`` times the folded constants ``fx^2`` and ``fy^2``,
    each product fused with its subtraction (one rounding each)."""
    w2, fx2, fy2 = wv * wv, fxx * fxx, fyy * fyy
    if wv.dtype == torch.float64:
        return 1.0 - w2 * fx2 - w2 * fy2
    t = (1.0 - w2.double() * fx2.double()).float()
    return (t.double() - w2.double() * fy2.double()).float()


def _grids(shape, pitch, like):
    return [torch.from_numpy(g).to(device=like.device, dtype=_real(like))
            for g in _freq_grids(shape, pitch)]


def _pad(u_in, pad):
    ny, nx = u_in.shape[-2], u_in.shape[-1]
    if not pad:
        return u_in, None
    py, px = ny // 2, nx // 2
    return F.pad(u_in, (px, px, py, py)), (py, px, ny, nx)


def _propagate(u, H, crop):
    u_out = torch.fft.ifft2(torch.fft.fft2(u, dim=(-2, -1)) * H, dim=(-2, -1))
    if crop is not None:
        py, px, ny, nx = crop
        u_out = u_out[..., py:py + ny, px:px + nx]
    return u_out


def angular_spectrum(u_in, wv, pitch, dz, pad: bool = True, bandlimit: bool = True,
                     device=None):
    """Bandlimited angular-spectrum propagation (Matsushima & Shimobaba
    2009) of the complex (..., H, W) field ``u_in`` over ``dz``."""
    u, crop = _pad(_field(u_in, device), pad)
    Ny, Nx = u.shape[-2], u.shape[-1]
    fyy, fxx = _grids((Ny, Nx), pitch, u)
    wv, dz = _scalar(wv, u), _scalar(dz, u)

    arg = _kz_arg(wv, fxx, fyy)
    kz = _scalar(2.0 * math.pi, u) / wv * _sqrt(torch.clamp(arg, min=0.0))
    H = torch.where(arg > 0, torch.exp(1j * (kz * torch.abs(dz))), 0.0).to(u.dtype)
    H = torch.where(dz >= 0, H, torch.conj(H))

    if bandlimit:
        # Matsushima's bandlimit: |fx| <= 1 / (wv sqrt((2 dz dfx)^2 + 1))
        dfx = 1.0 / (Nx * pitch[1])
        dfy = 1.0 / (Ny * pitch[0])
        fx_lim = 1.0 / (wv * _sqrt((2.0 * dfx * torch.abs(dz)) ** 2 + 1.0))
        fy_lim = 1.0 / (wv * _sqrt((2.0 * dfy * torch.abs(dz)) ** 2 + 1.0))
        H = torch.where((torch.abs(fxx) <= fx_lim) & (torch.abs(fyy) <= fy_lim), H, 0.0)
    return _propagate(u, H, crop)


def fresnel_conv(u_in, wv, pitch, dz, pad: bool = True, device=None):
    """Fresnel propagation of the complex (..., H, W) field ``u_in`` by the
    transfer function ``exp(i k dz) exp(-i pi wv dz (fx^2 + fy^2))``."""
    u, crop = _pad(_field(u_in, device), pad)
    fyy, fxx = _grids(u.shape[-2:], pitch, u)
    wv, dz = _scalar(wv, u), _scalar(dz, u)
    k = _scalar(2.0 * math.pi, u) / wv
    H = torch.exp(1j * (k * dz)) * torch.exp(
        1j * (((-math.pi * wv) * dz) * (fxx ** 2 + fyy ** 2)))
    return _propagate(u, H.to(u.dtype), crop)


def spherical_wavefront(shape, pitch, wv, dz, dtype=torch.complex64, device=None):
    """Spherical wavefront from an on-axis point source at distance ``dz``:
    exp(i k r) / r on the (H, W) grid, normalized to a peak amplitude of
    1, as a ``dtype`` tensor on ``device`` (None: the CUDA card)."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    device = resolve_device(device)
    ny, nx = shape
    y = (np.arange(ny) - (ny - 1) / 2.0) * pitch[0]
    x = (np.arange(nx) - (nx - 1) / 2.0) * pitch[1]
    yy, xx = (torch.from_numpy(g).to(device=device, dtype=real)
              for g in np.meshgrid(y, x, indexing="ij"))
    wv, dz = (torch.as_tensor(v, dtype=real, device=device) for v in (wv, dz))
    r = _sqrt(dz * dz + (yy * yy + xx * xx))
    k = torch.as_tensor(2.0 * math.pi, dtype=real, device=device) / wv
    field = torch.exp(1j * (k * r)) / r
    return field / torch.max(torch.abs(field))
