"""Split-order DFT layout, the full-width complex transforms and the
packed-real W transform in plain PyTorch (port of
lenslesspicam_tpu/ops/pallas_fft.py:53-94, 111-268, 296-436).

A length-n axis is factored n = n1 * n2 (``_factor``).  The two-stage
transform leaves frequency k = k1 + n1 * k2 at position (k1, k2), the
"split order"; spectra stay in that order everywhere and the filter
constants are permuted into it once on the host.

Spatial rows ride in the even/odd split lane layout ``[x[0::2] |
x[1::2]]``: the packed complex row p = x_even + i x_odd is one size-M =
N/2 complex transform, unpacked to the half spectrum Z[0..M-1] with the
mirror P[(M - k) mod M], whose split coordinates are ((-k1) mod n1,
n2-1-k2) and, on row k1 = 0, (0, (-k2) mod n2).  Z[M] rides in Im of
lane 0.

The host plans are numpy, built in float64 and cast to f32 exactly as
the JAX package builds them, so both packages start from the same
constants.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _factor(n: int):
    """n = n1 * n2 with n2 a multiple of 128 when possible."""
    best = None
    for n2 in range(1, n + 1):
        if n % n2:
            continue
        n1 = n // n2
        if n1 > 512:
            continue
        lane_bonus = 0 if n2 % 128 == 0 else 512
        score = abs(n1 - n2) + lane_bonus
        if best is None or score < best[0]:
            best = (score, n1, n2)
    return best[1], best[2]


@lru_cache(maxsize=None)
def _plan(n: int, inverse: bool):
    """DFT matrices F1 (k1, j1), F2 (j2, k2) and twiddles T (k1, j2) as
    f32 (real, imag) pairs, plus the scale and the factors."""
    n1, n2 = _factor(n)
    sign = 2j * np.pi / n if inverse else -2j * np.pi / n
    j1 = np.arange(n1)
    j2 = np.arange(n2)
    F1 = np.exp(sign * n2 * np.outer(j1, j1)).astype(np.complex64)
    F2 = np.exp(sign * n1 * np.outer(j2, j2)).astype(np.complex64)
    T = np.exp(sign * np.outer(j1, j2)).astype(np.complex64)
    scale = np.float32(1.0 / n if inverse else 1.0)
    return (
        F1.real.copy(), F1.imag.copy(),
        F2.real.copy(), F2.imag.copy(),
        T.real.copy(), T.imag.copy(),
        scale, n1, n2,
    )


def split_order_indices(n: int) -> np.ndarray:
    """Permutation p with split[pos] = natural[p[pos]]: position
    (k1, k2) holds frequency k1 + n1 * k2."""
    n1, n2 = _factor(n)
    k1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    return (k1 + n1 * k2).reshape(-1)


def spectrum_to_split(spec_full: np.ndarray, axes=(-2, -1)) -> np.ndarray:
    """Reindex a natural-order full spectrum into split order on axes."""
    out = np.asarray(spec_full)
    for ax in axes:
        out = np.take(out, split_order_indices(out.shape[ax]), axis=ax)
    return out


def spectrum_to_half_split(spec_full: np.ndarray) -> np.ndarray:
    """(H, W) natural-order full spectrum -> (H, W/2) plane: W restricted
    to frequencies 0..M-1 in the size-M split order, H in the size-H
    split order (the filter layout of the half-spectrum pipeline)."""
    h, w_full = np.asarray(spec_full).shape
    m = w_full // 2
    half = np.take(np.asarray(spec_full)[:, :m], split_order_indices(m), axis=1)
    return np.take(half, split_order_indices(h), axis=0)


@lru_cache(maxsize=None)
def mirror_indices(m: int) -> np.ndarray:
    """Split position of frequency (M - k) mod M for every split
    position of a size-M transform."""
    n1, n2 = _factor(m)
    k1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    s1 = (-k1) % n1
    s2 = np.where(k1 == 0, (-k2) % n2, n2 - 1 - k2)
    return (s1 * n2 + s2).reshape(-1)


@lru_cache(maxsize=None)
def _rplan(n_full: int):
    """Unpack twiddle w^k = exp(-2 pi i k / N) at every split position of
    the size-M = N/2 transform, as f32 (real, imag)."""
    m = n_full // 2
    k = split_order_indices(m).astype(np.int64)
    w = np.exp(-2j * np.pi * k / n_full).astype(np.complex64)
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


@lru_cache(maxsize=None)
def _plan_t(n: int, inverse: bool, device: torch.device):
    """Complex64 tensors (F1, F2, T) and the scale of ``_plan`` on device."""
    F1r, F1i, F2r, F2i, Tr, Ti, scale, _, _ = _plan(n, inverse)

    def c(r, i):
        return torch.complex(torch.from_numpy(r), torch.from_numpy(i)).to(device)

    return c(F1r, F1i), c(F2r, F2i), c(Tr, Ti), float(scale)


@lru_cache(maxsize=None)
def _rplan_t(n_full: int, device: torch.device):
    er, ei = _rplan(n_full)
    mirror = torch.from_numpy(mirror_indices(n_full // 2)).to(device)
    return torch.from_numpy(er).to(device), torch.from_numpy(ei).to(device), mirror


def two_stage(x, n: int, inverse: bool = False):
    """Split-order DFT of complex ``x`` shaped (..., n1, n2).

    Forward: natural j = j1*n2 + j2 in, split (k1, k2) out.  Inverse
    (``inverse=True``): split in, natural out, scaled by 1/n."""
    F1, F2, T, scale = _plan_t(n, inverse, x.device)
    if not inverse:
        y = torch.matmul(F1, x) * T          # contract j1, twiddle (k1, j2)
        return torch.matmul(y, F2)           # contract j2
    a = torch.matmul(x, F2) * T              # contract k2, twiddle (k1, j2)
    return torch.matmul(F1, a) * scale       # contract k1


# ---------------------------------------------------------------------------
# full-width complex split transforms (pallas_fft.py:171-268, 424-436): the
# JAX package computes these in XLA, and they are the oracle of the
# full-width solver (recon/admm_split.py run_split).  ``two_stage(...,
# inverse=True)`` is the JAX ``_two_stage_inverse``.  Every function takes
# leading plane axes.
# ---------------------------------------------------------------------------


def fft_w_split(x):
    """(..., W) real rows -> split-order W spectrum as (..., W) r/i."""
    lead, w = tuple(x.shape[:-1]), x.shape[-1]
    n1, n2 = _factor(w)
    z = two_stage(torch.complex(x, torch.zeros_like(x)).reshape(*lead, n1, n2), w)
    z = z.reshape(*lead, w)
    return z.real.contiguous(), z.imag.contiguous()


def ifft_w_split(vr, vi):
    """(..., W) split-order spectrum -> real part of its inverse, natural
    order, scaled 1/W."""
    lead, w = tuple(vr.shape[:-1]), vr.shape[-1]
    n1, n2 = _factor(w)
    z = two_stage(torch.complex(vr, vi).reshape(*lead, n1, n2), w, inverse=True)
    return z.real.reshape(*lead, w).contiguous()


def _h_transform(vr, vi, inverse):
    """The split-order transform along H (axis -2) of (..., H, K) r/i."""
    *lead, h, k = vr.shape
    n1, n2 = _factor(h)
    x = torch.complex(vr, vi).reshape(*lead, n1, n2, k).movedim(-1, -3)
    z = two_stage(x, h, inverse).movedim(-3, -1).reshape(*lead, h, k)
    return z.real.contiguous(), z.imag.contiguous()


def fft_h_split(vr, vi):
    """(..., H, K) r/i -> the split-order forward transform along H."""
    return _h_transform(vr, vi, False)


def ifft_h_split(vr, vi):
    """(..., H, K) split-order r/i -> the inverse transform along H,
    natural order, scaled 1/H."""
    return _h_transform(vr, vi, True)


def filtered_synthesis_split(x, filt_r, filt_i):
    """Re ifft2(fft2(x) * F) of (..., H, W) real planes, with the filter F
    in split order on both axes (``spectrum_to_split``)."""
    hr, hi = fft_h_split(*fft_w_split(x))
    mr = hr * filt_r - hi * filt_i
    mi = hr * filt_i + hi * filt_r
    return ifft_w_split(*ifft_h_split(mr, mi))


def to_split_layout(x):
    """(..., N) natural rows -> even/odd split layout [x[0::2] | x[1::2]]."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def from_split_layout(x):
    """Inverse of :func:`to_split_layout`."""
    m = x.shape[-1] // 2
    return torch.stack([x[..., :m], x[..., m:]], dim=-1).reshape(
        *x.shape[:-1], 2 * m)


def rfft_w_split(x_split):
    """(..., N) real rows in the split layout -> half-spectrum (..., M)
    r/i planes in the size-M split order, Z[0] + i Z[M] at lane 0."""
    lead, n_full = tuple(x_split.shape[:-1]), x_split.shape[-1]
    m = n_full // 2
    n1, n2 = _factor(m)
    er, ei, mirror = _rplan_t(n_full, x_split.device)
    p = torch.complex(x_split[..., :m], x_split[..., m:]).reshape(*lead, n1, n2)
    P = two_stage(p, m).reshape(*lead, m)
    Pr, Pi = P.real, P.imag
    R = P[..., mirror]
    Rr, Ri = R.real, R.imag
    Sr, Si = Pr + Rr, Pi - Ri
    Dr, Di = Pr - Rr, Pi + Ri
    Zr = 0.5 * (Sr + er * Di + ei * Dr)
    Zi = 0.5 * (Si - (er * Dr - ei * Di))
    Zi = torch.cat([(Pr - Pi)[..., :1], Zi[..., 1:]], dim=-1)   # pack Z[M]
    return Zr.contiguous(), Zi.contiguous()


def irfft_w_split(zr, zi):
    """(..., M) half-spectrum (packed lane 0) -> (..., N) real rows in the
    split layout.  Exact inverse of :func:`rfft_w_split`."""
    lead, m = tuple(zr.shape[:-1]), zr.shape[-1]
    n_full = 2 * m
    n1, n2 = _factor(m)
    er, ei, mirror = _rplan_t(n_full, zr.device)
    wr, wi = er, -ei
    Rr, Ri = zr[..., mirror], zi[..., mirror]
    Er = 0.5 * (zr + Rr)
    Ei = 0.5 * (zi - Ri)
    Dr = 0.5 * (zr - Rr)
    Di = 0.5 * (zi + Ri)
    Or = wr * Dr - wi * Di
    Oi = wr * Di + wi * Dr
    z0r, z0i = zr[..., :1], zi[..., :1]
    zero = torch.zeros_like(z0r)
    Er = torch.cat([0.5 * (z0r + z0i), Er[..., 1:]], dim=-1)
    Ei = torch.cat([zero, Ei[..., 1:]], dim=-1)
    Or = torch.cat([0.5 * (z0r - z0i), Or[..., 1:]], dim=-1)
    Oi = torch.cat([zero, Oi[..., 1:]], dim=-1)
    P = torch.complex(Er - Oi, Ei + Or).reshape(*lead, n1, n2)
    p = two_stage(P, m, inverse=True).reshape(*lead, m)
    return torch.cat([p.real, p.imag], dim=-1)
