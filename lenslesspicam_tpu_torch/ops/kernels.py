"""The fused solver's five kernels: CUDA C++ wrappers and their plain
PyTorch versions (port of lenslesspicam_tpu/ops/pallas_kernels2.py,
f32 io and f32 carries).

| wrapper | TPU kernel it replaces | CUDA source |
|---|---|---|
| ``rfft_w`` (K1) | ``rfft_w`` / ``_w_rfwd_kernel`` | ``csrc/rfft_w.cu`` |
| ``e1_rtv`` (K3) | ``e1_rtv`` / ``_e1rtv_kernel`` | ``csrc/e1_rtv.cu`` |
| ``h_passA_pair`` (K4) | ``h_passA_pair`` / ``_h_passA_pair_kernel`` | ``csrc/h_pass_a.cu`` |
| ``h_combine_dual`` (K5) | ``_h_combine_dual_kernel`` | ``csrc/h_combine.cu`` |
| ``irfft_w_dual_state`` (K6) | ``irfft_w_dual_state`` / ``_w_rinv_dual_state_kernel`` | ``csrc/w_dual_state.cu`` |

A wrapper given CPU tensors runs the plain version (``*_plain``).  Given
CUDA tensors it launches its kernel on the current stream or raises: it
never falls back.  Each wrapper counts its kernel launches in its
``launches`` attribute.  The kernels take their DFT roots, twiddles and
unpack factors from one constant table per transform length, built here
in float64 and cast to f32 as the JAX package builds its plans.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from . import _build
from .split_fft import _factor, _plan, _plan_t, _rplan, irfft_w_split, rfft_w_split

_F32 = torch.float32

# Tile widths of the H-axis kernels (columns of the lane axis per block);
# the lane width must be a multiple of both.
_K4_TW = 64
_K5_TW = 32


# ---------------------------------------------------------------------------
# small f32 algebra shared with the JAX kernels' bodies
# ---------------------------------------------------------------------------


def _soft(x, thr):
    return torch.sign(x) * torch.clamp(torch.abs(x) - thr, min=0.0)


def _split_roll_p1(x, mh):
    """roll(x, +1) along natural W in the even/odd split lane layout:
    new_even[j] = odd[j-1], new_odd[j] = even[j]."""
    ev, od = x[:, :mh], x[:, mh:]
    return torch.cat([torch.roll(od, 1, dims=1), ev], dim=1)


def _split_roll_m1(x, mh):
    """roll(x, -1) along natural W in the even/odd split lane layout:
    new_even[j] = odd[j], new_odd[j] = even[j+1]."""
    ev, od = x[:, :mh], x[:, mh:]
    return torch.cat([od, torch.roll(ev, -1, dims=1)], dim=1)


def _tv_scales(mu2, mu3, tau):
    """Full scales of the int16 TV carries (not used at f32; kept for the
    modes of later slices)."""
    return 8.0 * tau, 32.0 * mu3


def _v_scale(mu1):
    """Full scale of the int16 v carry (not used at f32)."""
    return 256.0 * mu1


def encode_v(x, mu1):
    """The v carry in its storage dtype: f32 in this port."""
    return x.to(_F32)


# ---------------------------------------------------------------------------
# constants, checks and launching
# ---------------------------------------------------------------------------


def factors(n: int, cuda: bool = False):
    """(n1, n2) of a length-n axis.  With ``cuda`` it raises where the
    kernels cannot run: n1 == 1 (the degenerate one-stage split) or a
    factor not divisible by 4 (the kernels' register tile).  The plain
    versions take any factorization."""
    n1, n2 = _factor(n)
    if cuda and (n1 == 1 or n1 % 4 or n2 % 4):
        raise ValueError(f"length {n} factors as {n1} x {n2}: the CUDA "
                         "kernels need n1 > 1 and both factors divisible by 4")
    return n1, n2


@lru_cache(maxsize=None)
def _table_np(n: int, with_unpack: bool) -> np.ndarray:
    """Constant table of a length-n split-order transform, complex64:
    [r1f (n1) | r2f (n2) | r1i (n1) | r2i (n2) | Tf (n) | Ti (n) | E (n)],
    r*[m] = exp(-/+ 2 pi i m / n*) (the entries of the DFT matrices F1,
    F2), T*[k1*n2 + j2] the twiddles, E[pos] = w^k at every split
    position of the packed-real unpack (only when ``with_unpack``; n is
    then M = N/2)."""
    n1, n2 = _factor(n)
    parts = []
    for inverse in (False, True):
        sign = 2j * np.pi / n if inverse else -2j * np.pi / n
        parts.append(np.exp(sign * n2 * np.arange(n1)).astype(np.complex64))
        parts.append(np.exp(sign * n1 * np.arange(n2)).astype(np.complex64))
    for inverse in (False, True):
        _, _, _, _, Tr, Ti, _, _, _ = _plan(n, inverse)
        parts.append((Tr + 1j * Ti).astype(np.complex64).reshape(-1))
    if with_unpack:
        er, ei = _rplan(2 * n)
        parts.append((er + 1j * ei).astype(np.complex64))
    return np.ascontiguousarray(np.concatenate(parts))


@lru_cache(maxsize=None)
def _table(n: int, with_unpack: bool, device: torch.device):
    t = torch.from_numpy(_table_np(n, with_unpack))
    return torch.view_as_real(t).contiguous().to(device)


def _check(name, tensors, shape=None):
    for t in tensors:
        if t.dtype != _F32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: CUDA tensors must be contiguous")
    return True


_ARG = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


@lru_cache(maxsize=None)
def _entry(lib: str, fn: str, sig: str):
    f = getattr(_build.load(lib), fn)
    f.argtypes = [_ARG[c] for c in sig] + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _launch(lib, fn, sig, *args):
    """Call a C entry with tensors as pointers on the current stream and
    raise if the launch reported an error."""
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    rc = _entry(lib, fn, sig)(*vals, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def _empty(shape, like):
    return torch.empty(shape, dtype=_F32, device=like.device)


# ---------------------------------------------------------------------------
# K1: packed-real forward W transform
# ---------------------------------------------------------------------------


def rfft_w_plain(x):
    """(rows, N) split-layout real rows -> half-spectrum (rows, N/2) r/i."""
    return rfft_w_split(x)


def rfft_w(x):
    """(rows, N) split-layout real rows -> half-spectrum (rows, N/2) r/i
    pair in split order, Z[N/2] packed into Im of lane 0."""
    rows, n_full = x.shape
    m = n_full // 2
    cuda = _check("rfft_w", [x])
    n1, n2 = factors(m, cuda)
    if not cuda:
        return rfft_w_plain(x)
    zr, zi = _empty((rows, m), x), _empty((rows, m), x)
    _launch("rfft_w", "lpt_rfft_w", "ppppiiii", x, zr, zi,
            _table(m, True, x.device), rows, m, n1, n2)
    rfft_w.launches += 1
    return zr, zi


def irfft_w_plain(zr, zi):
    """Inverse of :func:`rfft_w_plain` (K2's function; its CUDA core runs
    inside K6)."""
    return irfft_w_split(zr, zi)


# ---------------------------------------------------------------------------
# K3: TV / non-negativity update + forward W transform of rk
# ---------------------------------------------------------------------------


def e1_rtv_plain(image, a0, a1, b, mu2, mu3, tau):
    rows, n_full = image.shape
    mh = n_full // 2
    thr = tau / mu2
    # H axis (periodic): a0 row r pairs with psi0 = img[r-1] - img[r];
    # the adjoint needs the new a0 of row r+1 as well
    psi0 = torch.roll(image, 1, dims=0) - image
    eta0 = mu2 * psi0 - a0
    a0n = mu2 * _soft(psi0 + eta0 / mu2, thr) - eta0
    adj0 = torch.roll(a0n, -1, dims=0) - a0n
    psi1 = _split_roll_p1(image, mh) - image
    eta1 = mu2 * psi1 - a1
    a1n = mu2 * _soft(psi1 + eta1 / mu2, thr) - eta1
    adj1 = _split_roll_m1(a1n, mh) - a1n
    rho = mu3 * image - b
    W = torch.clamp(rho / mu3 + image, min=0.0)
    bn = mu3 * W - rho
    rk = bn + adj0 + adj1
    rkr, rki = rfft_w_split(rk)
    return rkr, rki, a0n, a1n, bn, 0.0


def e1_rtv(image, a0, a1, b, mu2, mu3, tau):
    """v3 pre-transform step.  Returns (rk_wr, rk_wi, a0', a1', b', sat):
    the rk half spectrum, the new TV/non-negativity carries, and the
    carry-saturation value, 0.0 for f32 carries (nothing is launched for
    it)."""
    rows, n_full = image.shape
    m = n_full // 2
    cuda = _check("e1_rtv", [image, a0, a1, b], (rows, n_full))
    n1, n2 = factors(m, cuda)
    if not cuda:
        return e1_rtv_plain(image, a0, a1, b, mu2, mu3, tau)
    rkr, rki = _empty((rows, m), image), _empty((rows, m), image)
    a0o, a1o, bo = (_empty((rows, n_full), image) for _ in range(3))
    _launch("e1_rtv", "lpt_e1_rtv", "ppppppppppiiiifff",
            image, a0, a1, b, rkr, rki, a0o, a1o, bo,
            _table(m, True, image.device), rows, m, n1, n2,
            float(mu2), float(mu3), float(tau))
    e1_rtv.launches += 1
    return rkr, rki, a0o, a1o, bo, 0.0


# ---------------------------------------------------------------------------
# K4: H-axis stage 1 on two complex planes
# ---------------------------------------------------------------------------


def _h_passA_plain_one(xr, xi, n, inverse):
    F1, _, T, scale = _plan_t(n, inverse, xr.device)
    n1, n2, w = xr.shape
    x = torch.complex(xr, xi)
    tw = T[:, :, None]
    if inverse:
        z = torch.matmul(F1, (x * tw).reshape(n1, n2 * w)).reshape(n1, n2, w) * scale
    else:
        z = torch.matmul(F1, x.reshape(n1, n2 * w)).reshape(n1, n2, w) * tw
    return z.real.contiguous(), z.imag.contiguous()


def h_passA_pair_plain(x1r, x1i, x2r, x2i, n, inverse):
    return (_h_passA_plain_one(x1r, x1i, n, inverse),
            _h_passA_plain_one(x2r, x2i, n, inverse))


def h_passA_pair(x1r, x1i, x2r, x2i, n, inverse):
    """H-axis stage 1 on two complex planes viewed (n1, n2, W).  Forward:
    contract j1 with F1, then twiddle.  Inverse: twiddle, contract with
    the inverse F1, scale 1/n.  Returns ((z1r, z1i), (z2r, z2i))."""
    planes = [x1r, x1i, x2r, x2i]
    n1, n2, w = x1r.shape
    cuda = _check("h_passA_pair", planes, (n1, n2, w))
    if (n1, n2) != factors(n, cuda):
        raise ValueError(f"h_passA_pair: planes {x1r.shape} do not view a "
                         f"length-{n} axis as {_factor(n)}")
    if not cuda:
        return h_passA_pair_plain(x1r, x1i, x2r, x2i, n, inverse)
    if w % _K4_TW:
        raise ValueError(f"h_passA_pair: lane width {w} is not a multiple "
                         f"of {_K4_TW}")
    outs = [_empty((n1, n2, w), x1r) for _ in range(4)]
    _launch("h_pass_a", "lpt_h_pass_a_pair", "ppppppppp" + "iiii",
            *planes, *outs, _table(n, False, x1r.device), n1, n2, w,
            int(bool(inverse)))
    h_passA_pair.launches += 1
    return (outs[0], outs[1]), (outs[2], outs[3])


# ---------------------------------------------------------------------------
# K5: H-axis stage 2 of both planes, spectrum combine, inverse stage 2
# ---------------------------------------------------------------------------


def h_combine_dual_plain(xar, xai, yar, yai, hr, hi, rr, n):
    _, F2f, _, _ = _plan_t(n, False, xar.device)
    _, F2i, _, _ = _plan_t(n, True, xar.device)

    def stage2(x, F2):     # z[k1, q, w] = sum_p F2[q, p] x[k1, p, w]
        return torch.matmul(F2, x)

    a = stage2(torch.complex(xar, xai), F2f)
    b = stage2(torch.complex(yar, yai), F2f)
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    fr = rr * (ar + hr * br + hi * bi)
    fi = rr * (ai + hr * bi - hi * br)
    f1r = fr * hr - fi * hi
    f1i = fr * hi + fi * hr
    g0 = stage2(torch.complex(fr, fi), F2i)
    g1 = stage2(torch.complex(f1r, f1i), F2i)
    return tuple(t.contiguous() for t in (g0.real, g0.imag, g1.real, g1.imag))


def h_combine_dual(xar, xai, yar, yai, hr, hi, rr, n):
    """Forward stage 2 of the rk (x) and v (y) stage-1 planes, F = R(A +
    conj(H) B), F1 = H F, and the inverse stage 2 of F and F1; all planes
    (n1, n2, W).  Returns (a0r, a0i, a1r, a1i)."""
    ins = [xar, xai, yar, yai, hr, hi, rr]
    n1, n2, w = xar.shape
    cuda = _check("h_combine_dual", ins, (n1, n2, w))
    if (n1, n2) != factors(n, cuda):
        raise ValueError(f"h_combine_dual: planes {xar.shape} do not view "
                         f"a length-{n} axis as {_factor(n)}")
    if not cuda:
        return h_combine_dual_plain(*ins, n)
    if w % _K5_TW:
        raise ValueError(f"h_combine_dual: lane width {w} is not a "
                         f"multiple of {_K5_TW}")
    outs = [_empty((n1, n2, w), xar) for _ in range(4)]
    _launch("h_combine", "lpt_h_combine_dual", "pppppppppppp" + "iii",
            *ins, *outs, _table(n, False, xar.device), n1, n2, w)
    h_combine_dual.launches += 1
    return tuple(outs)


def fft_h_combine_dual(rkr, rki, vr, vi, hr, hi, rr, h, ops=None):
    """Forward H transforms of both ADMM planes, spectrum combine and the
    inverse H transforms of F and H.F: K4 forward, K5, K4 inverse.  All
    planes (h, W) in split order; returns ((a0r, a0i), (a1r, a1i))."""
    ops = ops or KERNELS
    n1, n2 = _factor(h)
    w = rkr.shape[-1]

    def v(t):
        return t.reshape(n1, n2, w)

    (xar, xai), (yar, yai) = ops.h_passA_pair(v(rkr), v(rki), v(vr), v(vi),
                                              h, False)
    a0r, a0i, a1r, a1i = ops.h_combine_dual(xar, xai, yar, yai,
                                            v(hr), v(hi), v(rr), h)
    (z0r, z0i), (z1r, z1i) = ops.h_passA_pair(a0r, a0i, a1r, a1i, h, True)
    return ((z0r.reshape(h, w), z0i.reshape(h, w)),
            (z1r.reshape(h, w), z1i.reshape(h, w)))


# ---------------------------------------------------------------------------
# K6: dual inverse W transform + X/v update + forward W transform of v'
# ---------------------------------------------------------------------------


def irfft_w_dual_state_plain(a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i,
                             v, mask, dp, mu1):
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1

    def patch(z, col):
        return torch.cat([col[:, None], z[:, 1:]], dim=1)

    image = irfft_w_split(patch(a0r, p0r), patch(a0i, p0i))
    fwd = irfft_w_split(patch(a1r, p1r), patch(a1i, p1i))
    xi = mu1 * fwd - v
    xdv = c_out + (c_in - c_out) * mask
    X = xdv * (xi + mu1 * fwd + dp)
    vn = mu1 * X - xi
    vwr, vwi = rfft_w_split(vn)
    return image, vn, vwr, vwi


def irfft_w_dual_state(a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i, v, mask, dp,
                       mu1):
    """v3 post-transform step: lane 0 of the a0/a1 half spectra replaced by
    the (rows,) DC/Nyquist patch columns p0*/p1*, both inverse W
    transforms (image, fwd), xi = mu1 fwd - v, X = xdv (xi + mu1 fwd +
    dp), v' = mu1 X - xi, and the forward W transform of v'.  fwd never
    reaches device memory.  Returns (image, v', v'_wr, v'_wi)."""
    rows, m = a0r.shape
    n_full = 2 * m
    cuda = _check("irfft_w_dual_state", [a0r, a0i, a1r, a1i], (rows, m))
    _check("irfft_w_dual_state", [p0r, p0i, p1r, p1i], (rows,))
    _check("irfft_w_dual_state", [v, mask, dp], (rows, n_full))
    n1, n2 = factors(m, cuda)
    if any(t.device != a0r.device for t in (p0r, v)):
        raise ValueError("irfft_w_dual_state: tensors on different devices")
    if not cuda:
        return irfft_w_dual_state_plain(a0r, a0i, a1r, a1i, p0r, p0i, p1r,
                                        p1i, v, mask, dp, mu1)
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
    image, vo = _empty((rows, n_full), v), _empty((rows, n_full), v)
    vwr, vwi = _empty((rows, m), v), _empty((rows, m), v)
    _launch("w_dual_state", "lpt_w_dual_state", "ppppppppppp" + "pppp" + "p"
            + "iiii" + "fff",
            a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i, v, mask, dp,
            image, vo, vwr, vwi, _table(m, True, v.device), rows, m, n1, n2,
            float(mu1), float(c_out), float(c_in - c_out))
    irfft_w_dual_state.launches += 1
    return image, vo, vwr, vwi


WRAPPERS = (rfft_w, e1_rtv, h_passA_pair, h_combine_dual, irfft_w_dual_state)
for _w in WRAPPERS:
    _w.launches = 0

# the kernel set the solver runs, and the same functions in plain PyTorch
# (for holding the kernels against it on the card)
KERNELS = SimpleNamespace(rfft_w=rfft_w, e1_rtv=e1_rtv,
                          h_passA_pair=h_passA_pair,
                          h_combine_dual=h_combine_dual,
                          irfft_w_dual_state=irfft_w_dual_state)
PLAIN = SimpleNamespace(rfft_w=rfft_w_plain, e1_rtv=e1_rtv_plain,
                        h_passA_pair=h_passA_pair_plain,
                        h_combine_dual=h_combine_dual_plain,
                        irfft_w_dual_state=irfft_w_dual_state_plain)


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
