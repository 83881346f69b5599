"""Split-order ADMM (port of lenslesspicam_tpu/recon/admm_split.py): the
fused half-spectrum solver, the system's hot path (:205-525, both kernel
placements, at every storage mode of the JAX package, for one plane or a
batched RGB / 3-D stack of planes), and the full-width split solver
(:30-192, 528-701; ``precompute_split``, ``run_split`` with its
``"jax"`` (also named ``"torch"``), ``"fused"`` and ``"pallas"``
backends, ``run_split_general``, at the end of this module).

Spatial planes ride in the even/odd split lane layout; spectra, filter
constants and all H-axis work are half width (``ops/split_fft.py``).
The packed DC/Nyquist lane (Z[0] + i Z[M]) is not separable under the
filter multiply, so its two spatial columns are convolved exactly on the
side with ``torch.fft`` (``dc_patch``) and patched in before the inverse.

Two kernel placements of the same recurrence (``placement``):

* ``"v3"`` (the JAX default): K1 ``rfft_w`` once before the loop; per
  iteration K3 ``e1_rtv`` -> ``dc_patch`` -> K4/K5/K4
  ``fft_h_combine_dual`` -> K6 ``irfft_w_dual_state``.  The X/v update
  rides in K6, so the forward estimate never reaches device memory, and
  the TV dual update is deferred to the next iteration's K3.
* ``"v2"`` (``LPT_RFUSED_V3=0`` in JAX): zero state and no K1; per
  iteration K8 ``e1_rcarry`` (TV step, X/v update from the carried
  forward plane, both forward W transforms) -> ``dc_patch`` -> K4/K5/K4
  -> K9 ``irfft_w_dual`` (image and forward plane, both stored).  Its
  saturation channel scans every int16 carry every iteration (K7).

v3 moves fewer bytes per iteration and is the faster placement on the
H100 in the headline storage mode (bf16 spectra, int16 carries); at f32
v2 is the faster, its K8 and K9 running closer to their bound than v3's
K3 and K6 (PERF.md).  v3 stays the default, as in the JAX package; v2
also carries K9, which the JAX package's multi-device solver runs.

Storage modes are arguments, not globals: ``io`` (f32 or bf16) for the
spectra, the image and the static planes handed between kernels,
``carry_tv`` and ``carry_v`` (f32, bf16 or i16) for the TV carries a0,
a1, b and the data-fidelity carry v.  The JAX bench's headline mode is
``io="bf16", carry_tv="i16", carry_v="i16"``.  int16 carries are fixed
point at parameter-derived full scales; the saturation channel reports
the largest fraction of full scale reached, >= 1 meaning a carry
clipped.

Planes.  ``run_split_rfused`` takes a precompute whose ``data_pad`` is
one plane (ph, pw) or a stack (P, ph, pw); the per-PSF constants are one
plane or a stack of Pc with P % Pc == 0, plane p using constant plane
p % Pc.  ``run_rsplit_general`` builds that stack for (B, D, H, W, C)
data: the JAX package's nested ``vmap`` (over the D * C planes with the
constants batched, over the batch with them broadcast) is the plane axis
of the kernels, one launch per kernel per pass whatever P is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_device, as_host, resolve_device
from ..ops import kernels
from ..ops import split_fft as sf
from ..ops.padding import padded_size
from ..ops.tv import soft_thresh
from .admm import ADMMParams


class RSplitPrecomp(NamedTuple):
    # each array one plane, or a stack of planes on a leading axis: Pc for
    # the per-PSF constants, P for data_pad
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
PLACEMENTS = ("v3", "v2")


def _geometry(psf2d):
    """(nh, nw, ph, pw, sy, sx): the PSF's shape, the even padded grid and
    the offset of the PSF in it."""
    nh, nw = psf2d.shape
    ph, pw = padded_size(nh), padded_size(nw)
    if ph % 2 or pw % 2:
        raise ValueError(f"padded grid {ph}x{pw} must be even on both axes")
    return nh, nw, ph, pw, (ph - nh) // 2, (pw - nw) // 2


def _pad_np(x2d, ph, pw, sy, sx):
    out = np.zeros((ph, pw), np.float32)
    out[sy : sy + x2d.shape[0], sx : sx + x2d.shape[1]] = x2d
    return out


def _filters_np(psf2d, params: ADMMParams):
    """(H, R, geometry) on the padded grid in natural order, as the JAX
    package's precomputes compute them: H the PSF's spectrum (complex64,
    the ifftshift folded in as (-1)^(ky+kx)), R = 1 / (mu1 |H|^2 + mu2
    |fft2(Laplacian)| + mu3) as f32, the geometry of :func:`_geometry`."""
    geo = nh, nw, ph, pw, sy, sx = _geometry(psf2d)
    H_nat = np.fft.fft2(_pad_np(psf2d, ph, pw, sy, sx)).astype(np.complex64)
    mask = np.outer((-1.0) ** np.arange(ph), (-1.0) ** np.arange(pw)).astype(np.float32)
    H_nat = H_nat * mask
    kern = np.zeros((ph, pw), np.float32)
    kern[0, 0] = 4.0
    kern[0, 1] = kern[0, -1] = kern[1, 0] = kern[-1, 0] = -1.0
    psi = np.abs(np.fft.fft2(kern))
    R_nat = 1.0 / (params.mu1 * np.abs(H_nat) ** 2 + params.mu2 * psi + params.mu3)
    return H_nat, R_nat.astype(np.float32), geo


def precompute_rsplit_np(psf2d: np.ndarray, data2d: np.ndarray,
                         params: ADMMParams = ADMMParams()) -> dict:
    """The loop-invariant arrays as numpy, computed exactly as the JAX
    package computes them (so both start from identical constants)."""
    H_nat, R_nat, (nh, nw, ph, pw, sy, sx) = _filters_np(psf2d, params)
    mh = pw // 2

    H_half = sf.spectrum_to_half_split(H_nat)
    R_half = sf.spectrum_to_half_split(R_nat)

    def to_split(x):
        return np.ascontiguousarray(np.concatenate([x[:, 0::2], x[:, 1::2]], axis=1))

    ones_pad = _pad_np(np.ones((nh, nw), np.float32), ph, pw, sy, sx)
    data_pad = _pad_np(data2d, ph, pw, sy, sx)

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
    arrs = precompute_rsplit_np(as_host(psf2d), as_host(data2d), params)
    return RSplitPrecomp(
        *[torch.from_numpy(arrs[f]).to(device) for f in ARRAY_FIELDS],
        psf_shape=arrs["psf_shape"], padded_shape=arrs["padded_shape"],
        start=arrs["start"])


def _check_planes(pre: RSplitPrecomp):
    """Raises ValueError unless data_pad is a plane or a stack of P planes
    that repeats the Pc planes of the per-PSF constants (P % Pc == 0)."""
    ph, pw = pre.padded_shape
    p = 1 if pre.data_pad.dim() == 2 else pre.data_pad.shape[0]
    pc = 1 if pre.Hr.dim() == 2 else pre.Hr.shape[0]
    if tuple(pre.data_pad.shape[-2:]) != (ph, pw) or p % pc:
        raise ValueError(f"data_pad {tuple(pre.data_pad.shape)} is not a stack of "
                         f"planes ({ph}, {pw}) that repeats the {pc} constant planes")


def run_split_rfused(pre: RSplitPrecomp, params: ADMMParams = ADMMParams(),
                     n_iter: int = 100, return_sat: bool = False, ops=None,
                     io: str = "f32", carry_tv: str = "f32",
                     carry_v: str = "f32", sat_every: int = 8,
                     placement: str = "v3"):
    """ADMM on the half-spectrum fused path; returns the cropped, clipped
    image, (H, W) for a single plane and (P, H, W) for a stack, and with
    ``return_sat`` also the running max of the carry-saturation channel
    over all planes as a float (0.0 when no carry is int16: such carries
    cannot clip, and nothing is launched for it).

    ``io`` is "f32" or "bf16"; ``carry_tv`` and ``carry_v`` are "f32",
    "bf16" or "i16".  The defaults are the exact f32 path.  ``placement``
    is "v3" or "v2" (module docstring).  In v3 with an int16 v, K7 scans
    the stored v every ``sat_every``-th iteration (from the first); v2
    scans every int16 carry every iteration, as the JAX package does.
    The running max stays on the device; ``return_sat`` reads it once,
    after the loop.

    ``ops`` is the kernel set, ``kernels.KERNELS`` by default;
    ``kernels.PLAIN`` runs the same loop through the plain PyTorch
    versions, against which the kernels are held on the card."""
    ops = ops or kernels.KERNELS
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r} is not one of {PLACEMENTS}")
    io_t = kernels.storage_dtype(io, ("f32", "bf16"))
    tv_t, v_t = kernels.storage_dtype(carry_tv), kernels.storage_dtype(carry_v)
    if sat_every < 1:
        raise ValueError(f"sat_every must be >= 1, got {sat_every}")
    _check_planes(pre)
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau
    ph, pw = pre.padded_shape
    shape = tuple(pre.data_pad.shape)
    dev = pre.Hr.device
    f32 = torch.float32
    bmul = kernels.bmul
    # the filter planes and the static mask/data planes ride at io; the
    # DC/Nyquist columns stay f32
    Hr, Hi, R = pre.Hr.to(io_t), pre.Hi.to(io_t), pre.R.to(io_t)
    mask, data_pad = pre.mask.to(io_t), pre.data_pad.to(io_t)
    H0 = torch.complex(pre.H0r, pre.H0i)
    HM = torch.complex(pre.HMr, pre.HMi)

    def dc_patch(rkr, rki, vr, vi):
        # exact DC (kw = 0) and Nyquist (kw = M) columns, convolved on the
        # side: one batched length-ph FFT for the four analysis columns of
        # every plane and one for the four synthesis columns
        cols = torch.stack([rkr[..., 0], rki[..., 0], vr[..., 0], vi[..., 0]]).to(f32)
        A0, AM, B0, BM = torch.fft.fft(cols, dim=-1)
        F0 = bmul(pre.R0, A0 + bmul(torch.conj(H0), B0))
        FM = bmul(pre.RM, AM + bmul(torch.conj(HM), BM))
        outs = torch.fft.ifft(torch.stack([F0, FM, bmul(H0, F0), bmul(HM, FM)]),
                              dim=-1).real.contiguous()
        return outs[0], outs[1], outs[2], outs[3]

    def track(sat, s):
        return s if sat is None else torch.maximum(sat, s)

    sat = None          # running max on the device; None: nothing can clip
    if placement == "v3":
        # iteration-0 v carry: with all other state zero the first X update
        # gives v = mu1 * X_divmat * data (f32, from the f32 planes)
        c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
        xdv = c_out + (c_in - c_out) * pre.mask
        v_init = bmul(mu1 * xdv, pre.data_pad)
        vwr, vwi = ops.rfft_w(v_init.to(io_t))
        v = kernels.encode_v(v_init, mu1, v_t)
        image = torch.zeros(shape, dtype=io_t, device=dev)
        a0 = a1 = b = torch.zeros(shape, dtype=tv_t, device=dev)
        for i in range(int(n_iter)):
            rkr, rki, a0, a1, b, sat_tv = ops.e1_rtv(image, a0, a1, b, mu2, mu3, tau)
            i0, iM, f0, fM = dc_patch(rkr, rki, vwr, vwi)
            (a0r, a0i), (a1r, a1i) = kernels.fft_h_combine_dual(
                rkr, rki, vwr, vwi, Hr, Hi, R, ph, ops=ops)
            image, v, vwr, vwi, _ = ops.irfft_w_dual_state(
                a0r, a0i, a1r, a1i, i0, iM, f0, fM, v, mask, data_pad, mu1,
                with_sat=False)
            if tv_t == torch.int16:
                sat = track(sat, sat_tv)
            if v_t == torch.int16 and i % sat_every == 0:
                sat = track(sat, ops.sat_scan_i16(v))
    else:
        sc_a, sc_b = kernels._tv_scales(mu2, mu3, tau)
        scales = (kernels._v_scale(mu1), sc_a, sc_a, sc_b)
        image = fwd = torch.zeros(shape, dtype=io_t, device=dev)
        v = torch.zeros(shape, dtype=v_t, device=dev)
        a0 = a1 = b = torch.zeros(shape, dtype=tv_t, device=dev)
        for _ in range(int(n_iter)):
            rkr, rki, vr, vi, v, a0, a1, b = ops.e1_rcarry(
                image, fwd, v, b, a0, a1, mask, data_pad, mu1, mu2, mu3, tau)
            i0, iM, f0, fM = dc_patch(rkr, rki, vr, vi)
            (a0r, a0i), (a1r, a1i) = kernels.fft_h_combine_dual(
                rkr, rki, vr, vi, Hr, Hi, R, ph, ops=ops)
            image, fwd = ops.irfft_w_dual(a0r, a0i, a1r, a1i, i0, iM, f0, fM)
            # no in-kernel channel: the stored carries bound the fraction
            # at 1.0 (post-clip), still a detection
            for plane, scale in zip((v, a0, a1, b), scales):
                if plane.dtype == torch.int16:
                    sat = track(sat, kernels.carry_sat_fraction(plane, scale, ops))
    img = sf.from_split_layout(image.to(f32))
    sy, sx = pre.start
    nh, nw = pre.psf_shape
    out = torch.clamp(img[..., sy : sy + nh, sx : sx + nw], min=0.0)
    if return_sat:
        return out, (0.0 if sat is None else float(sat))
    return out


def run_rsplit(pre: RSplitPrecomp, params: ADMMParams = ADMMParams(),
               n_iter: int = 100, return_sat: bool = False, io: str = "f32",
               carry_tv: str = "f32", carry_v: str = "f32", sat_every: int = 8,
               placement: str = "v3"):
    """Entry of the half-spectrum fused solver, with the storage modes and
    placements of :func:`run_split_rfused` (:func:`run_rsplit_jit` is the
    JAX package's entry, at its defaults)."""
    return run_split_rfused(pre, params, n_iter, return_sat=return_sat,
                            io=io, carry_tv=carry_tv, carry_v=carry_v,
                            sat_every=sat_every, placement=placement)


def run_rsplit_jit(pre: RSplitPrecomp, params: ADMMParams = ADMMParams(),
                   n_iter=100, return_sat=False):
    """The JAX package's compiled entry of the half-spectrum fused solver
    under its name, signature and defaults (f32 storage, placement v3).
    The port has no trace step: this runs :func:`run_rsplit` where its
    inputs are, and exists so that code written for the JAX package runs.
    ``n_iter`` is an int or a 0-d tensor."""
    return run_rsplit(pre, params, n_iter, return_sat=return_sat)


def _as_5d(data):
    if data.ndim == 3:
        return data[None, None]
    if data.ndim == 4:
        return data[None]
    return data


def precompute_rsplit_general(psf, data, params: ADMMParams = ADMMParams(),
                              device=None):
    """Per-plane half-spectrum precompute for a (D, H, W, C) PSF and
    (B, D, H, W, C) measurements (also (D, H, W, C) or (H, W, C)), placed
    on ``device`` (None: the CUDA card).  Returns ``(pre, info)``: the
    RSplitPrecomp arrays stacked over the D * C planes (d-major, then c),
    each computed exactly as :func:`precompute_rsplit` computes a gray
    plane (data_pad from the first batch entry; depth-1 data serves every
    depth), and ``info = {"batch", "depth", "channels"}``."""
    device = resolve_device(device)
    psf = as_host(psf)
    data = _as_5d(as_host(data))
    depth, _, _, ch = psf.shape
    arrs = [precompute_rsplit_np(psf[d, :, :, c],
                                 data[0, min(d, data.shape[1] - 1), :, :, c], params)
            for d in range(depth) for c in range(ch)]
    pre = RSplitPrecomp(
        *[torch.from_numpy(np.stack([a[f] for a in arrs])).to(device)
          for f in ARRAY_FIELDS],
        psf_shape=arrs[0]["psf_shape"], padded_shape=arrs[0]["padded_shape"],
        start=arrs[0]["start"])
    return pre, dict(batch=data.shape[0], depth=depth, channels=ch)


def run_rsplit_general(pre: RSplitPrecomp, info: dict, data,
                       params: ADMMParams = ADMMParams(), n_iter: int = 100,
                       return_sat: bool = False, placement: str = "v3",
                       io: str = "f32", carry_tv: str = "f32",
                       carry_v: str = "f32", sat_every: int = 8):
    """Batched RGB / 3-D ADMM on the half-spectrum fused path (the JAX
    package's ``run_rsplit_general``); returns (B, D, H, W, C), clipped
    at 0, and with ``return_sat`` the max saturation over all planes.

    ``pre`` and ``info`` come from :func:`precompute_rsplit_general`.
    Data of depth 1 is broadcast over the PSF's depths.  The B * D * C
    planes (b-major, then d, then c) are padded from ``data`` on the
    device and run as one stack through :func:`run_split_rfused`, the
    per-PSF constants broadcast over the batch."""
    dev = pre.Hr.device
    data = _as_5d(as_device(data, torch.float32, dev))
    batch, depth, ch = info["batch"], info["depth"], info["channels"]
    if data.shape[1] == 1 and depth > 1:
        data = data.expand(data.shape[0], depth, *data.shape[2:])
    nh, nw = pre.psf_shape
    ph, pw = pre.padded_shape
    sy, sx = pre.start
    planes = data.permute(0, 1, 4, 2, 3).reshape(batch * depth * ch, nh, nw)
    pad = torch.zeros((planes.shape[0], ph, pw), dtype=torch.float32, device=dev)
    pad[:, sy : sy + nh, sx : sx + nw] = planes
    out = run_split_rfused(pre._replace(data_pad=sf.to_split_layout(pad).contiguous()),
                           params, n_iter, return_sat=return_sat, io=io,
                           carry_tv=carry_tv, carry_v=carry_v, sat_every=sat_every,
                           placement=placement)
    if return_sat:
        out, sat = out
    out = out.reshape(batch, depth, ch, nh, nw).permute(0, 1, 3, 4, 2).contiguous()
    return (out, sat) if return_sat else out


# ---------------------------------------------------------------------------
# full-width split solver (admm_split.py:30-192, 528-701): spatial planes in
# natural lane order, full-width complex spectra in split order on both
# axes (ops/split_fft.py).
#
# ``run_split(backend="jax")``, the default as in the JAX package, is that
# package's ``"jax"`` backend: the unfused loop of admm_split.py:534-601
# through the plain split transforms, at f32; ``"torch"`` names the same
# loop.  ``backend="pallas"`` (``run_split_pallas``) is the same loop
# through the pass-level kernels (admm_split.py:110-133): per iteration K12
# -> K14 -> K15 for rk, K12 -> K14 -> K16 for v with the spectrum combine,
# K17 -> K4 -> 2 K13 for the image and the forward plane, the state algebra
# between them in PyTorch.  ``backend="fused"`` (``run_split_fused``) is the
# carry-rebuild loop of admm_split.py:161-192: per iteration K10
# ``e1_carry`` -> K4/K5/K4 ``fft_h_combine_dual`` -> K11 ``ifft_w_dual``, no
# dc_patch (the spectra are full width).  Its TV carries are f32 or bf16:
# the JAX kernel stores them at ``_CARRY_DTYPE``, never int16, and has no
# saturation channel, so neither has the port.
# ---------------------------------------------------------------------------


class SplitPrecomp(NamedTuple):
    # each array one plane, or a stack of planes on a leading axis: Pc for
    # the per-PSF constants, P for data_pad
    Hr: torch.Tensor        # (Ph, Pw) filter spectrum, split order
    Hi: torch.Tensor
    R: torch.Tensor         # (Ph, Pw) real, split order
    X_divmat: torch.Tensor  # (Ph, Pw) spatial, natural order
    data_pad: torch.Tensor  # (Ph, Pw) spatial, natural order
    psf_shape: tuple
    padded_shape: tuple
    start: tuple


SPLIT_FIELDS = ("Hr", "Hi", "R", "X_divmat", "data_pad")
BACKENDS = ("jax", "torch", "fused", "pallas")


def precompute_split_np(psf2d: np.ndarray, data2d: np.ndarray,
                        params: ADMMParams = ADMMParams()) -> dict:
    """The full-width split precompute as numpy, computed exactly as the
    JAX package's ``precompute_split`` computes it."""
    H_nat, R_nat, (nh, nw, ph, pw, sy, sx) = _filters_np(psf2d, params)
    H_split = sf.spectrum_to_split(H_nat, axes=(0, 1))
    R_split = sf.spectrum_to_split(R_nat, axes=(0, 1))
    ones_pad = _pad_np(np.ones((nh, nw), np.float32), ph, pw, sy, sx)
    c = np.ascontiguousarray
    return dict(
        Hr=c(H_split.real), Hi=c(H_split.imag), R=c(R_split),
        X_divmat=(1.0 / (ones_pad + params.mu1)).astype(np.float32),
        data_pad=_pad_np(data2d, ph, pw, sy, sx),
        psf_shape=(nh, nw), padded_shape=(ph, pw), start=(sy, sx),
    )


def _split_from_np(arrs: list, device, stack: bool = False) -> SplitPrecomp:
    """A SplitPrecomp of the first set of numpy arrays, or with ``stack`` of
    all of them stacked on a leading axis."""
    def t(f):
        x = np.stack([a[f] for a in arrs]) if stack else arrs[0][f]
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    return SplitPrecomp(*[t(f) for f in SPLIT_FIELDS], psf_shape=arrs[0]["psf_shape"],
                        padded_shape=arrs[0]["padded_shape"], start=arrs[0]["start"])


def precompute_split(psf2d, data2d, params: ADMMParams = ADMMParams(),
                     device=None) -> SplitPrecomp:
    """Full-width split precompute for a (H, W) grayscale PSF and
    measurement, placed on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    return _split_from_np([precompute_split_np(as_host(psf2d), as_host(data2d), params)],
                          device)


def _finite_diff(x):
    """Periodic differences along H and W (admm_split.py:86-98)."""
    return torch.roll(x, 1, dims=-2) - x, torch.roll(x, 1, dims=-1) - x


def _finite_diff_adj(u0, u1):
    return (torch.roll(u0, -1, dims=-2) - u0) + (torch.roll(u1, -1, dims=-1) - u1)


def _crop(image, pre):
    sy, sx = pre.start
    nh, nw = pre.psf_shape
    return torch.clamp(image.to(torch.float32)[..., sy : sy + nh, sx : sx + nw], min=0.0)


def _run_split_torch(pre: SplitPrecomp, params: ADMMParams, n_iter: int):
    """The JAX package's ``"jax"`` backend (admm_split.py:534-601): the
    unfused split loop through the plain full-width transforms, f32."""
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau
    bmul = kernels.bmul
    Hr, Hi, R = pre.Hr, pre.Hi, pre.R

    def fwd2(x):
        return sf.fft_h_split(*sf.fft_w_split(x))

    def inv2(vr, vi):
        return sf.ifft_w_split(*sf.ifft_h_split(vr, vi))

    zeros = torch.zeros(tuple(pre.data_pad.shape), dtype=torch.float32, device=Hr.device)
    image = xi = rho = eta0 = eta1 = fwd = psi0 = psi1 = zeros
    for _ in range(int(n_iter)):
        U0 = soft_thresh(psi0 + eta0 / mu2, tau / mu2)
        U1 = soft_thresh(psi1 + eta1 / mu2, tau / mu2)
        X = bmul(pre.X_divmat, xi + mu1 * fwd + pre.data_pad)
        W = torch.clamp(rho / mu3 + image, min=0.0)
        rk = (mu3 * W - rho) + _finite_diff_adj(mu2 * U0 - eta0, mu2 * U1 - eta1)
        v = mu1 * X - xi
        ar, ai = fwd2(rk)
        br, bi = fwd2(v)
        fr = bmul(R, ar + bmul(Hr, br) + bmul(Hi, bi))
        fi = bmul(R, ai + bmul(Hr, bi) - bmul(Hi, br))
        # image = ifft(F); forward = ifft(H F)
        image = inv2(fr, fi)
        fwd = inv2(bmul(Hr, fr) - bmul(Hi, fi), bmul(Hi, fr) + bmul(Hr, fi))
        psi0, psi1 = _finite_diff(image)
        xi = xi + mu1 * (fwd - X)
        rho = rho + mu3 * (image - W)
        eta0 = eta0 + mu2 * (psi0 - U0)
        eta1 = eta1 + mu2 * (psi1 - U1)
    return _crop(image, pre)


def run_split_fused(pre: SplitPrecomp, params: ADMMParams = ADMMParams(),
                    n_iter: int = 100, ops=None, io: str = "f32",
                    carry_tv: str = "f32", carry_v: str = "f32"):
    """Full-width fused ADMM with the carry-rebuild state (the JAX
    package's ``run_split_fused``): per iteration K10 ``e1_carry``, K4 /
    K5 / K4 ``fft_h_combine_dual`` and K11 ``ifft_w_dual``, one launch
    each per pass whatever the number of planes.  Returns the cropped
    image clipped at 0, (H, W) for one plane and (P, H, W) for a stack.

    ``io`` is "f32" or "bf16" (spectra, image, forward plane, mask and
    data); ``carry_tv`` "f32" or "bf16" (a0, a1, b); ``carry_v`` "f32",
    "bf16" or "i16" (v, fixed point at 256 mu1).  There is no saturation
    channel, as in the JAX package.  ``ops`` is the kernel set,
    ``kernels.KERNELS`` by default; ``kernels.PLAIN`` runs the same loop
    through the plain PyTorch versions."""
    ops = ops or kernels.KERNELS
    io_t = kernels.storage_dtype(io, ("f32", "bf16"))
    if carry_tv == "i16":
        raise ValueError("carry_tv='i16': the full-width path has no int16 TV carries in "
                         "the JAX package (e1_carry stores a0, a1, b at _CARRY_DTYPE); "
                         "use 'f32' or 'bf16'")
    tv_t = kernels.storage_dtype(carry_tv, ("f32", "bf16"))
    v_t = kernels.storage_dtype(carry_v)
    _check_planes(pre)
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau
    ph = pre.padded_shape[0]
    shape, dev = tuple(pre.data_pad.shape), pre.Hr.device
    Hr, Hi, R = pre.Hr.to(io_t), pre.Hi.to(io_t), pre.R.to(io_t)
    # X_divmat's two values are rebuilt in the kernel from the {0,1}
    # support mask (exact in bf16)
    mask = (pre.X_divmat * mu1 < 0.5).to(io_t)
    data_pad = pre.data_pad.to(io_t)
    image = fwd = torch.zeros(shape, dtype=io_t, device=dev)
    v = torch.zeros(shape, dtype=v_t, device=dev)
    a0 = a1 = b = torch.zeros(shape, dtype=tv_t, device=dev)
    for _ in range(int(n_iter)):
        rkr, rki, vr, vi, v, a0, a1, b = ops.e1_carry(
            image, fwd, v, b, a0, a1, mask, data_pad, mu1, mu2, mu3, tau)
        (a0r, a0i), (a1r, a1i) = kernels.fft_h_combine_dual(
            rkr, rki, vr, vi, Hr, Hi, R, ph, ops=ops)
        image, fwd = ops.ifft_w_dual(a0r, a0i, a1r, a1i)
    return _crop(image, pre)


def _diff_to(x, dim, out, back):
    """The periodic difference of ``x`` along ``dim`` written into ``out``
    by slices (no rolled copy): ``back`` roll(x, 1) - x, else x -
    roll(x, -1).  Both are x[r - 1] - x[r] at shifted places."""
    n = x.shape[dim]
    head, tail = (1, 0) if back else (0, n - 1)
    torch.sub(x.narrow(dim, 0, n - 1), x.narrow(dim, 1, n - 1), out=out.narrow(dim, head, n - 1))
    torch.sub(x.narrow(dim, n - 1, 1), x.narrow(dim, 0, 1), out=out.narrow(dim, tail, 1))
    return out


def run_split_pallas(pre: SplitPrecomp, params: ADMMParams = ADMMParams(),
                     n_iter: int = 100, ops=None, io: str = "f32"):
    """Full-width split ADMM through the pass-level kernels (the JAX
    package's ``run_split(backend="pallas")``, admm_split.py:528-601):
    per iteration K12 ``fft_w`` -> ``fft_h`` (K14, K15) for rk, K12 ->
    ``fft_h_combine`` (K14, K16) for v, ``ifft_h_dual`` (K17, K4) -> two
    K13 ``ifft_w`` for the image and the forward plane; one launch each
    per pass whatever the number of planes.  Returns the cropped image
    clipped at 0, (H, W) for one plane and (P, H, W) for a stack.

    ``io`` ("f32" or "bf16") is the JAX package's ``_IO_DTYPE``: the filter
    planes, the spectra, the image, the forward plane and the differences
    psi (from the io-typed image) ride at it, and mu1 * fwd is rounded to
    it, as in the JAX loop; the duals xi, rho, eta0, eta1 stay f32.

    The state algebra between the transforms is PyTorch, written for few
    passes over the planes: each dual is updated in place in two steps
    around the transforms, eta -= mu2 U before them and eta += mu2 psi'
    after (JAX: eta + mu2 (psi' - U)), rho -= mu3 W and rho += mu3 image',
    xi' = mu1 fwd' - v (v = mu1 X - xi); the rolls are slices.  The same
    values as the JAX loop up to the order of f32 roundings.  ``ops`` is the
    kernel set, ``kernels.KERNELS`` by default; ``kernels.PLAIN`` runs the
    same loop through the plain versions."""
    ops = ops or kernels.KERNELS
    io_t = kernels.storage_dtype(io, ("f32", "bf16"))
    _check_planes(pre)
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau
    thr = tau / mu2
    ph = pre.padded_shape[0]
    shape, dev = tuple(pre.data_pad.shape), pre.Hr.device
    f32 = torch.float32
    Hr, Hi, R = pre.Hr.to(io_t), pre.Hi.to(io_t), pre.R.to(io_t)
    Xd, dp = pre.X_divmat, pre.data_pad
    image = fwd = psi0 = psi1 = torch.zeros(shape, dtype=io_t, device=dev)
    xi, rho, eta0, eta1 = (torch.zeros(shape, dtype=f32, device=dev) for _ in range(4))
    for _ in range(int(n_iter)):
        # TV: U = soft(psi + eta / mu2); eta <- eta - mu2 U (= -(mu2 U - eta))
        for eta, psi in ((eta0, psi0), (eta1, psi1)):
            eta.sub_(F.softshrink(torch.add(psi, eta, alpha=1.0 / mu2), thr), alpha=mu2)
        # X = Xdiv (xi + mu1 fwd + data), mu1 fwd at io; v = mu1 X - xi
        mf = fwd * mu1 if io_t != f32 else fwd
        X = torch.add(xi, mf, alpha=1.0 if io_t != f32 else mu1).add_(dp)
        X.view((-1,) + tuple(Xd.shape)).mul_(Xd)
        v = X.mul_(mu1).sub_(xi)
        del X, mf
        # W = max(rho / mu3 + image, 0); rho <- rho - mu3 W
        rho.sub_(torch.add(image, rho, alpha=1.0 / mu3).clamp_(min=0.0), alpha=mu3)
        # rk = (mu3 W - rho) + adj(mu2 U - eta): the adjoint of the new
        # -eta's differences, minus the new rho
        rk = _diff_to(eta0, -2, torch.empty_like(eta0), back=False).add_(eta1)
        n = rk.shape[-1]
        rk.narrow(-1, 0, n - 1).sub_(eta1.narrow(-1, 1, n - 1))
        rk.narrow(-1, n - 1, 1).sub_(eta1.narrow(-1, 0, 1))
        rk.sub_(rho)
        ar, ai = kernels.fft_h(*ops.fft_w(rk.to(io_t)), ph, ops=ops)
        del rk
        fr, fi = kernels.fft_h_combine(*ops.fft_w(v.to(io_t)), ar, ai, Hr, Hi, R, ph, ops=ops)
        del ar, ai
        (a0r, a0i), (a1r, a1i) = kernels.ifft_h_dual(fr, fi, Hr, Hi, ph, ops=ops)
        del fr, fi
        image = ops.ifft_w(a0r, a0i, out_dtype=io_t)
        fwd = ops.ifft_w(a1r, a1i, out_dtype=io_t)
        del a0r, a0i, a1r, a1i
        psi0 = _diff_to(image, -2, torch.empty_like(image), back=True)
        psi1 = _diff_to(image, -1, torch.empty_like(image), back=True)
        # the duals: xi' = mu1 fwd' - v, rho += mu3 image', eta += mu2 psi'
        xi = v.neg_().add_(fwd, alpha=mu1)
        del v
        rho.add_(image, alpha=mu3)
        eta0.add_(psi0, alpha=mu2)
        eta1.add_(psi1, alpha=mu2)
    return _crop(image, pre)


def run_split(pre: SplitPrecomp, params: ADMMParams = ADMMParams(),
              n_iter: int = 100, backend: str = "jax", io: str = "f32",
              carry_tv: str = "f32", carry_v: str = "f32"):
    """Full-width split ADMM of one plane (or a stack); returns the cropped
    image clipped at 0.  ``backend``: "jax" (the default, as in the JAX
    package) or its other name "torch", the unfused loop through the plain
    transforms (f32 only),
    "fused" (:func:`run_split_fused`, which takes the storage modes) or
    "pallas" (:func:`run_split_pallas`, which takes ``io`` and has no
    carries: ``carry_tv`` and ``carry_v`` must be "f32")."""
    if backend == "fused":
        return run_split_fused(pre, params, n_iter, io=io, carry_tv=carry_tv, carry_v=carry_v)
    if backend == "pallas":
        if (carry_tv, carry_v) != ("f32", "f32"):
            raise ValueError("the pallas backend has no carries (its state is f32 duals "
                             "and io planes); carry_tv and carry_v must be 'f32'")
        return run_split_pallas(pre, params, n_iter, io=io)
    if backend not in ("jax", "torch"):
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if (io, carry_tv, carry_v) != ("f32", "f32", "f32"):
        raise ValueError(f"the {backend} backend runs at f32, as the JAX package's jax "
                         "backend; storage modes are for backend='fused' or 'pallas'")
    _check_planes(pre)
    return _run_split_torch(pre, params, n_iter)


def run_split_jit(pre: SplitPrecomp, params: ADMMParams = ADMMParams(),
                  n_iter=100, backend: str = "jax"):
    """The JAX package's compiled entry of :func:`run_split` under its
    name, signature and defaults (f32 storage).  The port has no trace
    step: this runs :func:`run_split` where its inputs are, and exists so
    that code written for the JAX package runs.  ``n_iter`` is an int or a
    0-d tensor."""
    return run_split(pre, params, n_iter, backend=backend)


def precompute_split_general(psf, data, params: ADMMParams = ADMMParams(), device=None):
    """Per-plane full-width precompute for a (D, H, W, C) PSF and (B, D, H,
    W, C) measurements (also (D, H, W, C) or (H, W, C)), placed on
    ``device`` (None: the CUDA card).  Returns ``(pre, info)``: the
    SplitPrecomp arrays stacked over the D * C planes (d-major, then c),
    each computed as :func:`precompute_split` computes a gray plane
    (data_pad from the first batch entry; depth-1 data serves every
    depth), and ``info = {"batch", "depth", "channels"}``."""
    device = resolve_device(device)
    psf = as_host(psf)
    data = _as_5d(as_host(data))
    depth, _, _, ch = psf.shape
    arrs = [precompute_split_np(psf[d, :, :, c],
                                data[0, min(d, data.shape[1] - 1), :, :, c], params)
            for d in range(depth) for c in range(ch)]
    return (_split_from_np(arrs, device, stack=True),
            dict(batch=data.shape[0], depth=depth, channels=ch))


def run_split_general(pre: SplitPrecomp, info: dict, data,
                      params: ADMMParams = ADMMParams(), n_iter: int = 100,
                      backend: str = "jax", io: str = "f32", carry_tv: str = "f32",
                      carry_v: str = "f32"):
    """Batched RGB / 3-D full-width split ADMM (the JAX package's
    ``run_split_general``); returns (B, D, H, W, C), clipped at 0.

    ``pre`` and ``info`` come from :func:`precompute_split_general`.  Data
    of depth 1 is broadcast over the PSF's depths.  The B * D * C planes
    (b-major, then d, then c) are padded from ``data`` on the device and
    run as one stack through :func:`run_split`, the per-PSF constants
    broadcast over the batch: one launch per kernel per pass."""
    dev = pre.Hr.device
    data = _as_5d(as_device(data, torch.float32, dev))
    batch, depth, ch = info["batch"], info["depth"], info["channels"]
    if data.shape[1] == 1 and depth > 1:
        data = data.expand(data.shape[0], depth, *data.shape[2:])
    nh, nw = pre.psf_shape
    ph, pw = pre.padded_shape
    sy, sx = pre.start
    planes = data.permute(0, 1, 4, 2, 3).reshape(batch * depth * ch, nh, nw)
    pad = torch.zeros((planes.shape[0], ph, pw), dtype=torch.float32, device=dev)
    pad[:, sy : sy + nh, sx : sx + nw] = planes
    out = run_split(pre._replace(data_pad=pad), params, n_iter, backend=backend, io=io,
                    carry_tv=carry_tv, carry_v=carry_v)
    return out.reshape(batch, depth, ch, nh, nw).permute(0, 1, 3, 4, 2).contiguous()
