"""Fused half-spectrum ADMM: the system's hot path (port of
lenslesspicam_tpu/recon/admm_split.py:205-525, both kernel placements, at
every storage mode of the JAX package, for one plane or a batched RGB /
3-D stack of planes).

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

v3 is the placement to use on the H100: it moves fewer bytes per
iteration and runs faster in every storage mode.  v2 is kept for parity
with the JAX package's v2 path and for K9, which the JAX package's
multi-device solver also runs.

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

from .._device import resolve_device
from ..ops import kernels
from ..ops import split_fft as sf
from ..ops.padding import padded_size
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
    """Entry of the half-spectrum fused solver (the JAX package's
    ``run_rsplit_jit``); the storage modes and placements as in
    :func:`run_split_rfused`."""
    return run_split_rfused(pre, params, n_iter, return_sat=return_sat,
                            io=io, carry_tv=carry_tv, carry_v=carry_v,
                            sat_every=sat_every, placement=placement)


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
    psf = np.asarray(psf, np.float32)
    data = _as_5d(np.asarray(data, np.float32))
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
    data = _as_5d(torch.as_tensor(data, dtype=torch.float32, device=dev))
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
