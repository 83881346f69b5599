"""Spatially-sharded reconstruction: distributed FFT convolution and ADMM
(port of lenslesspicam_tpu/parallel/spatial.py).

The padded grid's row axis is sharded over the mesh dim ``sp``: each rank
of the dim holds a slab of ``ph / n`` rows of every state plane and runs
the solver's loop on it, one Python loop a rank.  Per iteration:

* the 2-D transforms are pencil decompositions: local transforms along W
  on the row slab, one all-to-all that re-pencils the W spectrum so each
  rank holds ``1 / n`` of its columns over the whole H axis, local
  transforms along H, the spectrum multiply, and the inverse chain;
* the TV finite differences reach across slab boundaries through one-row
  halo exchanges round the ring (circular, as ``torch.roll``);
* every elementwise update is local.

Three backends of the same algebra (the carry-rebuild state of
``recon/admm.py``: the duals are rebuilt each iteration from one identity
each, halving the carried state):

* ``"xla"`` (also named ``"torch"``): ``torch.fft`` pencils, any shape
  whose padded height divides the dim; the half-spectrum W axis is padded
  with zero columns up to a multiple of n;
* ``"pallas"``: the full-width split-order kernels, per iteration K12 twice,
  K14 and K15 four times each, K13 twice and 8 all-to-alls of the r/i
  planes;
* ``"rpallas"``: the half-spectrum packed-real kernels, per iteration K1 on
  the stacked rk and v planes, K4, K5, K4 (``fft_h_combine_dual``) and K9,
  2 all-to-alls of stacked planes, 4 all-gathers of the (rows,) DC/Nyquist
  columns (their length-ph transforms run replicated on every rank) and 2
  ring shifts.

On CUDA tensors the kernel backends launch the port's kernels
(``ops/kernels.py``); on CPU tensors their plain versions run, as every
wrapper does.  Every collective goes through the counted helpers of
``distributed``.  The solvers return the cropped ``(batch, depth, H, W,
C)`` reconstruction on EVERY rank: the row slabs (and, with
``batch_axis``, the batch blocks) are all-gathered after the loop.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_device, as_host
from ..ops import kernels as K
from ..ops.fft_conv import FFTConvolver
from ..ops.split_fft import spectrum_to_half_split, spectrum_to_split
from ..ops.tv import finite_diff_gram_spectrum, soft_thresh
from ..recon.admm import ADMMParams
from .distributed import (NamedSharding, all_gather, all_to_all, axis_size,
                          collective_counts, local_device, put_global,
                          reset_collective_counts, ring_shift)

AXIS = "sp"
BACKENDS = ("auto", "xla", "torch", "pallas", "rpallas")


# ---------------------------------------------------------------------------
# distributed filter application (rfft2 -> multiply -> irfft2)
# ---------------------------------------------------------------------------


def _pad_cols(x, total):
    pad = total - x.shape[-2]
    if pad == 0:
        return x
    zeros = torch.zeros(x.shape[:-2] + (pad, x.shape[-1]), dtype=x.dtype, device=x.device)
    return torch.cat([x, zeros], dim=-2)


def filtered_synthesis_sharded(x_local, H_local, ph, pw, n_shards, group=None):
    """irfft2(rfft2(x) * H) of a row-sharded x, on each rank of ``group``
    (None: the world) with its slab.

    x_local: (..., ph / n_shards, pw, C) real.
    H_local: (..., ph, pwh_padded / n_shards, C) complex or real, the
        spectrum sharded along its half-W axis zero-padded to a multiple of
        n_shards.
    """
    pwh = pw // 2 + 1
    pwh_pad = -(-pwh // n_shards) * n_shards
    # 1. local rFFT along W, columns padded to a multiple of n
    fw = _pad_cols(torch.fft.rfft(x_local, dim=-2), pwh_pad)
    # 2. all-to-all: the half-W axis split over the ranks, the rows gathered
    fw = all_to_all(fw, fw.dim() - 2, fw.dim() - 3, group)
    # 3. local FFT along the whole H axis, spectrum multiply
    fh = torch.fft.fft(fw, dim=-3) * H_local
    # 4. the inverse chain
    fh = torch.fft.ifft(fh, dim=-3)
    fh = all_to_all(fh, fh.dim() - 3, fh.dim() - 2, group)
    return torch.fft.irfft(fh[..., :pwh, :], n=pw, dim=-2)


# ---------------------------------------------------------------------------
# halo-exchange rolls (periodic finite differences across slabs)
# ---------------------------------------------------------------------------


def roll_down_sharded(x, group=None):
    """Global ``torch.roll(x, 1, dims=-3)`` of row-sharded x: each rank
    receives its predecessor's last row."""
    prev_last = ring_shift(x[..., -1:, :, :], True, group)
    return torch.cat([prev_last, x[..., :-1, :, :]], dim=-3)


def roll_up_sharded(x, group=None):
    """Global ``torch.roll(x, -1, dims=-3)``: each rank receives its
    successor's first row."""
    next_first = ring_shift(x[..., :1, :, :], False, group)
    return torch.cat([x[..., 1:, :, :], next_first], dim=-3)


def finite_diff_sharded(x, group=None):
    """(roll_h - x, roll_w - x) stacked (``ops/tv.py`` ``finite_diff``)."""
    return torch.stack((roll_down_sharded(x, group) - x, torch.roll(x, 1, dims=-2) - x),
                       dim=x.dim())


def finite_diff_adj_sharded(u, group=None):
    d1 = roll_up_sharded(u[..., 0], group) - u[..., 0]
    d2 = torch.roll(u[..., 1], -1, dims=-2) - u[..., 1]
    return d1 + d2


# ---------------------------------------------------------------------------
# spatially-sharded ADMM
# ---------------------------------------------------------------------------


def _as_5d(data, dtype, device):
    data = as_device(data, dtype, device)
    if data.dim() == 3:
        data = data[None, None]
    elif data.dim() == 4:
        data = data[None]
    return data


def _choose_backend(mesh, conv: FFTConvolver, backend: str, batch_axis) -> str:
    """The backend that ``backend`` names: "torch" is "xla"; "auto" is
    "rpallas" on CUDA where the half-spectrum pencils divide the dim (and
    no ``batch_axis``), else "pallas" where the full-width ones do, else
    "xla"; on the CPU "xla"."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "torch":
        return "xla"
    if backend != "auto":
        return backend
    if batch_axis is None and _pallas_rspatial_ok(mesh, conv):
        return "rpallas"
    if batch_axis is None and _pallas_spatial_ok(mesh, conv):
        return "pallas"
    return "xla"


def _gather_rows(padded, mesh, batch_axis=None):
    """The row slabs (axis 2) gathered over ``sp``, then the batch blocks
    (axis 0) over ``batch_axis``."""
    out = all_gather(padded, 2, mesh.get_group(AXIS))
    if batch_axis is not None:
        out = all_gather(out, 0, mesh.get_group(batch_axis))
    return out


def spatial_sharded_admm(mesh, conv: FFTConvolver, data,
                         params: ADMMParams = ADMMParams(), n_iter: int = 100,
                         backend: str = "auto", batch_axis: str | None = None):
    """ADMM with every state plane row-sharded over the mesh dim ``sp``;
    returns the cropped (batch, depth, H, W, C) reconstruction on every
    rank.  ``conv`` (the unpadded, backward-norm convolver of
    ``recon.admm.make_convolver``, with even padded dims) and ``data`` are
    the full ones on every rank, on the rank's device.

    batch_axis: a second mesh dim to shard the BATCH over: the multi-host
        layout (``distributed.multihost_mesh``), the batch over the dim
        that spans hosts (one independent solve a host, no traffic
        between hosts in the loop), rows over the dim inside a host.
        "xla" backend only.

    backend: "xla" (also "torch"): ``torch.fft`` pencils, any shape;
             "rpallas": the half-spectrum packed-real kernel pipeline
             (:func:`spatial_sharded_admm_rpallas`), the fastest;
             "pallas": the full-width split-order kernels
             (:func:`spatial_sharded_admm_pallas`);
             "auto": rpallas on CUDA when the padded grid's rows and half
             width divide the dim, else pallas when its rows and width do,
             else xla; xla on the CPU.
    """
    backend = _choose_backend(mesh, conv, backend, batch_axis)
    if backend == "rpallas":
        assert batch_axis is None, "batch_axis: xla backend only"
        return spatial_sharded_admm_rpallas(mesh, conv, data, params, n_iter)
    if backend == "pallas":
        assert batch_axis is None, "batch_axis: xla backend only"
        return spatial_sharded_admm_pallas(mesh, conv, data, params, n_iter)
    assert AXIS in mesh.mesh_dim_names
    # the sharded synthesis chain has no trailing ifftshift roll: the
    # shift must be folded into H (even padded dims), else the output
    # would be silently rolled against admm.run
    assert conv.shift_folded, (
        "spatial_sharded_admm requires an even-padded convolver "
        "(conv.shift_folded); rebuild the convolver with pad_policy='tpu'")
    group = mesh.get_group(AXIS)
    n_shards = axis_size(mesh, AXIS)
    depth, ph, pw, ch = conv.padded_shape
    assert ph % n_shards == 0, f"padded height {ph} must divide {n_shards}"
    pwh_pad = -(-(pw // 2 + 1) // n_shards) * n_shards
    dtype, dev = conv.H.real.dtype, conv.H.device
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau

    data_pad = conv.pad_input(_as_5d(data, dtype, dev))
    psi_tpsi = finite_diff_gram_spectrum(conv.padded_shape, dtype, dev)
    R_divmat = 1.0 / (mu1 * conv.mag_sq() + mu2 * psi_tpsi + mu3)
    X_divmat = 1.0 / (conv.pad_input(torch.ones((depth,) + tuple(conv.psf_shape[-3:-1])
                                                + (ch,), dtype=dtype, device=dev)) + mu1)
    cols = NamedSharding(mesh, (None, None, AXIS))
    H_l = put_global(_pad_cols(conv.H, pwh_pad), cols).data
    R_l = put_global(_pad_cols(R_divmat.to(dtype), pwh_pad), cols).data
    Xdiv_l = put_global(X_divmat, NamedSharding(mesh, (None, AXIS))).data
    data_l = put_global(data_pad, NamedSharding(mesh, (batch_axis, None, AXIS))).data
    Hc_l = torch.conj(H_l)

    def conv_apply(v, filt):
        return filtered_synthesis_sharded(v, filt, ph, pw, n_shards, group)

    zeros = data_l * 0.0
    image, forward_out, v, b = zeros, zeros, zeros, zeros
    a = zeros[..., None] * torch.zeros(2, dtype=dtype, device=dev)
    for _ in range(int(n_iter)):
        psi = finite_diff_sharded(image, group)
        eta_eff = mu2 * psi - a
        U = soft_thresh(psi + eta_eff / mu2, tau / mu2)
        a = mu2 * U - eta_eff
        xi = mu1 * forward_out - v
        X = Xdiv_l * (xi + mu1 * forward_out + data_l)
        v = mu1 * X - xi
        rho = mu3 * image - b
        W = torch.clamp(rho / mu3 + image, min=0.0)
        b = mu3 * W - rho
        rk = b + finite_diff_adj_sharded(a, group) + conv_apply(v, Hc_l)
        image = conv_apply(rk, R_l)
        forward_out = conv_apply(image, H_l)
    return conv.crop(_gather_rows(torch.clamp(image, min=0.0), mesh, batch_axis))


# ---------------------------------------------------------------------------
# the full-width split-order kernels composed with the pencil decomposition
#
# Per 2-D transform: K12 along W on the row slab, one all-to-all of each of
# the r and i planes re-pencils the split-order W spectrum, K14 and K15
# along H on the whole columns (``fft_h``), and the inverse chain (K15, K14
# as ``ifft_h``, all-to-alls, K13).  Split order needs no reordering for the
# collectives: an all-to-all moves contiguous chunks of the split-order
# axis, and the filter spectra are sharded in the same chunks (an
# elementwise product does not care about the order).  Layout: plane-major
# (B, P = D * C, rows, Pw); the kernels take (B * P) planes in one launch,
# the filter planes (P) broadcast over the batch.
# ---------------------------------------------------------------------------


def _on_card(conv: FFTConvolver) -> bool:
    return conv.H.device.type == "cuda"


def _pallas_spatial_ok(mesh, conv: FFTConvolver) -> bool:
    """True when the full-width pencil path can run on the card: the
    padded dims divide the ``sp`` dim and the shift is folded (the plain
    versions on the CPU are for tests, not a default)."""
    if AXIS not in mesh.mesh_dim_names:
        return False
    n = axis_size(mesh, AXIS)
    depth, ph, pw, ch = conv.padded_shape
    if ph % n or pw % n or not conv.shift_folded:
        return False
    return _on_card(conv)


def _full_from_half(half: np.ndarray, pw: int) -> np.ndarray:
    """(Ph, Pw//2+1) natural-order half spectrum of a REAL kernel -> (Ph,
    Pw) full spectrum by Hermitian symmetry X[h, w] = conj(X[(-h) % Ph,
    Pw - w])."""
    ph, pwh = half.shape
    full = np.zeros((ph, pw), half.dtype)
    full[:, :pwh] = half
    wrest = np.arange(pwh, pw)
    rows = (-np.arange(ph)) % ph
    full[:, pwh:] = np.conj(half[rows][:, pw - wrest])
    return full


def _psi_gram_full(ph: int, pw: int) -> np.ndarray:
    """|fft2| of the 4-point Laplacian on the FULL (Ph, Pw) grid (the
    full-width ``ops/tv.finite_diff_gram_spectrum``)."""
    kern = np.zeros((ph, pw), np.float64)
    kern[0, 0] = 4.0
    kern[0, 1] = kern[0, -1] = kern[1, 0] = kern[-1, 0] = -1.0
    return np.abs(np.fft.fft2(kern)).astype(np.float32)


def _plane_major(conv: FFTConvolver, data, params: ADMMParams):
    """(data (B, P, Ph, Pw), X_divmat (P, Ph, Pw)) plane-major f32 on the
    convolver's device, P = D * C."""
    depth, ph, pw, ch = conv.padded_shape
    dev = conv.H.device
    data_pad = conv.pad_input(_as_5d(data, torch.float32, dev))
    batch = data_pad.shape[0]
    data_pl = data_pad.movedim(-1, 2).reshape(batch, depth * ch, ph, pw)
    ones = conv.pad_input(torch.ones((depth,) + tuple(conv.psf_shape[-3:-1]) + (ch,),
                                     dtype=torch.float32, device=dev))
    xdiv_pl = (1.0 / (ones + params.mu1)).movedim(-1, 1).reshape(depth * ch, ph, pw)
    return data_pl, xdiv_pl


def _pallas_precompute(conv: FFTConvolver, params: ADMMParams):
    """The full-width filter planes on the host, as the JAX package
    computes them: (Hr, Hi, R), each (P, Ph, Pw) f32 in split order on
    both axes."""
    depth, ph, pw, ch = conv.padded_shape
    mu1, mu2, mu3 = params.mu1, params.mu2, params.mu3
    H_half = as_host(conv.H, np.complex64)
    psi_full = _psi_gram_full(ph, pw)
    H_pl = np.empty((depth * ch, ph, pw), np.complex64)
    R_pl = np.empty((depth * ch, ph, pw), np.float32)
    for d in range(depth):
        for c in range(ch):
            Hf = _full_from_half(H_half[d, :, :, c], pw)
            Rf = 1.0 / (mu1 * np.abs(Hf) ** 2 + mu2 * psi_full + mu3)
            H_pl[d * ch + c] = spectrum_to_split(Hf, axes=(0, 1))
            R_pl[d * ch + c] = spectrum_to_split(Rf.astype(np.float32), axes=(0, 1))
    c = np.ascontiguousarray
    return c(H_pl.real), c(H_pl.imag), R_pl


def _crop_planes(padded_pl, conv: FFTConvolver):
    """(B, P, Ph, Pw) plane-major -> the cropped (B, D, H, W, C)."""
    depth, ph, pw, ch = conv.padded_shape
    padded = padded_pl.reshape(padded_pl.shape[0], depth, ch, ph, pw).movedim(2, -1)
    return conv.crop(padded)


def spatial_sharded_admm_pallas(mesh, conv: FFTConvolver, data,
                                params: ADMMParams = ADMMParams(), n_iter: int = 100):
    """Row-sharded ADMM whose distributed FFTs run on the full-width
    split-order kernels (block comment above).  Same algebra as
    :func:`spatial_sharded_admm` and ``recon/admm_split.run_split``: the
    4-transform iteration F = R * (A + conj(H) B) with TV halos."""
    assert AXIS in mesh.mesh_dim_names
    assert conv.shift_folded, "spatial_sharded_admm_pallas requires an even-padded convolver"
    n_shards = axis_size(mesh, AXIS)
    depth, ph, pw, ch = conv.padded_shape
    assert ph % n_shards == 0 and pw % n_shards == 0, (
        f"padded dims {(ph, pw)} must divide the {n_shards}-way 'sp' dim")
    padded_pl = _build_pallas_run(mesh, ph, params, n_iter)(
        *_pallas_inputs(mesh, conv, data, params))
    return _crop_planes(_gather_rows(padded_pl, mesh), conv)


def _pallas_inputs(mesh, conv: FFTConvolver, data, params: ADMMParams):
    """The rank's arguments of the pallas loop (:func:`_build_pallas_run`):
    the host precompute, placed."""
    Hr, Hi, R = _pallas_precompute(conv, params)
    data_pl, xdiv_pl = _plane_major(conv, data, params)
    spec = NamedSharding(mesh, (None, None, AXIS))      # columns of (P, Ph, Pw)
    rows3 = NamedSharding(mesh, (None, AXIS))           # rows of (P, Ph, Pw)
    return (*(put_global(a, spec).data for a in (Hr, Hi, R)),
            put_global(xdiv_pl, rows3).data, put_global(data_pl, spec).data)


def _roll_rows(x, up: bool, group):
    """Global roll of the row axis (-2) of row-sharded planes by -1 (up)
    or +1, through the halo ring."""
    if up:
        first = ring_shift(x[..., :1, :], False, group)
        return torch.cat([x[..., 1:, :], first], dim=-2)
    last = ring_shift(x[..., -1:, :], True, group)
    return torch.cat([last, x[..., :-1, :]], dim=-2)


def _build_pallas_run(mesh, ph: int, params: ADMMParams, n_iter: int):
    """The rank's plane-major pallas ADMM loop ``run(Hr_l, Hi_l, R_l,
    Xdiv_l, data_l)`` -> its clipped (B, P, rows, Pw) slab of the image:
    the filter planes (P, Ph, cols) of its column pencil, X_divmat (P,
    rows, Pw) and the data (B, P, rows, Pw) of its row slab."""
    group = mesh.get_group(AXIS)
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau

    def run(Hr_l, Hi_l, R_l, Xdiv_l, data_l):
        batch, nplanes, _, pw = data_l.shape
        cols = Hr_l.shape[-1]

        def pencils(t):     # (B, P, Ph, cols) as the kernels' (B * P) planes
            return t.reshape(batch * nplanes, ph, cols)

        def fwd2(x):        # K12, a2a, K14 + K15 (fft_h)
            wr, wi = K.fft_w(x)
            hr, hi = K.fft_h(pencils(all_to_all(wr, 3, 2, group)),
                             pencils(all_to_all(wi, 3, 2, group)), ph)
            return hr.reshape(batch, nplanes, ph, cols), hi.reshape(batch, nplanes, ph, cols)

        def inv2(vr, vi):   # K15 + K14 (ifft_h), a2a, K13
            br, bi = K.ifft_h(pencils(vr), pencils(vi), ph)
            shape = (batch, nplanes, ph, cols)
            return K.ifft_w(all_to_all(br.reshape(shape), 2, 3, group),
                            all_to_all(bi.reshape(shape), 2, 3, group))

        # carry-rebuild state (see spatial_sharded_admm)
        zeros = data_l * 0.0
        image, forward_out, v, b, a0, a1 = (zeros,) * 6
        for _ in range(int(n_iter)):
            psi0 = _roll_rows(image, False, group) - image
            psi1 = torch.roll(image, 1, dims=-1) - image
            eta0_eff = mu2 * psi0 - a0
            eta1_eff = mu2 * psi1 - a1
            U0 = soft_thresh(psi0 + eta0_eff / mu2, tau / mu2)
            U1 = soft_thresh(psi1 + eta1_eff / mu2, tau / mu2)
            a0 = mu2 * U0 - eta0_eff
            a1 = mu2 * U1 - eta1_eff
            xi = mu1 * forward_out - v
            X = Xdiv_l * (xi + mu1 * forward_out + data_l)
            v = mu1 * X - xi
            rho = mu3 * image - b
            W = torch.clamp(rho / mu3 + image, min=0.0)
            b = mu3 * W - rho
            rk = (b + (_roll_rows(a0, True, group) - a0)
                  + (torch.roll(a1, -1, dims=-1) - a1))

            ar, ai = fwd2(rk)
            br, bi = fwd2(v)
            fr = R_l * (ar + Hr_l * br + Hi_l * bi)
            fi = R_l * (ai + Hr_l * bi - Hi_l * br)
            image = inv2(fr, fi)
            forward_out = inv2(fr * Hr_l - fi * Hi_l, fr * Hi_l + fi * Hr_l)
        return torch.clamp(image, min=0.0)

    return run


# ---------------------------------------------------------------------------
# the half-spectrum (packed-real) pencil backend: the single-device fused
# pipeline's kernels in the sharded solver
#
# * packed-real W transforms (K1 rfft_w, K9 irfft_w_dual): every
#   all-to-all payload is HALF the full-width path's (a real plane's W
#   spectrum rides as (rows, Pw/2) r/i instead of (rows, Pw));
# * ONE fused H chain (K4, K5, K4: ``fft_h_combine_dual``) runs the forward
#   H transform of both planes, the spectrum combine F = R (A + conj(H) B),
#   the H-filter multiply and the dual inverse H transform;
# * K9 gives image and forward estimate from one launch, the exact
#   DC/Nyquist packed-lane columns patched in;
# * per iteration 2 all-to-alls (the rk/v forward spectra stacked in one,
#   the image/forward inverse spectra in the other), 4 all-gathers of the
#   (rows,) DC/Nyquist columns and 2 one-row ring shifts (the TV halos).
# ---------------------------------------------------------------------------


def _split_roll_p1_last(x, mh):
    """``torch.roll(+1)`` along the natural W axis of split-lane-layout
    planes (even lanes then odd lanes on the last axis)."""
    ev, od = x[..., :mh], x[..., mh:]
    return torch.cat([torch.roll(od, 1, dims=-1), ev], dim=-1)


def _split_roll_m1_last(x, mh):
    ev, od = x[..., :mh], x[..., mh:]
    return torch.cat([od, torch.roll(ev, -1, dims=-1)], dim=-1)


def _to_split_last(x):
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _from_split_last(x):
    mh = x.shape[-1] // 2
    return torch.stack([x[..., :mh], x[..., mh:]], dim=-1).reshape(*x.shape[:-1], 2 * mh)


def _pallas_rspatial_ok(mesh, conv: FFTConvolver) -> bool:
    """True when the half-spectrum pencil path can run on the card: even
    padded dims, the rows and the half-W axis divide the ``sp`` dim, the
    shift folded."""
    if AXIS not in mesh.mesh_dim_names:
        return False
    n = axis_size(mesh, AXIS)
    depth, ph, pw, ch = conv.padded_shape
    mh = pw // 2
    if pw % 2 or ph % n or mh % n or not conv.shift_folded:
        return False
    return _on_card(conv)


def _rpallas_precompute(conv: FFTConvolver, params: ADMMParams):
    """The half-spectrum filter planes on the host, as the JAX package
    computes them: Hr, Hi, R (P, Ph, Pw/2) in split order on both axes,
    and the DC (kw = 0) / Nyquist (kw = Pw/2) columns H0, HM (P, Ph)
    complex64 and R0, RM (P, Ph) f32 in natural H order."""
    depth, ph, pw, ch = conv.padded_shape
    mh = pw // 2
    mu1, mu2, mu3 = params.mu1, params.mu2, params.mu3
    H_half = as_host(conv.H, np.complex64)
    psi_full = _psi_gram_full(ph, pw)
    nplanes = depth * ch
    Hr, Hi, R = (np.empty((nplanes, ph, mh), np.float32) for _ in range(3))
    H0, HM = (np.empty((nplanes, ph), np.complex64) for _ in range(2))
    R0, RM = (np.empty((nplanes, ph), np.float32) for _ in range(2))
    for d in range(depth):
        for c in range(ch):
            Hf = _full_from_half(H_half[d, :, :, c], pw)
            Rf = (1.0 / (mu1 * np.abs(Hf) ** 2 + mu2 * psi_full + mu3)).astype(np.float32)
            k = d * ch + c
            Hh = spectrum_to_half_split(Hf)
            Hr[k], Hi[k] = Hh.real, Hh.imag
            R[k] = spectrum_to_half_split(Rf).real
            H0[k], HM[k] = Hf[:, 0], Hf[:, mh]
            R0[k], RM[k] = Rf[:, 0], Rf[:, mh]
    return Hr, Hi, R, H0, HM, R0, RM


def spatial_sharded_admm_rpallas(mesh, conv: FFTConvolver, data,
                                 params: ADMMParams = ADMMParams(), n_iter: int = 100):
    """Row-sharded ADMM on the half-spectrum packed-real pencil backend
    (block comment above).  Same algebra and output as
    :func:`spatial_sharded_admm`."""
    assert AXIS in mesh.mesh_dim_names
    assert conv.shift_folded, "spatial_sharded_admm_rpallas requires an even-padded convolver"
    n_shards = axis_size(mesh, AXIS)
    depth, ph, pw, ch = conv.padded_shape
    mh = pw // 2
    assert pw % 2 == 0 and ph % n_shards == 0 and mh % n_shards == 0, (
        f"padded dims {(ph, pw)} must divide the {n_shards}-way 'sp' dim")
    padded_pl = _build_rpallas_run(mesh, ph, pw, params, n_iter)(
        *_rpallas_inputs(mesh, conv, data, params))
    return _crop_planes(_from_split_last(_gather_rows(padded_pl, mesh)), conv)


def _rpallas_inputs(mesh, conv: FFTConvolver, data, params: ADMMParams):
    """The rank's arguments of the rpallas loop (:func:`_build_rpallas_run`):
    the host precompute, placed."""
    Hr, Hi, R, H0, HM, R0, RM = _rpallas_precompute(conv, params)
    data_pl, xdiv_pl = _plane_major(conv, data, params)
    pencil = NamedSharding(mesh, (None, None, AXIS))    # columns of (P, Ph, cols)
    rows3 = NamedSharding(mesh, (None, AXIS))           # rows of (P, Ph, Pw)
    rows4 = NamedSharding(mesh, (None, None, AXIS))     # rows of (B, P, Ph, Pw)
    dev = local_device()
    return (*(put_global(a, pencil).data for a in (Hr, Hi, R)),
            put_global(_to_split_last(xdiv_pl), rows3).data,
            put_global(_to_split_last(data_pl), rows4).data,
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (H0.real, H0.imag, HM.real, HM.imag, R0, RM)))


def ici_traffic_model(ph: int, pw: int, n_shards: int, nplanes: int = 1,
                      batch: int = 1, bytes_per_el: int = 4) -> dict:
    """Modelled per-iteration traffic between the devices of the ``sp``
    dim of the half-spectrum pencil solver at a padded grid: 2 stacked
    all-to-alls of 4 half-width planes each (each device sends (n-1)/n of
    its slab), one (Ph,) all-gather x 4 columns, and 2 one-row ring shifts
    (the image halo of the row-axis TV forward difference and the a0 halo
    of its adjoint).  :func:`collective_bytes_per_iter` reads the same
    numbers from the counted collectives of a run."""
    mh = pw // 2
    frac = (n_shards - 1) / n_shards
    a2a_bytes = 2 * (4 * batch * nplanes * (ph // n_shards) * mh * bytes_per_el) * frac
    gather_bytes = 4 * batch * nplanes * ph * bytes_per_el * frac
    halo_bytes = 2 * batch * nplanes * pw * bytes_per_el
    full_width_a2a = 2 * a2a_bytes  # the full-width pencil path's cost
    return {
        "a2a_bytes_per_iter": a2a_bytes,
        "gather_bytes_per_iter": gather_bytes,
        "halo_bytes_per_iter": halo_bytes,
        "total_ici_bytes_per_iter": a2a_bytes + gather_bytes + halo_bytes,
        "vs_full_width_a2a_bytes": full_width_a2a,
    }


def collective_bytes_per_iter(mesh, ph: int, pw: int, nplanes: int = 1, batch: int = 1,
                              n_iter: int = 50) -> dict:
    """The rpallas loop's collectives per iteration, read from the counted
    collectives of ``n_iter`` iterations on zero planes of the rank's
    shapes at the padded grid (ph, pw), in :func:`ici_traffic_model`'s
    conventions: ``a2a_bytes_per_iter``, ``gather_bytes_per_iter``,
    ``halo_bytes_per_iter``, ``total_ici_bytes_per_iter`` and
    ``op_counts`` (calls per iteration by collective)."""
    n = axis_size(mesh, AXIS)
    mh = pw // 2
    rows, cols = ph // n, mh // n
    dev = local_device()

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    run = _build_rpallas_run(mesh, ph, pw, ADMMParams(), n_iter)
    args = ((z(nplanes, ph, cols),) * 3 + (z(nplanes, rows, pw), z(batch, nplanes, rows, pw))
            + (z(nplanes, ph),) * 6)
    reset_collective_counts()
    run(*args)
    counts = collective_counts()
    a2a, gather, halo = (counts[op]["bytes"] / n_iter
                         for op in ("all-to-all", "all-gather", "collective-permute"))
    return {
        "a2a_bytes_per_iter": a2a,
        "gather_bytes_per_iter": gather,
        "halo_bytes_per_iter": halo,
        "total_ici_bytes_per_iter": a2a + gather + halo,
        "op_counts": {op: counts[op]["calls"] / n_iter
                      for op in ("all-to-all", "all-gather", "collective-permute")},
    }


def _build_rpallas_run(mesh, ph: int, pw: int, params: ADMMParams, n_iter: int):
    """The rank's half-spectrum pencil ADMM loop ``run(Hr_l, Hi_l, R_l,
    Xdiv_l, data_l, H0r, H0i, HMr, HMi, R0, RM)`` -> its clipped (B, P,
    rows, Pw) slab of the image in the split lane layout: the filter
    planes (P, Ph, Pw/2/n) of its column pencil, X_divmat (P, rows, Pw)
    and the data (B, P, rows, Pw) of its row slab, the DC/Nyquist columns
    (P, Ph) whole."""
    group = mesh.get_group(AXIS)
    mu1, mu2, mu3, tau = params.mu1, params.mu2, params.mu3, params.tau
    mh = pw // 2

    def run(Hr_l, Hi_l, R_l, Xdiv_l, data_l, H0r, H0i, HMr, HMi, R0, RM):
        batch, nplanes, rows, _ = data_l.shape
        cols = Hr_l.shape[-1]
        r0 = mesh.get_local_rank(AXIS) * rows
        H0 = torch.complex(H0r, H0i)
        HM = torch.complex(HMr, HMi)

        def stack(t, k, h, w):  # planes k of a stacked (B, 4P, h, w) as (B * P) planes
            return t[:, k * nplanes:(k + 1) * nplanes].reshape(batch * nplanes, h, w)

        def dc_patch(col_rk_r, col_rk_i, col_v_r, col_v_i):
            """The exact DC/Nyquist packed-lane columns: the (B, P, rows)
            slices are all-gathered to whole (Ph,) columns, the four
            length-Ph chains run on every rank, and each keeps its rows,
            (B * P, rows) a column."""
            cols4 = torch.stack([all_gather(c.float(), 2, group)
                                 for c in (col_rk_r, col_rk_i, col_v_r, col_v_i)])
            A0, AM, B0, BM = torch.fft.fft(cols4, dim=-1)
            F0 = R0 * (A0 + torch.conj(H0) * B0)
            FM = RM * (AM + torch.conj(HM) * BM)
            outs = torch.fft.ifft(torch.stack([F0, FM, H0 * F0, HM * FM]), dim=-1).real
            outs = outs[..., r0:r0 + rows]
            return tuple(outs[k].reshape(batch * nplanes, rows).contiguous() for k in range(4))

        zeros = data_l * 0.0
        image, forward_out, v, b, a0, a1 = (zeros,) * 6
        for _ in range(int(n_iter)):
            # local carry-rebuild elementwise block (split layout)
            psi0 = _roll_rows(image, False, group) - image
            psi1 = _split_roll_p1_last(image, mh) - image
            eta0_eff = mu2 * psi0 - a0
            eta1_eff = mu2 * psi1 - a1
            U0 = soft_thresh(psi0 + eta0_eff / mu2, tau / mu2)
            U1 = soft_thresh(psi1 + eta1_eff / mu2, tau / mu2)
            a0 = mu2 * U0 - eta0_eff
            a1 = mu2 * U1 - eta1_eff
            xi = mu1 * forward_out - v
            X = Xdiv_l * (xi + mu1 * forward_out + data_l)
            v = mu1 * X - xi
            rho = mu3 * image - b
            W = torch.clamp(rho / mu3 + image, min=0.0)
            b = mu3 * W - rho
            rk = (b + (_roll_rows(a0, True, group) - a0)
                  + (_split_roll_m1_last(a1, mh) - a1))

            # K1 on rk and v stacked (one launch), ONE stacked forward a2a
            zr, zi = K.rfft_w(torch.cat([rk, v], dim=1))
            p0, p1, pf, pm = dc_patch(zr[..., 0][:, :nplanes], zi[..., 0][:, :nplanes],
                                      zr[..., 0][:, nplanes:], zi[..., 0][:, nplanes:])
            big = all_to_all(torch.cat([zr, zi], dim=1), 3, 2, group)
            rkr, vr, rki, vi = (stack(big, k, ph, cols) for k in range(4))

            # K4, K5, K4: forward H of both, combine, dual inverse H
            (f0r, f0i), (f1r, f1i) = K.fft_h_combine_dual(rkr, rki, vr, vi,
                                                          Hr_l, Hi_l, R_l, ph)
            big2 = all_to_all(torch.cat([t.reshape(batch, nplanes, ph, cols)
                                         for t in (f0r, f1r, f0i, f1i)], dim=1), 2, 3, group)

            # K9: dual packed-real W inverse with the DC/Nyquist patch
            image, forward_out = K.irfft_w_dual(
                stack(big2, 0, rows, mh), stack(big2, 2, rows, mh),
                stack(big2, 1, rows, mh), stack(big2, 3, rows, mh), p0, p1, pf, pm)
            image = image.reshape(batch, nplanes, rows, pw)
            forward_out = forward_out.reshape(batch, nplanes, rows, pw)
        return torch.clamp(image, min=0.0)

    return run
