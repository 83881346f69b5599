"""The fused solver's kernels: CUDA C++ wrappers and their plain PyTorch
versions (port of lenslesspicam_tpu/ops/pallas_kernels2.py at every
storage mode of the JAX package).

| wrapper | TPU kernel it replaces | CUDA source |
|---|---|---|
| ``rfft_w`` (K1) | ``rfft_w`` / ``_w_rfwd_kernel`` | ``csrc/rfft_w.cu``, ``csrc/lpt_fft.cuh`` |
| ``irfft_w`` (K2) | ``irfft_w`` / ``_w_rinv_kernel`` | ``csrc/irfft_w.cu``, ``csrc/lpt_fft.cuh`` |
| ``e1_rtv`` (K3) | ``e1_rtv`` / ``_e1rtv_kernel`` | ``csrc/e1_rtv.cu``, ``csrc/lpt_fft.cuh`` |
| ``h_passA_pair`` (K4) | ``h_passA_pair`` / ``_h_passA_pair_kernel`` | ``csrc/h_pass_a.cu``, ``csrc/lpt_fft.cuh`` |
| ``h_combine_dual`` (K5) | ``_h_combine_dual_kernel`` | ``csrc/h_combine.cu``, ``csrc/lpt_fft.cuh`` |
| ``irfft_w_dual_state`` (K6) | ``irfft_w_dual_state`` / ``_w_rinv_dual_state_kernel`` | ``csrc/w_dual_state.cu``, ``csrc/lpt_fft.cuh`` |
| ``sat_scan_i16`` (K7) | ``sat_scan_i16`` / ``_sat_scan_kernel`` | ``csrc/sat_scan.cu`` |
| ``e1_rcarry`` (K8) | ``e1_rcarry`` / ``_e1cr_kernel`` | ``csrc/e1_rcarry.cuh`` (built as ``e1_rcarry.cu``, ``e1_rcarry_tv_bf16.cu``, ``e1_rcarry_tv_i16.cu``), ``csrc/lpt_fft.cuh`` |
| ``irfft_w_dual`` (K9) | ``irfft_w_dual`` / ``_w_rinv_dual_kernel`` | ``csrc/irfft_w_dual.cu``, ``csrc/lpt_fft.cuh`` |
| ``e1_carry`` (K10) | ``e1_carry`` / ``_e1c_kernel`` | ``csrc/e1_carry.cu``, ``csrc/lpt_fft.cuh`` |
| ``ifft_w_dual`` (K11) | ``ifft_w_dual`` / ``_w_inv_dual_kernel`` | ``csrc/ifft_w_dual.cu``, ``csrc/lpt_fft.cuh`` |
| ``fft_w`` (K12) | ``fft_w`` / ``_w_fwd_kernel`` | ``csrc/fft_w.cu``, ``csrc/lpt_fft.cuh`` |
| ``ifft_w`` (K13) | ``ifft_w`` / ``_w_inv_kernel`` | ``csrc/ifft_w.cu``, ``csrc/lpt_fft.cuh`` |
| ``h_passA`` (K14) | ``h_passA`` / ``_h_passA_kernel`` | ``csrc/h_pass_a.cu``, ``csrc/lpt_fft.cuh`` |
| ``h_passB`` (K15) | ``h_passB`` / ``_h_passB_kernel`` | ``csrc/h_pass_b.cu``, ``csrc/lpt_fft.cuh`` |
| ``h_passB_combine`` (K16) | ``h_passB_combine`` / ``_h_passB_combine_kernel`` | ``csrc/h_pass_b.cu``, ``csrc/lpt_fft.cuh`` |
| ``h_passB_dual`` (K17) | ``h_passB_dual`` / ``_h_passB_dual_kernel`` | ``csrc/h_pass_b.cu``, ``csrc/lpt_fft.cuh`` |
| ``h_passB_combine2`` (K18) | ``fft_h_combine2`` / ``_h_passB_combine2_kernel`` | ``csrc/h_pass_b.cu``, ``csrc/lpt_fft.cuh`` |

A wrapper given CPU tensors runs the plain version (``*_plain``).  Given
CUDA tensors it launches its kernel on the current stream or raises: it
never falls back.  Each wrapper counts its kernel launches in its
``launches`` attribute.  The kernels take their DFT roots, twiddles and
unpack factors from one constant table per transform length, built here
in float64 and cast to f32 as the JAX package builds its plans.

Storage modes.  Planes are stored as float32, bfloat16 or int16 and all
arithmetic runs in f32 (``csrc/storage.cuh``).  The wrappers take no mode
argument: each output's dtype follows an input's, as the JAX kernels'
output dtypes follow the module's storage globals.  The spectra, image,
mask and data planes ride at the io dtype (f32 or bf16); the carries
a0, a1, b (TV) and v at their carry dtypes (f32, bf16 or int16 fixed
point at the full scales ``_tv_scales`` and ``_v_scale``).  A dtype
combination the CUDA code was not built for raises ``TypeError`` on a
CUDA tensor; nothing is converted quietly.

K1-K9 serve the half-spectrum solver (spatial rows in the even/odd split
lane layout, half-width spectra); K10-K13 the full-width one (natural
lane order, full-width complex spectra in split order); K12-K17, K4 and
the compositions ``fft_h``, ``ifft_h``, ``fft_h_combine``, ``ifft_h_dual``
and ``filtered_synthesis_pallas2`` its pass-level backend.  K18 runs only
in its own composition ``fft_h_combine2``, which no solver calls (nor in
the JAX package).

Plane axis (the JAX solver's ``vmap`` over B * D * C planes, written
out).  Every plane operand of K1, K3-K6 and K8-K18 may carry a leading
axis P: spatial planes (P, ph, pw), half spectra (P, ph, pw/2), H-axis
views (P, n1, n2, W), DC columns (P, ph).  The per-PSF constants (the
filter planes H and R, the support mask) carry Pc with P % Pc == 0, and
plane p reads constant plane p % Pc: the constants are broadcast over
the batch, never copied P times.  2-D operands are a stack of one.  One
call is one launch whatever P is.  K2 stays 2-D; K7 scans any shape.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from . import _build
from .split_fft import (_factor, _plan, _plan_t, _rplan, fft_w_split, ifft_w_split,
                        irfft_w_split, rfft_w_split)

_F32 = torch.float32


# ---------------------------------------------------------------------------
# small f32 algebra shared with the JAX kernels' bodies
# ---------------------------------------------------------------------------


def _soft(x, thr):
    return torch.sign(x) * torch.clamp(torch.abs(x) - thr, min=0.0)


def _split_roll_p1(x, mh):
    """roll(x, +1) along natural W in the even/odd split lane layout:
    new_even[j] = odd[j-1], new_odd[j] = even[j]."""
    ev, od = x[..., :mh], x[..., mh:]
    return torch.cat([torch.roll(od, 1, dims=-1), ev], dim=-1)


def _split_roll_m1(x, mh):
    """roll(x, -1) along natural W in the even/odd split lane layout:
    new_even[j] = odd[j], new_odd[j] = even[j+1]."""
    ev, od = x[..., :mh], x[..., mh:]
    return torch.cat([od, torch.roll(ev, -1, dims=-1)], dim=-1)


def _w_rolls(natural, mh):
    """(roll(+1), roll(-1)) along natural W, for rows in natural lane order
    or in the split lane layout of half width ``mh``."""
    if natural:
        return (lambda x: torch.roll(x, 1, dims=-1)), (lambda x: torch.roll(x, -1, dims=-1))
    return (lambda x: _split_roll_p1(x, mh)), (lambda x: _split_roll_m1(x, mh))


def _bc(x, c):
    """``x`` (a plane or a stack of P) viewed to broadcast against the
    constant ``c`` (the same plane shape, or a stack of Pc): plane p of x
    meets constant plane p % Pc."""
    return x.reshape((-1,) + tuple(c.shape))


def bmul(c, x):
    """``c * x`` with the constant stack ``c`` broadcast over the planes
    of ``x`` (:func:`_bc`), in the shape of ``x``."""
    return (c * _bc(x, c)).reshape(x.shape)


_BF16, _I16 = torch.bfloat16, torch.int16
IO_DTYPES = (_F32, _BF16)
CARRY_DTYPES = (_F32, _BF16, _I16)
_CODE = {_F32: 0, _BF16: 1, _I16: 2}      # storage codes of the C entries
_I16_FULL = 32767.0
V_SCALE_MULT = 256.0
_MODES = {"f32": _F32, "bf16": _BF16, "i16": _I16}


def storage_dtype(mode: str, allowed=("f32", "bf16", "i16")) -> torch.dtype:
    """The torch dtype of a storage mode name ("f32", "bf16", "i16")."""
    if mode not in allowed:
        raise ValueError(f"storage mode {mode!r} is not one of {allowed}")
    return _MODES[mode]


def _tv_scales(mu2, mu3, tau):
    """Fixed-point full scales of the int16 TV carries (a0/a1, b), from
    the KKT bounds for max-normalized measurements."""
    return 8.0 * tau, 32.0 * mu3


def _v_scale(mu1):
    """Fixed-point full scale of the int16 v carry."""
    return V_SCALE_MULT * mu1


def _load_carry(x, scale):
    """A carry plane widened to f32 (int16: fixed point at ``scale``)."""
    if x.dtype == _I16:
        return x.to(_F32) * (scale / _I16_FULL)
    return x.to(_F32)


def _store_carry(x, dtype, scale):
    """An f32 carry plane in its storage dtype (int16: clamped to
    +-32767 and rounded half to even, as ``jnp.round``)."""
    if dtype == _I16:
        s = _I16_FULL / scale
        return torch.round(torch.clamp(x * s, -_I16_FULL, _I16_FULL)).to(_I16)
    return x.to(dtype)


def _fix(scale):
    """(scale / 32767, 32767 / scale): the int16 load and store factors,
    computed in float64 and passed to the kernels as f32."""
    return scale / _I16_FULL, _I16_FULL / scale


def encode_v(x, mu1, dtype=_F32):
    """The f32 v plane in the v carry's storage dtype."""
    return _store_carry(x, dtype, _v_scale(mu1))


# ---------------------------------------------------------------------------
# constants, checks and launching
# ---------------------------------------------------------------------------


def factors(n: int):
    """(n1, n2) of a length-n axis, the split designs' and the plain
    versions' alike.  The CUDA kernels take every factorization: where a
    factor is not a multiple of 4, n1 is 1, a row length is not a
    multiple of a 16-byte vector or a lane width not a multiple of an
    H-axis kernel's tile, the C entry launches its kernel's general form
    (``general_form`` in ``csrc/lpt_dft.cuh``: the tail form of the DFT
    passes, one element a trip, the last lane tile guarded)."""
    return _factor(n)


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


def _check(name, tensors, shape=None, dtypes=(_F32,)):
    """Dtype and shape of a group of tensors, and that they share a
    device; raises TypeError / ValueError."""
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: expected one of {dtypes}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")


def _depth(name, t, plane):
    """Planes in ``t``: 1 for a tensor shaped ``plane``, P for (P,) +
    ``plane``; raises ValueError otherwise."""
    s, plane = tuple(t.shape), tuple(plane)
    if s == plane:
        return 1
    if len(s) == len(plane) + 1 and s[1:] == plane and s[0] > 0:
        return s[0]
    raise ValueError(f"{name}: expected shape {plane} or (P,) + {plane}, got {s}")


def _const_depth(name, consts, plane, p):
    """Planes Pc of a group of constant stacks (all the same), which must
    divide the P planes they are broadcast over."""
    pc = _depth(name, consts[0], plane)
    _check(name, consts, consts[0].shape, (consts[0].dtype,))
    if p % pc:
        raise ValueError(f"{name}: {p} planes do not repeat {pc} constant planes "
                         "(P % Pc must be 0)")
    return pc


def _on_card(name, tensors, combo, built, cols=()):
    """False for CPU tensors (the plain version runs).  True for CUDA
    tensors the kernel takes: ``combo``, the dtypes the kernel is
    dispatched on, among those it was ``built`` for (else TypeError),
    contiguous and, except the per-row ``cols``, 16-byte aligned (else
    ValueError)."""
    dev = tensors[0].device
    if any(t.device != dev for t in (*tensors, *cols)):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type == "cpu":
        return False
    if combo not in built:
        raise TypeError(f"{name}: no CUDA kernel for dtypes {combo}; built for "
                        f"{sorted(built, key=str)}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if (any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors)
            or any(not t.is_contiguous() for t in cols)):
        raise ValueError(f"{name}: CUDA tensors must be contiguous and 16-byte aligned")
    return True


_ARG = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
        "L": ctypes.c_longlong}


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


def _rows(name, x):
    """(rows, width) of (..., rows, width) rows, at least 2-D."""
    if x.dim() < 2:
        raise ValueError(f"{name}: expected (..., rows, width), got {tuple(x.shape)}")
    return x.numel() // x.shape[-1], x.shape[-1]


def _empty(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def _sat_zero(like):
    """A zeroed f32 scalar on the card, for a kernel's atomicMax."""
    return torch.zeros((), dtype=_F32, device=like.device)




# ---------------------------------------------------------------------------
# K1 / K2: packed-real forward and inverse W transforms
# ---------------------------------------------------------------------------

_IO_BUILT = {(_F32,), (_BF16,)}

# K1's radix design (csrc/lpt_fft.cuh): every pass but the last has radix
# RADIX, the last the rest; one block of M / RADIX threads per row, each
# thread RADIX points.
RADIX = 16
RADIX_LENGTHS = tuple(2 ** e for e in range(6, 13))     # M = 64 .. 4096


def rfft_w_design(m: int) -> str:
    """K1's design for half width M, by shape alone: "radix" (the
    register-resident radix FFT of ``csrc/lpt_fft.cuh``) for M in
    ``RADIX_LENGTHS``, "split" (the two-stage DFT of ``csrc/lpt_dft.cuh``,
    any factorization) for any other M.
    ``lpt_rfft_w`` makes the same choice; neither design falls back on
    the other."""
    return "radix" if m in RADIX_LENGTHS else "split"


def radix_plan(m: int):
    """Radices of the radix design's passes over length M = 2^e:
    ``RADIX`` for every pass but the last, which takes the rest."""
    passes = (m.bit_length() - 1 + 3) // 4
    return (RADIX,) * (passes - 1) + (m // RADIX ** (passes - 1),)


@lru_cache(maxsize=None)
def _radix_twiddles_np(m: int) -> np.ndarray:
    """The radix design's twiddles, complex64 from float64: for each pass
    but the last, with input length L and radix R, the entry (c - 1) *
    (L/R) + u is exp(-2 pi i k / M), k = u c M / L (c = 1..R-1, u <
    L/R), so a warp's loads of one c are consecutive."""
    parts, length = [], m
    for r in radix_plan(m)[:-1]:
        q = length // r
        c, u = np.meshgrid(np.arange(1, r), np.arange(q), indexing="ij")
        k = (u * c * (m // length)).reshape(-1)
        parts.append(np.exp(-2j * np.pi * k / m).astype(np.complex64))
        length = q
    return np.concatenate(parts)


@lru_cache(maxsize=None)
def _unpack_natural_np(m: int) -> np.ndarray:
    """The packed-real unpack factors w^f = exp(-2 pi i f / 2M) at natural
    frequencies f < M, complex64 from float64 (the table's E section,
    which holds them at split positions, in frequency order): the radix
    inverse rows of K2 and K6 read them at their pass-0 frequencies."""
    return np.exp(-2j * np.pi * np.arange(m, dtype=np.int64) / (2 * m)).astype(np.complex64)


@lru_cache(maxsize=None)
def _design_table(n: int, with_unpack: bool, design: str, device: torch.device,
                  radix_n: int | None = None):
    """The table of a kernel with two designs (K1-K3, K6: length M with
    the unpack factors E; K10-K13: length W without them; K5, K15-K18:
    length H without them, the radix FFT over the factor ``radix_n`` =
    n2): the split-order table (:func:`_table_np`), followed in the
    "radix" design by :func:`_radix_twiddles_np` of length ``radix_n``
    (default n) and, with the unpack factors, by
    :func:`_unpack_natural_np`.  The prefix is the split design's whole
    table, so a build of either design reads its constants from the same
    argument."""
    t = _table_np(n, with_unpack)
    if design == "radix":
        t = np.concatenate([t, _radix_twiddles_np(radix_n or n)]
                           + ([_unpack_natural_np(n)] if with_unpack else []))
    return torch.view_as_real(torch.from_numpy(t)).contiguous().to(device)


def rfft_w_plain(x):
    """(..., N) split-layout real rows -> half-spectrum (..., N/2) r/i,
    computed in f32 and stored at the input's dtype."""
    zr, zi = rfft_w_split(x.to(_F32))
    return zr.to(x.dtype), zi.to(x.dtype)


def rfft_w(x):
    """(..., N) split-layout real rows (a plane or a stack of planes) ->
    half-spectrum (..., N/2) r/i pair in split order, Z[N/2] packed into
    Im of lane 0; io dtype (f32 or bf16) in and out.  All rows of all
    planes go to one launch.  The kernel's design follows M = N/2 alone
    (:func:`rfft_w_design`): the radix FFT for a power of two M from 64
    to 4096 (the 12 MP grid's M = 4096 among them), the two-stage split
    DFT for any other M."""
    rows, n_full = _rows("rfft_w", x)
    m = n_full // 2
    _check("rfft_w", [x], dtypes=IO_DTYPES)
    cuda = _on_card("rfft_w", [x], (x.dtype,), _IO_BUILT)
    if not cuda:
        return rfft_w_plain(x)
    n1, n2 = factors(m)
    half = tuple(x.shape[:-1]) + (m,)
    zr, zi = _empty(half, x), _empty(half, x)
    _launch("rfft_w", "lpt_rfft_w", "ppppiiiii", x, zr, zi,
            _design_table(m, True, rfft_w_design(m), x.device), rows, m, n1, n2,
            _CODE[x.dtype])
    rfft_w.launches += 1
    return zr, zi


irfft_w_design = rfft_w_design      # K2's rule (:func:`rfft_w_design`)


def irfft_w_plain(zr, zi, out_dtype=_F32):
    """Inverse of :func:`rfft_w_plain`, computed in f32, stored as
    ``out_dtype``."""
    return irfft_w_split(zr.to(_F32), zi.to(_F32)).to(out_dtype)


def irfft_w(zr, zi, out_dtype=_F32):
    """(rows, N/2) half-spectrum pair (io dtype, packed lane 0) -> (rows,
    N) split-layout real rows as ``out_dtype`` (f32 or bf16): the exact
    inverse of :func:`rfft_w`.  The kernel's design follows M = N/2 alone
    (:func:`irfft_w_design`, K1's rule): the radix inverse row of
    ``csrc/lpt_fft.cuh`` for M in ``RADIX_LENGTHS``, the two-stage split
    DFT for any other M."""
    rows, m = zr.shape
    _check("irfft_w", [zr, zi], (rows, m), IO_DTYPES)
    if out_dtype not in IO_DTYPES:
        raise TypeError(f"irfft_w: out_dtype {out_dtype} is not one of {IO_DTYPES}")
    cuda = _on_card("irfft_w", [zr, zi], (zr.dtype, zi.dtype, out_dtype),
                    {(a, a, o) for a in IO_DTYPES for o in IO_DTYPES})
    if not cuda:
        return irfft_w_plain(zr, zi, out_dtype)
    n1, n2 = factors(m)
    out = _empty((rows, 2 * m), zr, out_dtype)
    _launch("irfft_w", "lpt_irfft_w", "ppppiiiiii", zr, zi, out,
            _design_table(m, True, irfft_w_design(m), zr.device), rows, m, n1, n2,
            _CODE[zr.dtype], _CODE[out_dtype])
    irfft_w.launches += 1
    return out


# ---------------------------------------------------------------------------
# K3: TV / non-negativity update + forward W transform of rk
# ---------------------------------------------------------------------------


def _tv_step(image, a0, a1, b, mu2, mu3, tau, natural=False):
    """The TV / non-negativity step of K3 and K8 (split lane layout) and
    of K10 (``natural`` lane order) in f32: (rk, a0', a1', b'), periodic
    within each plane."""
    roll_p1, roll_m1 = _w_rolls(natural, image.shape[-1] // 2)
    thr = tau / mu2
    sc_a, sc_b = _tv_scales(mu2, mu3, tau)
    img = image.to(_F32)
    # H axis (periodic): a0 row r pairs with psi0 = img[r-1] - img[r];
    # the adjoint needs the new a0 of row r+1 as well
    psi0 = torch.roll(img, 1, dims=-2) - img
    eta0 = mu2 * psi0 - _load_carry(a0, sc_a)
    a0n = mu2 * _soft(psi0 + eta0 / mu2, thr) - eta0
    adj0 = torch.roll(a0n, -1, dims=-2) - a0n
    psi1 = roll_p1(img) - img
    eta1 = mu2 * psi1 - _load_carry(a1, sc_a)
    a1n = mu2 * _soft(psi1 + eta1 / mu2, thr) - eta1
    adj1 = roll_m1(a1n) - a1n
    rho = mu3 * img - _load_carry(b, sc_b)
    W = torch.clamp(rho / mu3 + img, min=0.0)
    bn = mu3 * W - rho
    return bn + adj0 + adj1, a0n, a1n, bn


e1_rtv_design = rfft_w_design      # K3's rule (:func:`rfft_w_design`)


def e1_rtv_plain(image, a0, a1, b, mu2, mu3, tau):
    sc_a, sc_b = _tv_scales(mu2, mu3, tau)
    rk, a0n, a1n, bn = _tv_step(image, a0, a1, b, mu2, mu3, tau)
    rkr, rki = rfft_w_split(rk)
    sat = 0.0
    if a0.dtype == _I16:
        # pre-quantization headroom of the carries just computed
        sat = torch.maximum(
            torch.maximum(a0n.abs().amax(), a1n.abs().amax()) * (1.0 / sc_a),
            bn.abs().amax() * (1.0 / sc_b))
    return (rkr.to(image.dtype), rki.to(image.dtype),
            _store_carry(a0n, a0.dtype, sc_a), _store_carry(a1n, a1.dtype, sc_a),
            _store_carry(bn, b.dtype, sc_b), sat)


def e1_rtv(image, a0, a1, b, mu2, mu3, tau):
    """v3 pre-transform step on a plane or a stack of planes (ph, pw) /
    (P, ph, pw).  Returns (rk_wr, rk_wi, a0', a1', b', sat): the rk half
    spectrum at ``image``'s dtype, the new TV/non-negativity carries at
    the dtypes of a0, a1 and b, and the carry-saturation value.  With
    int16 carries sat is a 0-d f32 tensor, max(max |a0'|, |a1'|) /
    (8 tau), max |b'| / (32 mu3)) over the f32 values of all planes before
    they are quantized; >= 1 means a carry clipped.  Otherwise it is 0.0
    and nothing is launched for it.  The kernel's design follows M = pw /
    2 alone (:func:`e1_rtv_design`, K1's rule): the TV step at the radix
    FFT's pass-0 positions for M in ``RADIX_LENGTHS``, the shared-row TV
    step and the two-stage split DFT for any other M."""
    ph, n_full = image.shape[-2:]
    _depth("e1_rtv", image, (ph, n_full))
    m, rows = n_full // 2, image.numel() // n_full
    _check("e1_rtv", [image], dtypes=IO_DTYPES)
    _check("e1_rtv", [a0, a1, b], image.shape, CARRY_DTYPES)
    planes = [image, a0, a1, b]
    cuda = _on_card("e1_rtv", planes, tuple(t.dtype for t in planes),
                    {(i, c, c, c) for i in IO_DTYPES for c in CARRY_DTYPES})
    if not cuda:
        return e1_rtv_plain(image, a0, a1, b, mu2, mu3, tau)
    n1, n2 = factors(m)
    sc_a, sc_b = _tv_scales(mu2, mu3, tau)
    half = tuple(image.shape[:-1]) + (m,)
    rkr, rki = _empty(half, image), _empty(half, image)
    a0o, a1o, bo = (_empty(image.shape, a0) for _ in range(3))
    i16 = a0.dtype == _I16
    sat = _sat_zero(image) if i16 else None
    _launch("e1_rtv", "lpt_e1_rtv", "pppppppppp" + "iiiii" + "fff" + "ffff"
            + "ff" + "p" + "ii",
            image, a0, a1, b, rkr, rki, a0o, a1o, bo,
            _design_table(m, True, e1_rtv_design(m), image.device), rows, ph, m, n1, n2,
            float(mu2), float(mu3), float(tau), *_fix(sc_a), *_fix(sc_b),
            1.0 / sc_a, 1.0 / sc_b, sat.data_ptr() if i16 else None,
            _CODE[image.dtype], _CODE[a0.dtype])
    e1_rtv.launches += 1
    return rkr, rki, a0o, a1o, bo, (sat if i16 else 0.0)


# ---------------------------------------------------------------------------
# K4 / K14: H-axis stage 1 on two complex planes / on one
# ---------------------------------------------------------------------------


def _h_view(name, t, n):
    """(n1, n2, w) of an H-axis view (n1, n2, W) / (P, n1, n2, W) of a
    length-n axis; raises ValueError where the planes do not view it so."""
    n1, n2, w = t.shape[-3:]
    if (n1, n2) != factors(n):
        raise ValueError(f"{name}: planes {tuple(t.shape)} do not view a length-{n} "
                         f"axis as {_factor(n)}")
    return n1, n2, w


# K4's and K14's radix design (csrc/h_pass_a.cu on fft::mul_w48 and
# fft::radix3 of csrc/lpt_fft.cuh): each lane's length-n1 column is one
# length-48 DFT (3 x 16) run by three threads, a block RTW lanes of one j2.
# ``factors`` gives n1 = 48 to the 12 MP grid's H = 6144 = 48 x 128; other
# n1 run the split design.  The C entries' RN1 (csrc/h_pass_a.cu) is this
# length.
H_RADIX_N1 = 48


def h_pass_a_design(n1: int) -> str:
    """K4's and K14's design for the stage-1 length n1, by shape alone:
    "radix" (three threads a column, the length-48 DFT as 3 x 16 with
    constant roots, ``csrc/lpt_fft.cuh``) for n1 = ``H_RADIX_N1``, any n2
    and lane width W; "split" (the two-stage DFT of ``csrc/lpt_dft.cuh``,
    any factorization) for any other n1.  ``lpt_h_pass_a_pair`` and
    ``lpt_h_pass_a`` make the same choice; neither design falls back on
    the other.  Both read the split table (:func:`_table`): the radix
    design its twiddles T and T_inv, its roots being constants."""
    return "radix" if n1 == H_RADIX_N1 else "split"


def h_passA_plain(xr, xi, n, inverse):
    F1, _, T, scale = _plan_t(n, inverse, xr.device)
    *lead, n1, n2, w = xr.shape
    x = torch.complex(xr.to(_F32), xi.to(_F32))
    tw = T[:, :, None]
    if inverse:
        z = torch.matmul(F1, (x * tw).reshape(*lead, n1, n2 * w)).reshape(x.shape) * scale
    else:
        z = torch.matmul(F1, x.reshape(*lead, n1, n2 * w)).reshape(x.shape) * tw
    return z.real.contiguous().to(xr.dtype), z.imag.contiguous().to(xr.dtype)


def h_passA_pair_plain(x1r, x1i, x2r, x2i, n, inverse):
    return h_passA_plain(x1r, x1i, n, inverse), h_passA_plain(x2r, x2i, n, inverse)


def h_passA_pair(x1r, x1i, x2r, x2i, n, inverse):
    """H-axis stage 1 on two complex planes (or stacks of planes) viewed
    (n1, n2, W) / (P, n1, n2, W).  Forward: contract j1 with F1, then
    twiddle.  Inverse: twiddle, contract with the inverse F1, scale 1/n.
    io dtype in and out.  The kernel's design follows n1 alone
    (:func:`h_pass_a_design`): the radix design for n1 = 48, the split
    design for any other n1.  Returns ((z1r, z1i), (z2r, z2i))."""
    planes = [x1r, x1i, x2r, x2i]
    p = _depth("h_passA_pair", x1r, x1r.shape[-3:])
    _check("h_passA_pair", planes, x1r.shape, IO_DTYPES)
    cuda = _on_card("h_passA_pair", planes, tuple(t.dtype for t in planes),
                    {(d,) * 4 for d in IO_DTYPES})
    n1, n2, w = _h_view("h_passA_pair", x1r, n)
    if not cuda:
        return h_passA_pair_plain(x1r, x1i, x2r, x2i, n, inverse)
    outs = [_empty(x1r.shape, x1r) for _ in range(4)]
    _launch("h_pass_a", "lpt_h_pass_a_pair", "ppppppppp" + "iiiiii",
            *planes, *outs, _table(n, False, x1r.device), p, n1, n2, w,
            int(bool(inverse)), _CODE[x1r.dtype])
    h_passA_pair.launches += 1
    return (outs[0], outs[1]), (outs[2], outs[3])


def h_passA(xr, xi, n, inverse):
    """H-axis stage 1 on one complex plane (or stack of planes) viewed
    (n1, n2, W) / (P, n1, n2, W), as :func:`h_passA_pair` does on two:
    forward, contract j1 with F1 and twiddle; inverse, twiddle, contract
    with the inverse F1 and scale 1/n.  io dtype in and out.  The
    kernel's design follows n1 alone, as K4's (:func:`h_pass_a_design`).
    Returns (zr, zi)."""
    p = _depth("h_passA", xr, xr.shape[-3:])
    _check("h_passA", [xr, xi], xr.shape, IO_DTYPES)
    cuda = _on_card("h_passA", [xr, xi], (xr.dtype, xi.dtype), {(d, d) for d in IO_DTYPES})
    n1, n2, w = _h_view("h_passA", xr, n)
    if not cuda:
        return h_passA_plain(xr, xi, n, inverse)
    zr, zi = _empty(xr.shape, xr), _empty(xr.shape, xr)
    _launch("h_pass_a", "lpt_h_pass_a", "ppppp" + "iiiiii", xr, xi, zr, zi,
            _table(n, False, xr.device), p, n1, n2, w, int(bool(inverse)), _CODE[xr.dtype])
    h_passA.launches += 1
    return zr, zi


# ---------------------------------------------------------------------------
# K15-K18: H-axis stage 2 of the pass-level backend
# ---------------------------------------------------------------------------


def _c32(r, i):
    return torch.complex(r.to(_F32), i.to(_F32))


def _stage2(x, n, inverse):
    """z[..., k1, q, w] = sum_p F2[q, p] x[..., k1, p, w] (F2 symmetric;
    the inverse F2 unscaled), complex f32."""
    _, F2, _, _ = _plan_t(n, inverse, x.device)
    return torch.matmul(F2, x)


def _cmul(yr, yi, mr, mi):
    """(yr + i yi)(mr + i mi) in f32 in the JAX kernels' order, the
    constant stack m broadcast over the planes of y (:func:`_bc`)."""
    yr, yi = _bc(yr.to(_F32), mr), _bc(yi.to(_F32), mr)
    mr, mi = mr.to(_F32), mi.to(_F32)
    return yr * mr - yi * mi, yr * mi + yi * mr


def _out(z, like):
    return (z.real.reshape(like.shape).contiguous().to(like.dtype),
            z.imag.reshape(like.shape).contiguous().to(like.dtype))


def h_passB_plain(yr, yi, n, inverse, filt_r=None, filt_i=None):
    if filt_r is None:
        y = _c32(yr, yi)
    else:
        y = torch.complex(*_cmul(yr, yi, filt_r, filt_i))
    return _out(_stage2(y, n, inverse), yr)


def h_passB(yr, yi, n, inverse, filt_r=None, filt_i=None):
    """H-axis stage 2 on one complex plane (or stack) viewed (n1, n2, W) /
    (P, n1, n2, W): contract over j2 with F2 (forward) or over k2 with the
    inverse F2 (``inverse``, unscaled: the 1/n is stage 1's).  With the
    filter planes ``filt_r``/``filt_i`` (a plane or a stack of Pc, P % Pc
    == 0) the spectrum is multiplied by the filter in f32 before the
    contraction.  io dtype in and out.  The kernel's design follows n2
    alone (:func:`h_pass_b_design`, K5's rule): the radix column form for
    n2 = 128, the split design for any other n2.  Returns (zr, zi)."""
    name = "h_passB"
    _check(name, [yr, yi], yr.shape, IO_DTYPES)
    filt = [] if filt_r is None else [filt_r, filt_i]
    p = _depth(name, yr, yr.shape[-3:])
    pc = _const_depth(name, filt, yr.shape[-3:], p) if filt else 1
    ins = [yr, yi, *filt]
    cuda = _on_card(name, ins, tuple(t.dtype for t in ins),
                    {(d,) * k for d in IO_DTYPES for k in (2, 4)})
    n1, n2, w = _h_view(name, yr, n)
    if not cuda:
        return h_passB_plain(yr, yi, n, inverse, filt_r, filt_i)
    zr, zi = _empty(yr.shape, yr), _empty(yr.shape, yr)
    _launch("h_pass_b", "lpt_h_pass_b", "ppppppp" + "iiiiiii", yr, yi,
            filt_r if filt else None, filt_i if filt else None, zr, zi,
            _design_table(n, False, h_pass_b_design(n2), yr.device, radix_n=n2), p, pc, n1,
            n2, w, int(bool(inverse)), _CODE[yr.dtype])
    h_passB.launches += 1
    return zr, zi


def _combine(ar, ai, b, hr, hi, rr):
    """F = R (a + conj(H) b) in f32 in the JAX kernels' order, a (r/i) and
    the complex b already viewed against the constant stacks (:func:`_bc`).
    Returns (fr, fi)."""
    br, bi = b.real, b.imag
    hr, hi, rr = hr.to(_F32), hi.to(_F32), rr.to(_F32)
    return rr * (ar + hr * br + hi * bi), rr * (ai + hr * bi - hi * br)


def h_passB_combine_plain(yr, yi, ar, ai, hr, hi, rr, n):
    b = _bc(_stage2(_c32(yr, yi), n, False), hr)
    ar, ai = _bc(ar.to(_F32), hr), _bc(ai.to(_F32), hr)
    return _out(torch.complex(*_combine(ar, ai, b, hr, hi, rr)), yr)


def h_passB_combine(yr, yi, ar, ai, hr, hi, rr, n):
    """Forward stage 2 of the stage-1 plane y, b = F2 y, fused with the
    ADMM spectrum combine F = R (a + conj(H) b) in f32; y and the spectrum
    a (n1, n2, W) or stacks (P, n1, n2, W), the filter planes H and R a
    plane or a stack of Pc (P % Pc == 0), all at the io dtype.  The
    kernel's design follows n2 alone, as K15's (:func:`h_pass_b_design`).
    Returns (fr, fi)."""
    name = "h_passB_combine"
    ins = [yr, yi, ar, ai, hr, hi, rr]
    _check(name, ins[:4], yr.shape, IO_DTYPES)
    p = _depth(name, yr, yr.shape[-3:])
    pc = _const_depth(name, ins[4:], yr.shape[-3:], p)
    cuda = _on_card(name, ins, tuple(t.dtype for t in ins), {(d,) * 7 for d in IO_DTYPES})
    n1, n2, w = _h_view(name, yr, n)
    if not cuda:
        return h_passB_combine_plain(*ins, n)
    fr, fi = _empty(yr.shape, yr), _empty(yr.shape, yr)
    _launch("h_pass_b", "lpt_h_pass_b_combine", "pppppppppp" + "iiiiii", *ins, fr, fi,
            _design_table(n, False, h_pass_b_design(n2), yr.device, radix_n=n2), p, pc, n1,
            n2, w, _CODE[yr.dtype])
    h_passB_combine.launches += 1
    return fr, fi


def h_passB_dual_plain(yr, yi, hr, hi, n):
    y = _c32(yr, yi)
    y1 = torch.complex(*_cmul(yr, yi, hr, hi))
    return (*_out(_stage2(y, n, True), yr), *_out(_stage2(y1, n, True), yr))


def h_passB_dual(yr, yi, hr, hi, n):
    """The inverse stage 2 (unscaled) of the split-order spectrum y and of
    H y, from one read of y; y (n1, n2, W) or a stack (P, n1, n2, W), H a
    plane or a stack of Pc (P % Pc == 0), all at the io dtype; H y is
    formed in f32.  The kernel's design follows n2 alone, as K15's
    (:func:`h_pass_b_design`).  Returns (a0r, a0i, a1r, a1i)."""
    name = "h_passB_dual"
    ins = [yr, yi, hr, hi]
    _check(name, ins[:2], yr.shape, IO_DTYPES)
    p = _depth(name, yr, yr.shape[-3:])
    pc = _const_depth(name, ins[2:], yr.shape[-3:], p)
    cuda = _on_card(name, ins, tuple(t.dtype for t in ins), {(d,) * 4 for d in IO_DTYPES})
    n1, n2, w = _h_view(name, yr, n)
    if not cuda:
        return h_passB_dual_plain(*ins, n)
    outs = [_empty(yr.shape, yr) for _ in range(4)]
    _launch("h_pass_b", "lpt_h_pass_b_dual", "ppppppppp" + "iiiiii", *ins, *outs,
            _design_table(n, False, h_pass_b_design(n2), yr.device, radix_n=n2), p, pc, n1,
            n2, w, _CODE[yr.dtype])
    h_passB_dual.launches += 1
    return tuple(outs)


def h_passB_combine2_plain(xr, xi, yr, yi, hr, hi, rr, n):
    a = _bc(_stage2(_c32(xr, xi), n, False), hr)
    b = _bc(_stage2(_c32(yr, yi), n, False), hr)
    return _out(torch.complex(*_combine(a.real, a.imag, b, hr, hi, rr)), xr)


def h_passB_combine2(xr, xi, yr, yi, hr, hi, rr, n):
    """Forward stage 2 of both stage-1 planes, a = F2 x (rk) and b = F2 y
    (v), fused with the ADMM spectrum combine F = R (a + conj(H) b) in
    f32: K16 with its spectrum a computed instead of read, so that it is
    never stored.  x and y (n1, n2, W) or stacks (P, n1, n2, W), the
    filter planes H and R a plane or a stack of Pc (P % Pc == 0), all at
    the io dtype.  The kernel's design follows n2 alone, as K15's
    (:func:`h_pass_b_design`).  Returns (fr, fi)."""
    name = "h_passB_combine2"
    ins = [xr, xi, yr, yi, hr, hi, rr]
    _check(name, ins[:4], xr.shape, IO_DTYPES)
    p = _depth(name, xr, xr.shape[-3:])
    pc = _const_depth(name, ins[4:], xr.shape[-3:], p)
    cuda = _on_card(name, ins, tuple(t.dtype for t in ins), {(d,) * 7 for d in IO_DTYPES})
    n1, n2, w = _h_view(name, xr, n)
    if not cuda:
        return h_passB_combine2_plain(*ins, n)
    fr, fi = _empty(xr.shape, xr), _empty(xr.shape, xr)
    _launch("h_pass_b", "lpt_h_pass_b_combine2", "pppppppppp" + "iiiiii", *ins, fr, fi,
            _design_table(n, False, h_pass_b_design(n2), xr.device, radix_n=n2), p, pc, n1,
            n2, w, _CODE[xr.dtype])
    h_passB_combine2.launches += 1
    return fr, fi


# ---------------------------------------------------------------------------
# K5: H-axis stage 2 of both planes, spectrum combine, inverse stage 2
# ---------------------------------------------------------------------------


# K5's radix design (csrc/lpt_fft.cuh, the column form of the radix FFT):
# each lane's length-n2 column is one transform of n2 / RADIX threads, a
# block TW lanes of one k1.  ``factors`` gives n2 = 128 to every H that is
# a multiple of 128 up to 32768 (the 12 MP grid's 6144 = 48 x 128, 768 =
# 6 x 128); other n2 run the split design.  The C entry's RN2
# (csrc/h_combine.cu) is this length.
H_RADIX_N2 = 128


def h_combine_dual_design(n2: int) -> str:
    """K5's design for the stage-2 length n2, by shape alone: "radix" (the
    column form of the radix FFT, ``csrc/lpt_fft.cuh``) for n2 =
    ``H_RADIX_N2``, any lane width W; "split" (the two-stage DFT of
    ``csrc/lpt_dft.cuh``, any factorization) for any other n2.
    ``lpt_h_combine_dual`` makes the same choice; neither design falls
    back on the other."""
    return "radix" if n2 == H_RADIX_N2 else "split"


# K15's, K16's, K17's and K18's rule (csrc/h_pass_b.cu: K5's column form,
# K15 and K16 on one column array, K17 and K18 on two; K16 and K18 with
# K5's combine on the registers, K15 and K17 without it)
h_pass_b_design = h_combine_dual_design


def h_combine_dual_plain(xar, xai, yar, yai, hr, hi, rr, n):
    a = _bc(_stage2(_c32(xar, xai), n, False), hr)
    b = _bc(_stage2(_c32(yar, yai), n, False), hr)
    fr, fi = _combine(a.real, a.imag, b, hr, hi, rr)
    hr, hi = hr.to(_F32), hi.to(_F32)
    f1r = fr * hr - fi * hi
    f1i = fr * hi + fi * hr
    g0 = _stage2(torch.complex(fr, fi), n, True)
    g1 = _stage2(torch.complex(f1r, f1i), n, True)
    return (*_out(g0, xar), *_out(g1, xar))


def h_combine_dual(xar, xai, yar, yai, hr, hi, rr, n):
    """Forward stage 2 of the rk (x) and v (y) stage-1 planes, F = R(A +
    conj(H) B), F1 = H F, and the inverse stage 2 of F and F1; all planes
    (n1, n2, W) or stacks (P, n1, n2, W) at the io dtype, the filter
    planes H and R included (a plane or a stack of Pc, P % Pc == 0: plane
    p is filtered by filter plane p % Pc).  The kernel's design follows n2
    alone (:func:`h_combine_dual_design`): the radix column form for n2 =
    128, the split design for any other n2.  Returns (a0r, a0i, a1r,
    a1i)."""
    ins = [xar, xai, yar, yai, hr, hi, rr]
    p = _depth("h_combine_dual", xar, xar.shape[-3:])
    _check("h_combine_dual", ins[:4], xar.shape, IO_DTYPES)
    pc = _const_depth("h_combine_dual", ins[4:], xar.shape[-3:], p)
    cuda = _on_card("h_combine_dual", ins, tuple(t.dtype for t in ins),
                    {(d,) * 7 for d in IO_DTYPES})
    n1, n2, w = _h_view("h_combine_dual", xar, n)
    if not cuda:
        return h_combine_dual_plain(*ins, n)
    outs = [_empty(xar.shape, xar) for _ in range(4)]
    _launch("h_combine", "lpt_h_combine_dual", "pppppppppppp" + "iiiiii",
            *ins, *outs,
            _design_table(n, False, h_combine_dual_design(n2), xar.device, radix_n=n2),
            p, pc, n1, n2, w, _CODE[xar.dtype])
    h_combine_dual.launches += 1
    return tuple(outs)


def fft_h_combine_dual(rkr, rki, vr, vi, hr, hi, rr, h, ops=None):
    """Forward H transforms of both ADMM planes, spectrum combine and the
    inverse H transforms of F and H.F: K4 forward, K5, K4 inverse.  All
    planes (h, W) or stacks (P, h, W) in split order, the filter planes
    (h, W) or (Pc, h, W); returns ((a0r, a0i), (a1r, a1i))."""
    ops = ops or KERNELS
    n1, n2 = _factor(h)
    w = rkr.shape[-1]

    def v(t):
        return t.reshape(tuple(t.shape[:-2]) + (n1, n2, w))

    (xar, xai), (yar, yai) = ops.h_passA_pair(v(rkr), v(rki), v(vr), v(vi),
                                              h, False)
    a0r, a0i, a1r, a1i = ops.h_combine_dual(xar, xai, yar, yai,
                                            v(hr), v(hi), v(rr), h)
    (z0r, z0i), (z1r, z1i) = ops.h_passA_pair(a0r, a0i, a1r, a1i, h, True)
    return ((z0r.reshape(rkr.shape), z0i.reshape(rkr.shape)),
            (z1r.reshape(rkr.shape), z1i.reshape(rkr.shape)))


# ---------------------------------------------------------------------------
# K6: dual inverse W transform + X/v update + forward W transform of v'
# ---------------------------------------------------------------------------


def _patch(z, col):
    """Lane 0 of a half spectrum replaced by the f32 column ``col``."""
    return torch.cat([col[..., None], z[..., 1:].to(_F32)], dim=-1)


def _xv_step(fwd, v, mask, dp, mu1):
    """The X / v update of K6 and K8 in f32 (v' from the f32 forward
    plane, the stored v carry and the mask and data planes)."""
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
    xi = mu1 * fwd - _load_carry(v, _v_scale(mu1))
    xdv = c_out + (c_in - c_out) * mask.to(_F32)
    X = bmul(xdv, xi + mu1 * fwd + dp.to(_F32))
    return mu1 * X - xi


irfft_w_dual_state_design = rfft_w_design     # K6's rule (:func:`rfft_w_design`)


def irfft_w_dual_state_plain(a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i,
                             v, mask, dp, mu1, with_sat=True):
    vsc = _v_scale(mu1)
    image = irfft_w_split(_patch(a0r, p0r), _patch(a0i, p0i))
    fwd = irfft_w_split(_patch(a1r, p1r), _patch(a1i, p1i))
    vn = _xv_step(fwd, v, mask, dp, mu1)
    vwr, vwi = rfft_w_split(vn)
    sat = 0.0
    if with_sat and v.dtype == _I16:
        sat = vn.abs().amax() * (1.0 / vsc)
    io = a0r.dtype
    return (image.to(io), _store_carry(vn, v.dtype, vsc), vwr.to(io),
            vwi.to(io), sat)


def _dual_inputs(name, spectra, cols):
    """(P, ph, m) of the four half spectra and the four (rows,) patch
    columns of K6 / K9."""
    ph, m = spectra[0].shape[-2:]
    p = _depth(name, spectra[0], (ph, m))
    _check(name, spectra, spectra[0].shape, IO_DTYPES)
    _check(name, cols, tuple(spectra[0].shape[:-1]))
    return p, ph, m


def irfft_w_dual_state(a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i, v, mask, dp,
                       mu1, with_sat=True):
    """v3 post-transform step: lane 0 of the a0/a1 half spectra replaced by
    the f32 DC/Nyquist patch columns p0*/p1* (one value per row), both
    inverse W transforms (image, fwd), xi = mu1 fwd - v, X = xdv (xi +
    mu1 fwd + dp), v' = mu1 X - xi, and the forward W transform of v'.
    fwd never reaches device memory.  Planes (ph, pw) or stacks (P, ph,
    pw), the half spectra (.., ph, pw/2), the columns (.., ph); the mask a
    plane or a stack of Pc (plane p reads mask plane p % Pc).  Returns
    (image, v', v'_wr, v'_wi, sat): image and the v' spectrum at a0r's
    dtype, v' at v's.  With ``with_sat`` and an int16 v, sat is a 0-d f32
    tensor, max |v'| / (256 mu1) over the f32 values of all planes before
    they are quantized; otherwise 0.0 (the solver's form,
    ``with_sat=False``, leaves the v scan to :func:`sat_scan_i16`).  The
    kernel's design follows M = pw/2 alone
    (:func:`irfft_w_dual_state_design`, K1's rule): the radix rows of
    ``csrc/lpt_fft.cuh`` for M in ``RADIX_LENGTHS``, the two-stage split
    DFT for any other M."""
    name = "irfft_w_dual_state"
    p, ph, m = _dual_inputs(name, [a0r, a0i, a1r, a1i], [p0r, p0i, p1r, p1i])
    full = tuple(a0r.shape[:-1]) + (2 * m,)
    _check(name, [dp], full, IO_DTYPES)
    _check(name, [v], full, CARRY_DTYPES)
    pc = _const_depth(name, [mask], (ph, 2 * m), p)
    planes = [a0r, a0i, a1r, a1i, mask, dp, v]
    cuda = _on_card(name, planes, tuple(t.dtype for t in planes),
                    {(i,) * 6 + (c,) for i in IO_DTYPES for c in CARRY_DTYPES},
                    cols=(p0r, p0i, p1r, p1i))
    if not cuda:
        return irfft_w_dual_state_plain(a0r, a0i, a1r, a1i, p0r, p0i, p1r,
                                        p1i, v, mask, dp, mu1, with_sat)
    n1, n2 = factors(m)
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
    vsc = _v_scale(mu1)
    image = _empty(full, a0r)
    vo = _empty(full, v)
    vwr, vwi = _empty(a0r.shape, a0r), _empty(a0r.shape, a0r)
    sat = _sat_zero(v) if with_sat and v.dtype == _I16 else None
    _launch("w_dual_state", "lpt_w_dual_state", "ppppppppppp" + "pppp" + "p"
            + "iiiiii" + "fff" + "fff" + "p" + "ii",
            a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i, v, mask, dp,
            image, vo, vwr, vwi,
            _design_table(m, True, irfft_w_dual_state_design(m), v.device), p * ph, ph, pc, m,
            n1, n2, float(mu1), float(c_out), float(c_in - c_out), *_fix(vsc),
            1.0 / vsc, sat.data_ptr() if sat is not None else None,
            _CODE[a0r.dtype], _CODE[v.dtype])
    irfft_w_dual_state.launches += 1
    return image, vo, vwr, vwi, (0.0 if sat is None else sat)


# ---------------------------------------------------------------------------
# K7: saturation fraction of a stored int16 carry plane
# ---------------------------------------------------------------------------


def sat_scan_i16_plain(x):
    return x.to(torch.int32).abs().amax().to(_F32) * (1.0 / _I16_FULL)


def sat_scan_i16(x):
    """max |x| / 32767 over a stored int16 plane (or stack of planes), as
    a 0-d f32 tensor on x's device (the JAX kernel returns an (8, 128)
    block of equal entries that its callers reduce with ``jnp.max``).
    |x| is taken in int32, so a plane holding -32768 reads 32768/32767 >
    1."""
    _check("sat_scan_i16", [x], dtypes=(_I16,))
    if not _on_card("sat_scan_i16", [x], (x.dtype,), {(_I16,)}):
        return sat_scan_i16_plain(x)
    sat = _sat_zero(x)
    _launch("sat_scan", "lpt_sat_scan_i16", "pLfp", x, x.numel(),
            1.0 / _I16_FULL, sat)
    sat_scan_i16.launches += 1
    return sat


def carry_sat_fraction(x, scale, ops=None):
    """Saturation fraction of a stored carry plane (the JAX package's
    XLA-side ``carry_sat_fraction``, the v2 placement's channel): for
    int16, max |x| / 32767, which is K7's function and runs as
    ``ops.sat_scan_i16``; otherwise max |x| / ``scale``."""
    if x.dtype == _I16:
        return (ops or KERNELS).sat_scan_i16(x)
    return x.to(_F32).abs().amax() / scale


# ---------------------------------------------------------------------------
# K8: v2 pre-transform step (TV + X/v from the carried fwd + two W transforms)
# ---------------------------------------------------------------------------


e1_rcarry_design = rfft_w_design     # K8's rule (:func:`rfft_w_design`)
# K8's CUDA library by TV carry dtype: its 18 type combinations in both
# designs are built as three libraries, compiled in parallel, each with the
# entry ``lpt_e1_rcarry`` for its TV carry type (csrc/e1_rcarry.cuh)
_E1_RCARRY_LIB = {_F32: "e1_rcarry", _BF16: "e1_rcarry_tv_bf16", _I16: "e1_rcarry_tv_i16"}


def e1_rcarry_plain(image, fwd, v, b, a0, a1, mask, dp, mu1, mu2, mu3, tau):
    sc_a, sc_b = _tv_scales(mu2, mu3, tau)
    rk, a0n, a1n, bn = _tv_step(image, a0, a1, b, mu2, mu3, tau)
    vn = _xv_step(fwd.to(_F32), v, mask, dp, mu1)
    rkr, rki = rfft_w_split(rk)
    vwr, vwi = rfft_w_split(vn)
    io = image.dtype
    return (rkr.to(io), rki.to(io), vwr.to(io), vwi.to(io),
            _store_carry(vn, v.dtype, _v_scale(mu1)),
            _store_carry(a0n, a0.dtype, sc_a), _store_carry(a1n, a1.dtype, sc_a),
            _store_carry(bn, b.dtype, sc_b))


def e1_rcarry(image, fwd, v, b, a0, a1, mask, dp, mu1, mu2, mu3, tau):
    """v2 pre-transform step: K3's TV / non-negativity step (a0', a1', b'
    and rk), the X / v update v' = mu1 X - xi from the carried forward
    plane ``fwd``, and the forward W transforms of rk and of the f32 v'.
    Planes (ph, pw) or stacks (P, ph, pw); the mask a plane or a stack of
    Pc (plane p reads mask plane p % Pc).  image, fwd, mask, dp and the
    spectra at the io dtype; b, a0, a1 at one TV carry dtype and v at the
    v carry dtype, each f32, bf16 or int16.  Returns (rk_wr, rk_wi, v_wr,
    v_wi, v', a0', a1', b'), the spectra at half width.  No saturation
    output: v2 scans the stored carries (:func:`carry_sat_fraction`).
    The kernel's design follows M = pw / 2 alone (:func:`e1_rcarry_design`,
    K1's rule): the TV step and the X / v update at the radix FFT's pass-0
    positions for M in ``RADIX_LENGTHS``, the shared-row steps and the
    two-stage split DFT for any other M."""
    name = "e1_rcarry"
    ph, n_full = image.shape[-2:]
    p = _depth(name, image, (ph, n_full))
    m, rows = n_full // 2, image.numel() // n_full
    _check(name, [image, fwd, dp], image.shape, IO_DTYPES)
    _check(name, [v, b, a0, a1], image.shape, CARRY_DTYPES)
    pc = _const_depth(name, [mask], (ph, n_full), p)
    planes = [image, fwd, v, b, a0, a1, mask, dp]
    cuda = _on_card(name, planes, tuple(t.dtype for t in planes),
                    {(i, i, cv, c, c, c, i, i) for i in IO_DTYPES
                     for c in CARRY_DTYPES for cv in CARRY_DTYPES})
    if not cuda:
        return e1_rcarry_plain(image, fwd, v, b, a0, a1, mask, dp, mu1, mu2, mu3, tau)
    n1, n2 = factors(m)
    sc_a, sc_b = _tv_scales(mu2, mu3, tau)
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
    half = tuple(image.shape[:-1]) + (m,)
    spectra = [_empty(half, image) for _ in range(4)]
    vo = _empty(image.shape, v)
    a0o, a1o, bo = (_empty(image.shape, a0) for _ in range(3))
    _launch(_E1_RCARRY_LIB[a0.dtype], "lpt_e1_rcarry",
            "p" * 17 + "iiiiii" + "ffff" + "ff" + "ffffff" + "iii",
            image, fwd, v, b, a0, a1, mask, dp, *spectra, vo, a0o, a1o, bo,
            _design_table(m, True, e1_rcarry_design(m), image.device), rows, ph, pc, m, n1, n2,
            float(mu1), float(mu2), float(mu3), float(tau), float(c_out),
            float(c_in - c_out), *_fix(sc_a), *_fix(sc_b), *_fix(_v_scale(mu1)),
            _CODE[image.dtype], _CODE[a0.dtype], _CODE[v.dtype])
    e1_rcarry.launches += 1
    return (*spectra, vo, a0o, a1o, bo)


# ---------------------------------------------------------------------------
# K9: v2 post-transform step (DC patch + dual inverse W transform)
# ---------------------------------------------------------------------------


irfft_w_dual_design = rfft_w_design     # K9's rule (:func:`rfft_w_design`)


def irfft_w_dual_plain(a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i):
    io = a0r.dtype
    image = irfft_w_split(_patch(a0r, p0r), _patch(a0i, p0i))
    fwd = irfft_w_split(_patch(a1r, p1r), _patch(a1i, p1i))
    return image.to(io), fwd.to(io)


def irfft_w_dual(a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i):
    """v2 post-transform step: lane 0 of the a0/a1 half spectra replaced by
    the f32 DC/Nyquist patch columns p0*/p1* (one value per row; the JAX
    kernel's (m, 128) column operands use only column 0), then both
    inverse W transforms.  Half spectra (ph, pw/2) or stacks (P, ph,
    pw/2), columns (.., ph).  Returns (image, fwd) at a0r's dtype.  The
    kernel's design follows M = pw/2 alone (:func:`irfft_w_dual_design`,
    K1's rule): the radix inverse rows of ``csrc/lpt_fft.cuh`` for M in
    ``RADIX_LENGTHS``, the two-stage split DFT for any other M."""
    name = "irfft_w_dual"
    p, ph, m = _dual_inputs(name, [a0r, a0i, a1r, a1i], [p0r, p0i, p1r, p1i])
    cuda = _on_card(name, [a0r, a0i, a1r, a1i], (a0r.dtype,) * 4,
                    {(d,) * 4 for d in IO_DTYPES}, cols=(p0r, p0i, p1r, p1i))
    if not cuda:
        return irfft_w_dual_plain(a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i)
    n1, n2 = factors(m)
    full = tuple(a0r.shape[:-1]) + (2 * m,)
    image, fwd = _empty(full, a0r), _empty(full, a0r)
    _launch("irfft_w_dual", "lpt_irfft_w_dual", "ppppppppppp" + "iiiii",
            a0r, a0i, a1r, a1i, p0r, p0i, p1r, p1i, image, fwd,
            _design_table(m, True, irfft_w_dual_design(m), a0r.device), p * ph, m, n1, n2,
            _CODE[a0r.dtype])
    irfft_w_dual.launches += 1
    return image, fwd


# ---------------------------------------------------------------------------
# K12 / K13: full-width forward and inverse W transforms (split order)
# ---------------------------------------------------------------------------


# The full-width radix designs (csrc/lpt_fft.cuh): K11's ``ifft_two_rows``,
# the inverse by conjugation through the forward radix passes of length W,
# one block of W / RADIX threads per row (K13: per pair of rows, on the
# same function), and K12's ``fft_two_real_rows``, the forward passes on
# two real rows; W = n1 * 128 with n1 >= 4.
IFFT_RADIX_WIDTHS = tuple(2 ** e for e in range(9, 14))     # W = 512 .. 8192


def fft_w_design(w: int) -> str:
    """The design of K12, and of K11 and K13, for width W, by shape alone:
    "radix" (the register-resident radix FFT of ``csrc/lpt_fft.cuh``) for
    W in ``IFFT_RADIX_WIDTHS``, "split" (the two-stage DFT of
    ``csrc/lpt_dft.cuh``, any factorization)
    for any other W.  ``lpt_fft_w``, ``lpt_ifft_w_dual`` and ``lpt_ifft_w``
    make the same choice; neither design falls back on the other."""
    return "radix" if w in IFFT_RADIX_WIDTHS else "split"


ifft_w_design = fft_w_design      # K13's rule


def fft_w_plain(x):
    """(..., W) real rows -> split-order spectrum r/i, computed in f32 and
    stored at the input's dtype."""
    zr, zi = fft_w_split(x.to(_F32))
    return zr.to(x.dtype), zi.to(x.dtype)


def fft_w(x):
    """(..., W) real rows in natural order (a plane or a stack of planes)
    -> the split-order W spectrum (..., W) as r/i planes; io dtype (f32 or
    bf16) in and out.  All rows of all planes go to one launch.  The
    kernel's design follows W alone (:func:`fft_w_design`): the radix FFT
    for a power of two W from 512 to 8192 (the 12 MP grid's 8192 among
    them), the two-stage split DFT for any other W."""
    rows, w = _rows("fft_w", x)
    _check("fft_w", [x], dtypes=IO_DTYPES)
    cuda = _on_card("fft_w", [x], (x.dtype,), _IO_BUILT)
    if not cuda:
        return fft_w_plain(x)
    n1, n2 = factors(w)
    zr, zi = _empty(x.shape, x), _empty(x.shape, x)
    _launch("fft_w", "lpt_fft_w", "ppppiiii", x, zr, zi,
            _design_table(w, False, fft_w_design(w), x.device), rows, n1, n2, _CODE[x.dtype])
    fft_w.launches += 1
    return zr, zi


def ifft_w_plain(vr, vi, out_dtype=_F32):
    """Real part of the inverse of a split-order spectrum, computed in f32,
    stored as ``out_dtype``."""
    return ifft_w_split(vr.to(_F32), vi.to(_F32)).to(out_dtype)


def ifft_w(vr, vi, out_dtype=_F32):
    """(..., W) split-order spectrum r/i (io dtype) -> (..., W) real part
    of its inverse W transform, natural order, as ``out_dtype`` (f32 or
    bf16).  No spectrum is assumed Hermitian.  The kernel's design follows
    W alone (:func:`ifft_w_design`), as :func:`fft_w`'s."""
    rows, w = _rows("ifft_w", vr)
    _check("ifft_w", [vr, vi], vr.shape, IO_DTYPES)
    if out_dtype not in IO_DTYPES:
        raise TypeError(f"ifft_w: out_dtype {out_dtype} is not one of {IO_DTYPES}")
    cuda = _on_card("ifft_w", [vr, vi], (vr.dtype, vi.dtype, out_dtype),
                    {(a, a, o) for a in IO_DTYPES for o in IO_DTYPES})
    if not cuda:
        return ifft_w_plain(vr, vi, out_dtype)
    n1, n2 = factors(w)
    out = _empty(vr.shape, vr, out_dtype)
    _launch("ifft_w", "lpt_ifft_w", "pppp" + "iiiii", vr, vi, out,
            _design_table(w, False, ifft_w_design(w), vr.device), rows, n1, n2,
            _CODE[vr.dtype], _CODE[out_dtype])
    ifft_w.launches += 1
    return out


# ---------------------------------------------------------------------------
# K10: full-width pre-transform step (TV + X/v + the forward W transforms)
# ---------------------------------------------------------------------------

FULL_TV_DTYPES = IO_DTYPES     # K10's TV carries: never int16 (module docstring)
e1_carry_design = fft_w_design     # K10's rule (:func:`fft_w_design`)


def e1_carry_plain(image, fwd, v, b, a0, a1, mask, dp, mu1, mu2, mu3, tau):
    rk, a0n, a1n, bn = _tv_step(image, a0, a1, b, mu2, mu3, tau, natural=True)
    vn = _xv_step(fwd.to(_F32), v, mask, dp, mu1)
    rkr, rki = fft_w_split(rk)
    vwr, vwi = fft_w_split(vn)
    io = image.dtype
    return (rkr.to(io), rki.to(io), vwr.to(io), vwi.to(io),
            _store_carry(vn, v.dtype, _v_scale(mu1)),
            a0n.to(a0.dtype), a1n.to(a1.dtype), bn.to(b.dtype))


def e1_carry(image, fwd, v, b, a0, a1, mask, dp, mu1, mu2, mu3, tau):
    """Full-width pre-transform step, planes in natural lane order: the TV
    / non-negativity step (a0', a1', b' and rk, the W difference a roll
    within the row), the X / v update v' = mu1 X - xi from the carried
    forward plane ``fwd`` and the {0,1} support ``mask``, and the forward
    W transforms of rk and of the f32 v', split order.  Planes (ph, pw) or
    stacks (P, ph, pw); the mask a plane or a stack of Pc (plane p reads
    mask plane p % Pc).  image, fwd, mask, dp and the spectra at the io
    dtype; b, a0, a1 at one TV carry dtype, f32 or bf16 (the JAX kernel
    has no int16 TV carries here); v at the v carry dtype, f32, bf16 or
    int16 at full scale 256 mu1.  Returns (rk_wr, rk_wi, v_wr, v_wi, v',
    a0', a1', b').  The kernel's design follows W alone
    (:func:`e1_carry_design`, K12's rule): the TV step and the X / v
    update at the radix FFT's pass-0 positions for W in
    ``IFFT_RADIX_WIDTHS``, the shared row and the two-stage split DFT for
    any other W."""
    name = "e1_carry"
    ph, w = image.shape[-2:]
    p = _depth(name, image, (ph, w))
    rows = image.numel() // w
    _check(name, [image, fwd, dp], image.shape, IO_DTYPES)
    _check(name, [b, a0, a1], image.shape, FULL_TV_DTYPES)
    _check(name, [b, a0, a1], image.shape, (b.dtype,))
    _check(name, [v], image.shape, CARRY_DTYPES)
    pc = _const_depth(name, [mask], (ph, w), p)
    planes = [image, fwd, v, b, a0, a1, mask, dp]
    cuda = _on_card(name, planes, tuple(t.dtype for t in planes),
                    {(i, i, cv, c, c, c, i, i) for i in IO_DTYPES
                     for c in FULL_TV_DTYPES for cv in CARRY_DTYPES})
    if not cuda:
        return e1_carry_plain(image, fwd, v, b, a0, a1, mask, dp, mu1, mu2, mu3, tau)
    n1, n2 = factors(w)
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
    spectra = [_empty(image.shape, image) for _ in range(4)]
    vo = _empty(image.shape, v)
    a0o, a1o, bo = (_empty(image.shape, a0) for _ in range(3))
    _launch("e1_carry", "lpt_e1_carry", "p" * 17 + "iiiii" + "ffffff" + "ff" + "iii",
            image, fwd, v, b, a0, a1, mask, dp, *spectra, vo, a0o, a1o, bo,
            _design_table(w, False, e1_carry_design(w), image.device), rows, ph, pc, n1, n2,
            float(mu1), float(mu2), float(mu3), float(tau), float(c_out),
            float(c_in - c_out), *_fix(_v_scale(mu1)),
            _CODE[image.dtype], _CODE[a0.dtype], _CODE[v.dtype])
    e1_carry.launches += 1
    return (*spectra, vo, a0o, a1o, bo)


# ---------------------------------------------------------------------------
# K11: full-width post-transform step (dual inverse W transform)
# ---------------------------------------------------------------------------


ifft_w_dual_design = fft_w_design     # K11's rule (:func:`fft_w_design`)


def ifft_w_dual_plain(a0r, a0i, a1r, a1i):
    io = a0r.dtype
    return ifft_w_plain(a0r, a0i, io), ifft_w_plain(a1r, a1i, io)


def ifft_w_dual(a0r, a0i, a1r, a1i):
    """Full-width post-transform step: (image, fwd) = the real parts of
    the inverse W transforms of the split-order spectra a0 and a1, natural
    order, at a0r's dtype.  Planes (ph, pw) or stacks (P, ph, pw).  No
    spectrum is assumed Hermitian.  The kernel's design follows W alone
    (:func:`ifft_w_dual_design`): the radix FFT for a power of two W from
    512 to 8192 (the 12 MP grid's 8192 among them), the two-stage split
    DFT for any other W."""
    name = "ifft_w_dual"
    ins = [a0r, a0i, a1r, a1i]
    rows, w = _rows(name, a0r)
    _check(name, ins, a0r.shape, IO_DTYPES)
    cuda = _on_card(name, ins, tuple(t.dtype for t in ins), {(d,) * 4 for d in IO_DTYPES})
    if not cuda:
        return ifft_w_dual_plain(*ins)
    n1, n2 = factors(w)
    image, fwd = _empty(a0r.shape, a0r), _empty(a0r.shape, a0r)
    _launch("ifft_w_dual", "lpt_ifft_w_dual", "pppppppiiii", *ins, image, fwd,
            _design_table(w, False, ifft_w_dual_design(w), a0r.device), rows, n1, n2,
            _CODE[a0r.dtype])
    ifft_w_dual.launches += 1
    return image, fwd


# ---------------------------------------------------------------------------
# the pass-level compositions (pallas_kernels2.py:668-694, 835-842, 898-909,
# 936-954, 2262-2278): kernels only, no kernel of their own.  Planes (h, W) or
# stacks (P, h, W) in split order, filter planes (h, W) or (Pc, h, W).
# ---------------------------------------------------------------------------


def _hv(t, h):
    """A (..., h, W) plane viewed (..., n1, n2, W)."""
    n1, n2 = _factor(h)
    return t.reshape(tuple(t.shape[:-2]) + (n1, n2, t.shape[-1]))


def _flat(like, *ts):
    return tuple(t.reshape(like.shape) for t in ts)


def fft_h(vr, vi, h, ops=None):
    """Forward H transform to split order: K14 forward, K15 forward."""
    ops = ops or KERNELS
    yr, yi = ops.h_passA(_hv(vr, h), _hv(vi, h), h, False)
    return _flat(vr, *ops.h_passB(yr, yi, h, False))


def ifft_h(vr, vi, h, filt_r=None, filt_i=None, ops=None):
    """Inverse H transform from split order, with the optional filter
    multiply on the split-order spectrum before it: K15 inverse (filter
    fused), K14 inverse (twiddle, contraction, 1/h)."""
    ops = ops or KERNELS
    f = (None, None) if filt_r is None else (_hv(filt_r, h), _hv(filt_i, h))
    ar, ai = ops.h_passB(_hv(vr, h), _hv(vi, h), h, True, *f)
    return _flat(vr, *ops.h_passA(ar, ai, h, True))


def fft_h_combine(vr, vi, ar, ai, hr, hi, rr, h, ops=None):
    """Forward H transform of the second ADMM plane with the spectrum
    combine fused into its stage 2: K14 forward, K16.  Returns (fr, fi) =
    R (a + conj(H) b)."""
    ops = ops or KERNELS
    yr, yi = ops.h_passA(_hv(vr, h), _hv(vi, h), h, False)
    return _flat(vr, *ops.h_passB_combine(yr, yi, *(_hv(t, h) for t in (ar, ai, hr, hi, rr)),
                                          h))


def fft_h_combine2(rkr, rki, vr, vi, hr, hi, rr, h, ops=None):
    """Forward H transforms of both ADMM planes with the spectrum combine
    fused into one stage 2 (pallas_kernels2.py:936): K14 forward on rk and
    on v, then K18.  Returns (fr, fi) = R (a + conj(H) b), a and b the
    split-order H spectra of rk and v, as ``fft_h_combine(v, *fft_h(rk),
    ...)`` gives it, with the rk spectrum kept in f32 and never stored."""
    ops = ops or KERNELS
    xr, xi = ops.h_passA(_hv(rkr, h), _hv(rki, h), h, False)
    yr, yi = ops.h_passA(_hv(vr, h), _hv(vi, h), h, False)
    return _flat(vr, *ops.h_passB_combine2(xr, xi, yr, yi,
                                           *(_hv(t, h) for t in (hr, hi, rr)), h))


# How far fft_h_combine2 may lie from fft_h then fft_h_combine, as a
# spectra_gap by io dtype: the same arithmetic at f32; at bf16 io fft_h
# stores the rk spectrum at bf16 and K18 keeps it in f32, which moves F by
# the rounding of a (at most 2^-8 of max |R a|) and one flip of the
# output's rounding (at most 2^-7 of max |F|): two bf16 ulps.
TOL_COMBINE2 = {_F32: 1e-5, _BF16: 2 * 2.0 ** -7}


def spectra_gap(out, ref):
    """max |out - ref| / max |ref| over all the planes of two tuples."""
    return (max(float((a.float() - b.float()).abs().max()) for a, b in zip(out, ref))
            / max(float(b.float().abs().max()) for b in ref))


def ifft_h_dual(vr, vi, hr, hi, h, ops=None):
    """(ifft_h(v), ifft_h(H v)) with the spectrum read once and the filter
    multiply fused: K17, then K4 inverse on both.  Returns ((z0r, z0i),
    (z1r, z1i))."""
    ops = ops or KERNELS
    a0r, a0i, a1r, a1i = ops.h_passB_dual(*(_hv(t, h) for t in (vr, vi, hr, hi)), h)
    z0, z1 = ops.h_passA_pair(a0r, a0i, a1r, a1i, h, True)
    return _flat(vr, *z0), _flat(vr, *z1)


def filtered_synthesis_pallas2(x, filt_r, filt_i, ops=None):
    """Re ifft2(fft2(x) F) of (..., h, W) real planes (io dtype) with the
    filter F in split order on both axes (a plane or a stack of Pc): K12,
    K14, K15, K15 with the filter, K14, K13; f32 out.  (The JAX function's
    ``block_rows`` is a TPU VMEM block size and has no counterpart.)"""
    ops = ops or KERNELS
    h = x.shape[-2]
    hr, hi = fft_h(*ops.fft_w(x), h, ops=ops)
    return ops.ifft_w(*ifft_h(hr, hi, h, filt_r, filt_i, ops=ops))


WRAPPERS = (rfft_w, irfft_w, e1_rtv, h_passA_pair, h_combine_dual,
            irfft_w_dual_state, sat_scan_i16, e1_rcarry, irfft_w_dual,
            e1_carry, ifft_w_dual, fft_w, ifft_w, h_passA, h_passB,
            h_passB_combine, h_passB_dual, h_passB_combine2)
for _w in WRAPPERS:
    _w.launches = 0

# the kernel set the solver runs, and the same functions in plain PyTorch
# (for holding the kernels against it on the card)
KERNELS = SimpleNamespace(**{w.__name__: w for w in WRAPPERS})
PLAIN = SimpleNamespace(**{w.__name__: globals()[w.__name__ + "_plain"] for w in WRAPPERS})


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
