"""K1's radix design (csrc/lpt_fft.cuh) modelled on the CPU.

A numpy model of the kernel's schedule runs the same passes as the CUDA
code: the same radices (``kernels.radix_plan``), the same map from a
thread's butterflies to positions of the row, the same f32 twiddle table
(``kernels._design_table``) and the same final digit order and its map to
split positions, then the mirror unpack of ``w_fwd_core``.  It is held to
the JAX package's ``rfft_w`` in interpret mode, so an index or twiddle
mistake in the schedule shows here before the kernel reaches a card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.ops import split_fft as sf

# max |model - reference| / max |reference|, the bound chip_smoke.py holds
# the kernel to (at M = 4096 the spectra reach ~300, so an absolute 1e-4
# would ask for 3e-7 relative, below f32 rounding of either summation order)
TOL_KERNEL = 1e-4
RADIX_MS = (64, 256, 4096)    # 8192 (K11's radix design) in the generic schedule tests


@pytest.fixture
def interpret():
    pk2._set_interpret(True)
    try:
        yield
    finally:
        pk2._set_interpret(False)


def _k1_table(m):
    """K1's constant table as complex64, as the wrapper passes it."""
    t = K._design_table(m, True, K.rfft_w_design(m), torch.device("cpu"))
    return torch.view_as_complex(t).numpy()


def _passes(m):
    """(radix R, input length L, twiddle offset or None) of each pass."""
    out, length, off = [], m, 0
    plan = K.radix_plan(m)
    for s, r in enumerate(plan):
        last = s == len(plan) - 1
        out.append((r, length, None if last else off))
        if not last:
            off += (r - 1) * (length // r)
        length //= r
    return out


def _positions(m, r, length):
    """(threads, butterflies a thread, R) positions of the row that each
    butterfly of a pass reads and writes: butterfly b = t + T i of thread t
    (T = M / 16 threads) is group g = b // (L/R), offset u = b % (L/R),
    element r at g L + u + (L/R) r."""
    nt = m // K.RADIX
    t = np.arange(nt)[:, None, None]
    i = np.arange(K.RADIX // r)[None, :, None]
    rr = np.arange(r)[None, None, :]
    b = t + nt * i
    q = length // r
    return (b // q) * length + b % q + q * rr, b % q


def _dft_registers(v):
    """The kernel's in-register DFT of the last axis (length R): radix-2
    decimation in frequency in complex64 with the roots exp(-2 pi i k /
    16), bit-reversed order restored at the end."""
    r = v.shape[-1]
    w16 = np.exp(-2j * np.pi * np.arange(16) / 16).astype(np.complex64)
    v = v.copy()
    h = r // 2
    while h >= 1:
        for base in range(0, r, 2 * h):
            for i in range(h):
                a, b = v[..., base + i].copy(), v[..., base + i + h].copy()
                v[..., base + i] = a + b
                v[..., base + i + h] = (a - b) * w16[i * 8 // h]
        h //= 2
    bits = r.bit_length() - 1
    rev = [int(format(k, f"0{bits}b")[::-1], 2) if bits else 0 for k in range(r)]
    return v[..., rev]


def _frequency(m, idx):
    """Frequency held at storage index ``idx`` after the last pass: the
    digits of idx (pass 0's most significant) reversed."""
    plan = K.radix_plan(m)
    f, rest, place = np.zeros_like(idx), idx.copy(), 1
    digits = []
    for r in reversed(plan):
        digits.append(rest % r)
        rest //= r
    for r, d in zip(plan, reversed(digits)):
        f += d * place
        place *= r
    return f


def model_rfft_w(x):
    """The radix design's schedule on (rows, N) split-layout f32 rows ->
    (zr, zi), as the kernel computes them (f32 arithmetic)."""
    rows, n = x.shape
    m = n // 2
    n1, n2 = K.factors(m)
    tab = _k1_table(m)
    e = tab[2 * (n1 + n2) + 2 * m:2 * (n1 + n2) + 3 * m]
    tw = tab[2 * (n1 + n2) + 3 * m:]
    buf = (x[:, :m] + 1j * x[:, m:]).astype(np.complex64)
    for r, length, off in _passes(m):
        pos, u = _positions(m, r, length)
        v = _dft_registers(buf[:, pos])
        if off is not None:
            q = length // r
            c = np.arange(1, r)[None, None, :]
            v[..., 1:] = v[..., 1:] * tw[off + (c - 1) * q + u]
        buf[:, pos] = v
    # final layout: frequency f at split position (f % n1) * n2 + f // n1
    f = _frequency(m, np.arange(m))
    p = np.empty_like(buf)
    p[:, (f % n1) * n2 + f // n1] = buf
    rm = p[:, sf.mirror_indices(m)]
    sr, si = p.real + rm.real, p.imag - rm.imag
    dr, di = p.real - rm.real, p.imag + rm.imag
    zr = np.float32(0.5) * (sr + e.real * di + e.imag * dr)
    zi = np.float32(0.5) * (si - (e.real * dr - e.imag * di))
    zi[:, 0] = p[:, 0].real - p[:, 0].imag
    return zr.astype(np.float32), zi.astype(np.float32)


@pytest.mark.parametrize("m", RADIX_MS + (8192,))
def test_radix_twiddles_are_rounded_roots(m):
    """Every twiddle of the table is exp(-2 pi i k / M) from float64,
    rounded to f32, at the k = u c M / L its pass reads it for."""
    tw = K._radix_twiddles_np(m)
    want = []
    for r, length, _ in _passes(m)[:-1]:
        q = length // r
        for c in range(1, r):
            k = np.arange(q) * c * (m // length)
            want.append(np.exp(-2j * np.pi * k.astype(np.float64) / m).astype(np.complex64))
    want = np.concatenate(want)
    assert tw.dtype == np.complex64 and tw.shape == want.shape
    assert np.array_equal(tw, want)


@pytest.mark.parametrize("m", RADIX_MS)
def test_rfft_table_keeps_the_split_table_as_prefix(m):
    """The radix table extends the split design's table, so the C entry's
    argument reads the same constants for either design."""
    full = _k1_table(m)
    base = K._table_np(m, True)
    tw = K._radix_twiddles_np(m)
    assert np.array_equal(full[:base.size], base)
    assert np.array_equal(full[base.size:base.size + tw.size], tw)
    # then the unpack factors at natural frequencies (K2's and K6's radix rows)
    assert np.array_equal(full[base.size + tw.size:], K._unpack_natural_np(m))


@pytest.mark.parametrize("m", K.RADIX_LENGTHS + (8192,))
def test_radix_schedule_covers_the_row(m):
    """Each pass's butterflies read every position of the row once, and
    the final digit order is a permutation of the frequencies."""
    for r, length, _ in _passes(m):
        pos, _ = _positions(m, r, length)
        assert np.array_equal(np.sort(pos.reshape(-1)), np.arange(m))
    assert np.array_equal(np.sort(_frequency(m, np.arange(m))), np.arange(m))
    assert int(np.prod(K.radix_plan(m))) == m
    assert all(r in (2, 4, 8, 16) for r in K.radix_plan(m))


@pytest.mark.parametrize("m", RADIX_MS)
def test_radix_model_matches_pallas(interpret, m):
    rng = np.random.RandomState(30 + m.bit_length())
    x = rng.randn(8, 2 * m).astype(np.float32)
    ref = pk2.rfft_w(jnp.asarray(x), block_rows=8)
    for a, b in zip(model_rfft_w(x), ref):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= TOL_KERNEL * np.abs(b).max()


@pytest.mark.parametrize("m", RADIX_MS)
def test_radix_model_matches_plain(m):
    """The model against the port's plain version on a plane stack's rows
    (the plain version is the kernel's yardstick on the card)."""
    rng = np.random.RandomState(40 + m.bit_length())
    x = rng.randn(3, 4, 2 * m).astype(np.float32)
    zr, zi = K.rfft_w_plain(torch.from_numpy(x))
    mr, mi = model_rfft_w(x.reshape(12, 2 * m))
    top = max(float(zr.abs().max()), float(zi.abs().max()))
    assert np.abs(mr - zr.reshape(12, m).numpy()).max() <= 1e-5 * top
    assert np.abs(mi - zi.reshape(12, m).numpy()).max() <= 1e-5 * top


def test_design_is_a_shape_rule():
    """Powers of two M from 64 to 4096 take the radix design, any other
    M the split one (M = 192, W = 384, the smoke run's split case)."""
    for m in K.RADIX_LENGTHS:
        assert K.rfft_w_design(m) == "radix"
    for m in (16, 32, 96, 192, 384, 2028, 8192):
        assert K.rfft_w_design(m) == "split"
    assert all(f % 4 == 0 for f in K.factors(192))
    # the CPU wrapper runs the plain version whatever the design
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 384).astype(np.float32))
    for a, b in zip(K.rfft_w(x), K.rfft_w_plain(x)):
        assert torch.equal(a, b)
