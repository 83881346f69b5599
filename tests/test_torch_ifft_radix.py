"""K11's radix design (csrc/lpt_fft.cuh ``ifft_two_rows``) modelled on the CPU.

A numpy model of the kernel's schedule runs the same phases as the CUDA
code: the mirror pairing of the split-order spectra on the loads (the
thread units of ``unit_pos``, each a vector of row k1 and its mirror
vector of row n1 - k1 read backwards, rows 0 and n1/2 included), the half
spectra of 2 herm(a0) and 2 herm(a1) at q = min(f, W - f), the balancing
power of two, the gather of conj(2 C) at the pass-0 positions, the
forward radix passes of ``kernels.radix_plan(W)`` with their
thread-to-position maps and the f32 twiddle table, and the exchange from
the final digit order into natural order.  It is held to the JAX
package's ``ifft_w_dual`` in interpret mode and to the port's plain
version, so an index or scale mistake in the schedule shows here before
the kernel reaches a card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.ops import split_fft as sf
from test_torch_rfft_radix import _dft_registers, _frequency, _passes, _positions

# max |model - reference| / max |reference| per output: the bound
# chip_smoke.py holds the kernel to against the plain version
TOL_KERNEL = 1e-4
TOL_PLAIN = 1e-5
N2 = 128                      # n2 of every radix width (kernels.factors)
MODEL_WS = (512, 1024, 8192)
VECS = (4, 8)                 # positions a 16-byte load holds: f32, bf16


@pytest.fixture
def interpret():
    pk2._set_interpret(True)
    try:
        yield
    finally:
        pk2._set_interpret(False)


def _units(w, v):
    """(k1, first k2) of phase 1's units in the kernel's order
    (``unit_pos``): the (n1/2 - 1) * n2/v units pairing row k1 with row
    n1 - k1, then the n2/(2v) pairing the first half of row n1/2 with its
    second half."""
    n1, nkv = w // N2, N2 // v
    nr = n1 // 2 - 1
    u = np.arange(nr * nkv)
    p = ((u >> 4) << 3) | (u & 7)
    k1 = np.concatenate([1 + p % nr, np.full(nkv // 2, n1 // 2)])
    k2 = np.concatenate([(2 * (p // nr) + ((u >> 3) & 1)) * v, np.arange(nkv // 2) * v])
    return k1, k2


def _pairs(w, v):
    """Every mirror pair phase 1 forms: split positions p of a[f] and pm
    of a[W - f], the half-spectrum index q = min(f, W - f) and whether f
    is the lower of the two; the vector units first, then row 0's scalar
    pairs (f = n1 k2 against n1 (n2 - k2), k2 <= n2/2)."""
    n1 = w // N2
    k1, k2 = _units(w, v)
    e = np.arange(v)
    pos = (k1 * N2 + k2)[:, None] + e
    mir = ((n1 - k1) * N2 + N2 - v - k2)[:, None] + (v - 1 - e)    # read backwards
    f = k1[:, None] + n1 * (k2[:, None] + e)
    lower = np.repeat(k2 < N2 // 2, v)
    r0 = np.arange(N2 // 2 + 1)
    p = np.concatenate([pos.reshape(-1), r0])
    pm = np.concatenate([mir.reshape(-1), (N2 - r0) % N2])
    f = np.concatenate([f.reshape(-1), n1 * r0])
    lower = np.concatenate([lower, np.ones(r0.size, bool)])
    return p, pm, np.where(lower, f, w - f), lower


def _balance(m0, m1):
    """The power of two that brings max |a1| = m1 into the binade of max
    |a0| = m0 (``pow2_balance``): 1 if either is 0 or not finite, the
    exponent clamped to +-100."""
    m0, m1 = np.asarray(m0, np.float32), np.asarray(m1, np.float32)
    ok = (m0 > 0) & (m1 > 0) & np.isfinite(m0) & np.isfinite(m1)
    k = np.clip(np.frexp(m0)[1] - np.frexp(m1)[1], -100, 100)
    return np.where(ok, np.ldexp(np.float32(1), k), np.float32(1)).astype(np.float32)


def _k11_table(w):
    """K11's constant table as complex64, as the wrapper passes it."""
    t = K._design_table(w, False, K.ifft_w_dual_design(w), torch.device("cpu"))
    return torch.view_as_complex(t).numpy()


def _out_slot(j):
    """Slot of natural index j in the output exchange (``out_slot``)."""
    return j + (j >> 8)


def _half_spectra(a0, a1, v):
    """Phase 1 on complex64 rows (rows, W): the half spectra 2 herm(a0) and
    2 herm(a1), (rows, W/2 + 1), and the raw maxima of each row."""
    rows, w = a0.shape
    p, pm, q, lower = _pairs(w, v)
    hs, ms = [], []
    for a in (a0, a1):
        x, y = a[:, p], a[:, pm]
        h = np.empty((rows, w // 2 + 1), np.complex64)
        h[:, q] = np.where(lower, x + np.conj(y), y + np.conj(x))
        hs.append(h)
        ms.append(np.abs(np.stack([x.real, x.imag, y.real, y.imag])).max(axis=(0, 2)))
    return hs, ms


def model_ifft_w_dual(a0r, a0i, a1r, a1i, v=4, balance=True):
    """The radix design's schedule on (rows, W) f32 split-order spectra
    -> (image, fwd), as the kernel computes them (f32 arithmetic)."""
    rows, w = a0r.shape
    n1, n2 = K.factors(w)
    a0 = (a0r + 1j * a0i).astype(np.complex64)
    a1 = (a1r + 1j * a1i).astype(np.complex64)
    (h0, h1), (m0, m1) = _half_spectra(a0, a1, v)
    s = _balance(m0, m1) if balance else np.ones(rows, np.float32)
    # gather: thread t, register r reads conj(2 C) at f = t + T r
    nt = w // K.RADIX
    f = np.arange(nt)[:, None] + nt * np.arange(K.RADIX)[None, :]
    lo = f < w // 2
    g0, g1 = h0[:, np.where(lo, f, w - f)], h1[:, np.where(lo, f, w - f)]
    sc = s[:, None, None]
    c = np.where(lo, g0 + 1j * sc * g1, np.conj(g0) + 1j * sc * np.conj(g1))
    buf = np.empty((rows, w), np.complex64)
    buf[:, f] = np.conj(c).astype(np.complex64)
    tab = _k11_table(w)
    tw = tab[2 * (n1 + n2) + 2 * w:]
    for r, length, off in _passes(w):
        pos, u = _positions(w, r, length)
        vals = _dft_registers(buf[:, pos])
        if off is not None:
            q = length // r
            cc = np.arange(1, r)[None, None, :]
            vals[..., 1:] = vals[..., 1:] * tw[off + (cc - 1) * q + u]
        buf[:, pos] = vals
    # storage index i holds output index _frequency(i); one exchange to natural order
    ex = np.zeros((rows, w + w // 16), np.complex64)
    ex[:, _out_slot(_frequency(w, np.arange(w)))] = buf
    nat = ex[:, _out_slot(np.arange(w))]
    image = nat.real * np.float32(0.5 / w)
    fwd = nat.imag * (np.float32(-0.5 / w) / s[:, None])
    return image.astype(np.float32), fwd.astype(np.float32)


def _spectra(rng, rows, w):
    """Four (rows, W) f32 planes a0r, a0i, a1r, a1i: row 0 with a1 1e4
    times a0, row 1 with a0 1e4 times a1, the rest at one scale, so the
    balance is per row and matters."""
    sc0, sc1 = np.ones((rows, 1)), np.ones((rows, 1))
    sc1[0], sc0[1] = 1e4, 1e4
    return [(rng.randn(rows, w) * s).astype(np.float32) for s in (sc0, sc0, sc1, sc1)]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("w", K.IFFT_RADIX_WIDTHS)
@pytest.mark.parametrize("v", VECS)
def test_mirror_pairing_covers_the_row(w, v):
    """Each pair is a frequency and its mirror; every split position is
    loaded, every half-spectrum index 0..W/2 written once; rows 0 and
    n1/2 pair within themselves; a vector and its mirror are aligned."""
    n1 = w // N2
    p, pm, q, lower = _pairs(w, v)
    freq = sf.split_order_indices(w)
    assert np.array_equal(freq[pm], (w - freq[p]) % w)
    assert np.array_equal(np.sort(q), np.arange(w // 2 + 1))
    assert np.array_equal(np.unique(np.concatenate([p, pm])), np.arange(w))
    assert np.array_equal(q, np.minimum(freq[p], w - freq[p]))
    assert np.array_equal(lower, freq[p] <= w - freq[p])
    for row in (0, n1 // 2):
        on = p // N2 == row
        assert on.any() and np.array_equal(pm[on] // N2, np.full(on.sum(), row))
    k1, k2 = _units(w, v)
    assert np.all(k2 % v == 0) and np.all((N2 - v - k2) % v == 0)
    assert np.all((k1 >= 1) & (k1 <= n1 // 2))


@pytest.mark.parametrize("v", VECS)
def test_unit_lanes_share_sectors_and_banks(v):
    """At W = 8192: lanes l and l + 8 of a warp load the two halves of one
    32-byte sector (and of its mirror); the eight lanes of each 16-byte
    shared store write to at most two of a float4's bank groups each (two
    where the rows wrap from n1/2 - 1 to 1)."""
    k1, k2 = _units(8192, v)
    n_main = (8192 // N2 // 2 - 1) * (N2 // v)     # a multiple of 16 lanes
    for g0 in range(0, n_main, 16):
        first = g0 + np.arange(8)
        assert np.array_equal(k1[first], k1[first + 8])
        assert np.array_equal(k2[first + 8], k2[first] + v) and np.all(k2[first] % (2 * v) == 0)
        for uq in (first, first + 8):
            q = k1[uq] + (8192 // N2) * k2[uq]       # the first element of each lane
            assert np.bincount(q % 8).max() <= 2


@pytest.mark.parametrize("w", MODEL_WS)
def test_half_spectra_are_the_hermitian_parts(w):
    rng = np.random.RandomState(w)
    a0r, a0i, a1r, a1i = _spectra(rng, 3, w)
    a0 = (a0r + 1j * a0i).astype(np.complex64)
    a1 = (a1r + 1j * a1i).astype(np.complex64)
    (h0, h1), (m0, m1) = _half_spectra(a0, a1, 4)
    order = np.argsort(sf.split_order_indices(w))     # split position of each frequency
    for a, h, m in ((a0, h0, m0), (a1, h1, m1)):
        nat = a[:, order].astype(np.complex128)
        herm2 = nat + np.conj(np.roll(nat[:, ::-1], 1, axis=1))
        assert np.abs(h - herm2[:, :w // 2 + 1]).max() <= 1e-6 * np.abs(herm2).max()
        assert np.array_equal(m, np.maximum(np.abs(a.real), np.abs(a.imag)).max(axis=1))


def test_balance_is_a_power_of_two_into_the_binade():
    rng = np.random.RandomState(3)
    m0 = np.exp(rng.uniform(-30, 30, 200)).astype(np.float32)      # |k| < 100: no clamp
    m1 = np.exp(rng.uniform(-30, 30, 200)).astype(np.float32)
    s = _balance(m0, m1)
    assert np.array_equal(np.frexp(s)[0], np.full(200, 0.5, np.float32))
    assert np.array_equal(np.frexp(m1 * s)[1], np.frexp(m0)[1])
    edge = _balance([0.0, 1.0, np.inf, 1.0, 1.0, 1e30], [1.0, 0.0, 1.0, np.nan, 1e-30, 1e-30])
    assert np.array_equal(edge[:4], np.ones(4, np.float32))
    assert edge[4] == np.float32(2.0 ** 100) and edge[5] == np.float32(2.0 ** 100)


def test_balance_matters_on_these_spectra():
    """Without the balance the rows whose a1 and a0 differ 1e4-fold miss
    the kernel bound; with it they meet it (so the data exercise it)."""
    rng = np.random.RandomState(8)
    spec = _spectra(rng, 4, 1024)
    order = np.argsort(sf.split_order_indices(1024))    # float64 reference
    ref = [np.fft.ifft((spec[k] + 1j * spec[k + 1]).astype(np.complex128)[:, order]).real
           for k in (0, 2)]
    for balance, ok in ((True, True), (False, False)):
        out = model_ifft_w_dual(*spec, balance=balance)
        errs = [max(_rel(a[i], r[i]) for i in range(2)) for a, r in zip(out, ref)]
        assert (max(errs) <= TOL_KERNEL) == ok


@pytest.mark.parametrize("w", MODEL_WS)
def test_conjugation_and_gather(w):
    """conj(fft(conj(2 C))) / 2W is ifft(C) (float64), and the gather
    reads conj(2 C) at pass 0's positions t + T r from the half spectra."""
    rng = np.random.RandomState(w + 1)
    c = rng.randn(2, w) + 1j * rng.randn(2, w)
    assert np.allclose(np.conj(np.fft.fft(np.conj(2 * c))) / (2 * w), np.fft.ifft(c),
                       rtol=0, atol=1e-12)
    a0r, a0i, a1r, a1i = _spectra(rng, 2, w)
    a0 = (a0r + 1j * a0i).astype(np.complex64)
    a1 = (a1r + 1j * a1i).astype(np.complex64)
    (h0, h1), _ = _half_spectra(a0, a1, 4)
    order = np.argsort(sf.split_order_indices(w))
    n0, n1_ = a0[:, order].astype(np.complex128), a1[:, order].astype(np.complex128)
    full = [n + np.conj(np.roll(n[:, ::-1], 1, axis=1)) for n in (n0, n1_)]
    nt = w // K.RADIX
    f = np.arange(nt)[:, None] + nt * np.arange(K.RADIX)[None, :]
    lo = f < w // 2
    assert np.array_equal(lo, np.broadcast_to(np.arange(K.RADIX) < K.RADIX // 2, f.shape))
    g = np.where(lo, h0[:, np.where(lo, f, w - f)], np.conj(h0[:, np.where(lo, f, w - f)]))
    assert np.abs(g - full[0][:, f]).max() <= 1e-6 * np.abs(full[0]).max()
    assert np.array_equal(np.sort(f.reshape(-1)), np.arange(w))


@pytest.mark.parametrize("w", K.IFFT_RADIX_WIDTHS)
def test_output_exchange_fits_the_buffer(w):
    """The exchange slots are distinct and fit the passes' padded buffer
    (W + W/16 float2), which also holds the W/2 + 1 float4 half spectra."""
    slots = _out_slot(_frequency(w, np.arange(w)))
    assert np.unique(slots).size == w and slots.max() < w + w // 16
    assert 2 * (w // 2 + 1) <= w + w // 16
    assert np.array_equal(np.sort(_frequency(w, np.arange(w))), np.arange(w))


@pytest.mark.parametrize("w", MODEL_WS)
def test_radix_model_matches_pallas(interpret, w):
    rng = np.random.RandomState(60 + w.bit_length())
    spec = _spectra(rng, 8, w)
    ref = pk2.ifft_w_dual(*(jnp.asarray(x) for x in spec), block_rows=8)
    for a, b in zip(model_ifft_w_dual(*spec), ref):
        b = np.asarray(b)
        for i in range(8):      # each row: the balance is per row
            assert np.abs(a[i] - b[i]).max() <= TOL_KERNEL * np.abs(b[i]).max()


@pytest.mark.parametrize("w", MODEL_WS)
def test_radix_model_matches_plain(w):
    """The model against the port's plain version on a plane stack's rows
    (the plain version is the kernel's yardstick on the card), at both
    load widths: the unit map changes no value."""
    rng = np.random.RandomState(70 + w.bit_length())
    spec = [x.reshape(2, 3, w) for x in _spectra(rng, 6, w)]
    ref = K.ifft_w_dual_plain(*(torch.from_numpy(x) for x in spec))
    outs = [model_ifft_w_dual(*(x.reshape(6, w) for x in spec), v=v) for v in VECS]
    for a, b in zip(outs[0], outs[1]):
        assert np.array_equal(a, b)
    for a, r in zip(outs[0], ref):
        r = r.reshape(6, w).numpy()
        for i in range(6):
            assert np.abs(a[i] - r[i]).max() <= TOL_PLAIN * np.abs(r[i]).max()


def test_design_is_a_shape_rule():
    """Powers of two W from 512 to 8192 take the radix design, any other
    W the split one (W = 1536 = 12 x 128, the smoke run's split case);
    K1's rule is its own."""
    for w in K.IFFT_RADIX_WIDTHS:
        assert K.ifft_w_dual_design(w) == "radix"
        assert K.factors(w) == (w // N2, N2)
    for w in (128, 256, 384, 1536, 3072, 16384):
        assert K.ifft_w_dual_design(w) == "split"
    assert all(f % 4 == 0 for f in K.factors(1536))
    assert K.rfft_w_design(8192) == "split" and K.rfft_w_design(4096) == "radix"
    # the CPU wrapper runs the plain version whatever the design
    rng = np.random.RandomState(9)
    for w in (512, 1536):
        ins = [torch.from_numpy(rng.randn(2, 3, w).astype(np.float32)) for _ in range(4)]
        for a, b in zip(K.ifft_w_dual(*ins), K.ifft_w_dual_plain(*ins)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("w", (512, 1536, 8192))
def test_table_keeps_the_split_table_as_prefix(w):
    """The radix table extends the split design's table (no unpack
    factors), so the C entry's argument reads the same constants for
    either design; a split width gets the split table alone."""
    full = _k11_table(w)
    base = K._table_np(w, False)
    assert np.array_equal(full[:base.size], base)
    tail = K._radix_twiddles_np(w) if K.ifft_w_dual_design(w) == "radix" else base[:0]
    assert np.array_equal(full[base.size:], tail)
