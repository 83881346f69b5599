"""K12's and K13's radix designs (csrc/lpt_fft.cuh) modelled on the CPU.

K13 ``ifft_w`` runs K11's row function ``fft::ifft_two_rows`` on two rows
a block: rows r0 and r0 + 1 of the split-order spectrum are its a0 and
a1, its image and fwd outputs rows r0 and r0 + 1 of the result; the last
row of an odd count is a block of its own with a1 = a0, image alone
stored.  Its model is K11's (``model_ifft_w_dual``) on those pairs.

K12 ``fft_w`` runs ``fft::fft_two_real_rows``: z = x[r0] + i s x[r0 + 1]
loaded in pass 0's order (a missing row is 0), s the balancing power of
two of the register maxima, K1's forward passes, thread-to-position maps
and f32 twiddle table, the exchange from the final digit order into the
split layout, and the mirror store that separates the two spectra.

Both models are held to the JAX package's ``fft_w`` / ``ifft_w`` in
interpret mode and to the port's plain versions, so an index, pairing or
scale mistake in either schedule shows here before a kernel reaches a
card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.ops import split_fft as sf
from test_torch_ifft_radix import _balance, model_ifft_w_dual
from test_torch_rfft_radix import _dft_registers, _frequency, _passes, _positions

# max |model - reference| / max |reference|, per row of each output: the
# bound chip_smoke.py holds the kernels to against the plain versions
TOL_KERNEL = 1e-4
TOL_PLAIN = 1e-5
MODEL_WS = (512, 1024, 8192)
ROWS = (4, 5)                 # an even and an odd row count


@pytest.fixture
def interpret():
    pk2._set_interpret(True)
    try:
        yield
    finally:
        pk2._set_interpret(False)


def _w_table(w, design_fn):
    """The K12 / K13 constant table as complex64, as the wrapper passes it."""
    t = K._design_table(w, False, design_fn(w), torch.device("cpu"))
    return torch.view_as_complex(t).numpy()


def _rows(rng, rows, w):
    """(rows, W) f32 rows: row 0 at 1e4 times the rest, so the pair (0, 1)
    needs the balance in both kernels."""
    x = rng.randn(rows, w)
    x[0] *= 1e4
    return x.astype(np.float32)


def _pairs(rows):
    """Row indices (r0, r1) of each block: r1 = r0 for the last row of an
    odd count."""
    r0 = np.arange(0, rows, 2)
    return r0, np.minimum(r0 + 1, rows - 1)


def model_ifft_w(vr, vi, balance=True):
    """K13's radix design on (rows, W) f32 split-order spectra -> the real
    parts of the inverses (rows, W), as the kernel computes them."""
    r0, r1 = _pairs(vr.shape[0])
    image, fwd = model_ifft_w_dual(vr[r0], vi[r0], vr[r1], vi[r1], balance=balance)
    out = np.empty_like(vr)
    out[r0] = image
    two = r1 != r0
    out[r1[two]] = fwd[two]
    return out


def model_fft_w(x, balance=True):
    """K12's radix design on (rows, W) f32 real rows -> (zr, zi), the
    split-order spectra, as the kernel computes them (f32 arithmetic)."""
    rows, w = x.shape
    n1, n2 = K.factors(w)
    r0, r1 = _pairs(rows)
    x0 = x[r0]
    x1 = np.where((r1 != r0)[:, None], x[r1], np.float32(0))
    s = (_balance(np.abs(x0).max(axis=1), np.abs(x1).max(axis=1)) if balance
         else np.ones(r0.size, np.float32))
    buf = (x0 + 1j * (x1 * s[:, None])).astype(np.complex64)
    tw = _w_table(w, K.fft_w_design)[2 * (n1 + n2) + 2 * w:]
    for r, length, off in _passes(w):
        pos, u = _positions(w, r, length)
        v = _dft_registers(buf[:, pos])
        if off is not None:
            q = length // r
            c = np.arange(1, r)[None, None, :]
            v[..., 1:] = v[..., 1:] * tw[off + (c - 1) * q + u]
        buf[:, pos] = v
    # final layout: frequency f at split position (f % n1) * n2 + f // n1
    f = _frequency(w, np.arange(w))
    z = np.empty_like(buf)
    z[:, (f % n1) * n2 + f // n1] = buf
    q = z[:, sf.mirror_indices(w)]
    half, inv_s = np.float32(0.5), (np.float32(1) / s)[:, None]
    zr, zi = np.empty_like(x), np.empty_like(x)
    zr[r0], zi[r0] = half * (z.real + q.real), half * (z.imag - q.imag)
    two = r1 != r0
    zr[r1[two]] = (half * (z.imag + q.imag) * inv_s)[two]
    zi[r1[two]] = (half * (q.real - z.real) * inv_s)[two]
    return zr, zi


def _row_errs(a, b):
    """max |a - b| / max |b| of each row."""
    return np.abs(a - b).max(axis=-1) / np.abs(b).max(axis=-1)


@pytest.mark.parametrize("w", MODEL_WS)
@pytest.mark.parametrize("rows", ROWS)
def test_ifft_model_matches_pallas(interpret, w, rows):
    rng = np.random.RandomState(80 + w.bit_length() + rows)
    vr, vi = _rows(rng, rows, w), _rows(rng, rows, w)
    ref = np.asarray(pk2.ifft_w(jnp.asarray(vr), jnp.asarray(vi), block_rows=rows))
    assert _row_errs(model_ifft_w(vr, vi), ref).max() <= TOL_KERNEL


@pytest.mark.parametrize("w", MODEL_WS)
@pytest.mark.parametrize("rows", ROWS)
def test_fft_model_matches_pallas(interpret, w, rows):
    rng = np.random.RandomState(90 + w.bit_length() + rows)
    x = _rows(rng, rows, w)
    ref = pk2.fft_w(jnp.asarray(x), block_rows=rows)
    for a, b in zip(model_fft_w(x), ref):
        assert _row_errs(a, np.asarray(b)).max() <= TOL_KERNEL


@pytest.mark.parametrize("w", MODEL_WS)
def test_models_match_plain(w):
    """Both models against the port's plain versions on a plane stack's
    rows, an odd count (the plain versions are the kernels' yardstick on
    the card)."""
    rng = np.random.RandomState(100 + w.bit_length())
    x, vr, vi = (_rows(rng, 9, w) for _ in range(3))
    ref = K.ifft_w_plain(*(torch.from_numpy(a.reshape(3, 3, w)) for a in (vr, vi)))
    assert _row_errs(model_ifft_w(vr, vi), ref.reshape(9, w).numpy()).max() <= TOL_PLAIN
    for a, b in zip(model_fft_w(x), K.fft_w_plain(torch.from_numpy(x.reshape(3, 3, w)))):
        assert _row_errs(a, b.reshape(9, w).numpy()).max() <= TOL_PLAIN


@pytest.mark.parametrize("model", (model_fft_w, model_ifft_w), ids=("fft_w", "ifft_w"))
def test_balance_matters_on_these_rows(model):
    """Without the balance the row paired with one 1e4 times larger misses
    the kernel bound; with it every row meets it (so the data exercise
    it)."""
    rng = np.random.RandomState(11)
    ins = [_rows(rng, 4, 1024) for _ in range(1 if model is model_fft_w else 2)]
    split = sf.split_order_indices(1024)       # frequency at each split position
    if model is model_fft_w:
        z = np.fft.fft(ins[0].astype(np.float64))[:, split]
        ref = [z.real, z.imag]
    else:
        nat = (ins[0] + 1j * ins[1]).astype(np.complex128)[:, np.argsort(split)]
        ref = [np.fft.ifft(nat).real]
    for balance, ok in ((True, True), (False, False)):
        out = model(*ins, balance=balance)
        out = out if isinstance(out, tuple) else (out,)
        worst = max(_row_errs(a, r).max() for a, r in zip(out, ref))
        assert (worst <= TOL_KERNEL) == ok


@pytest.mark.parametrize("rows", (1, 3))
def test_odd_tail_is_exact_for_its_row(rows):
    """The last row of an odd count alone in its block: its spectrum (K12,
    a zero second row) and its inverse (K13, a1 = a0) meet the bound
    against float64, and the models give an unpaired row what a pair
    with a zero row gives."""
    rng = np.random.RandomState(12 + rows)
    w = 512
    x, vr, vi = (rng.randn(rows, w).astype(np.float32) for _ in range(3))
    split = sf.split_order_indices(w)
    z = np.fft.fft(x.astype(np.float64))[:, split]
    for a, r in zip(model_fft_w(x), (z.real, z.imag)):
        assert _row_errs(a, r).max() <= TOL_PLAIN
    ref = np.fft.ifft((vr + 1j * vi).astype(np.complex128)[:, np.argsort(split)]).real
    assert _row_errs(model_ifft_w(vr, vi), ref).max() <= TOL_PLAIN
    padded = np.concatenate([x, np.zeros((1, w), np.float32)])
    for a, b in zip(model_fft_w(x), model_fft_w(padded)):
        assert np.array_equal(a, b[:rows])


@pytest.mark.parametrize("design_fn", (K.fft_w_design, K.ifft_w_design),
                         ids=("fft_w", "ifft_w"))
def test_design_is_a_shape_rule(design_fn):
    """Powers of two W from 512 to 8192 take the radix design, any other
    W the split one (W = 1536 = 12 x 128, the smoke run's split case), as
    K11's rule; the radix widths factor as (W / 128, 128), the split
    order the kernels refuse any other factorization of."""
    for w in K.IFFT_RADIX_WIDTHS:
        assert design_fn(w) == "radix" == K.ifft_w_dual_design(w)
        assert K.factors(w) == (w // 128, 128)
    for w in (128, 256, 384, 1536, 3072, 16384):
        assert design_fn(w) == "split"
    assert all(f % 4 == 0 for f in K.factors(1536))
    # the CPU wrappers run the plain versions whatever the design
    rng = np.random.RandomState(13)
    for w in (512, 1536):
        x, vr, vi = (torch.from_numpy(rng.randn(3, w).astype(np.float32)) for _ in range(3))
        for a, b in zip(K.fft_w(x), K.fft_w_plain(x)):
            assert torch.equal(a, b)
        for od in (torch.float32, torch.bfloat16):
            assert torch.equal(K.ifft_w(vr, vi, od), K.ifft_w_plain(vr, vi, od))


@pytest.mark.parametrize("w", (512, 1536, 8192))
@pytest.mark.parametrize("design_fn", (K.fft_w_design, K.ifft_w_design),
                         ids=("fft_w", "ifft_w"))
def test_table_keeps_the_split_table_as_prefix(w, design_fn):
    """The radix table extends the split design's table (no unpack
    factors), so the C entry's argument reads the same constants for
    either design; a split width gets the split table alone."""
    full = _w_table(w, design_fn)
    base = K._table_np(w, False)
    assert np.array_equal(full[:base.size], base)
    tail = K._radix_twiddles_np(w) if design_fn(w) == "radix" else base[:0]
    assert np.array_equal(full[base.size:], tail)
