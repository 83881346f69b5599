"""K2's and K6's radix designs (csrc/lpt_fft.cuh ``irfft_row``) modelled on the CPU.

A numpy model of ``irfft_row``'s schedule runs the same phases as the
CUDA code: the half spectrum into the split layout [k1 (n2+1) + k2] with
lane 0 replaced by z0, the gather of each pass-0 frequency f = t + T r
with its mirror M - f from that layout and the unpack factors of the
table's natural-order section (``kernels._unpack_natural_np``), the
unpack of ``w_inv_core`` in f32, the inverse by conjugation through K1's
forward passes (``kernels.radix_plan``, the thread-to-position maps and
the f32 twiddle table of tests/test_torch_rfft_radix.py), and the
exchange from the last pass's digit order into natural order (slot
``pad(j)``).  It is held to the JAX package's ``irfft_w`` in interpret
mode and to the port's plain version.  K6's radix order (two inverse
rows, the X/v update on each thread's positions, K1's forward core on the
result, ``rfft_core``) is modelled from the same pieces and held to the
JAX package's ``irfft_w_dual_state`` in interpret mode, at f32 and with
bf16 io and an int16 v carry.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from test_torch_modes import JDT, _check, _pair
from test_torch_rfft_radix import (_dft_registers, _frequency, _passes, _positions,
                                   model_rfft_w)

# max |model - reference| / max |reference|: the bound chip_smoke.py holds
# the kernels to against their plain versions
TOL_KERNEL = 1e-4
TOL_PLAIN = 1e-5
MODEL_MS = (64, 256, 4096)
MU1 = tsplit.ADMMParams().mu1


@pytest.fixture
def interpret():
    pk2._set_interpret(True)
    try:
        yield
    finally:
        pk2._set_interpret(False)


@pytest.fixture
def jax_modes(monkeypatch):
    """Pallas in interpret mode and the storage globals of the JAX kernels
    (as tests/test_torch_modes.py sets them)."""
    pk2._set_interpret(True)

    def set_modes(io="f32", v="f32"):
        monkeypatch.setattr(pk2, "_IO_DTYPE", JDT[io])
        monkeypatch.setattr(pk2, "_CARRY_V_DTYPE", JDT[v])

    try:
        yield set_modes
    finally:
        pk2._set_interpret(False)


def _table(m):
    """K2's and K6's radix table as complex64, as the wrappers pass it:
    (E at split positions, radix twiddles, E at natural frequencies)."""
    t = torch.view_as_complex(K._design_table(m, True, K.irfft_w_design(m),
                                              torch.device("cpu"))).numpy()
    n1, n2 = K.factors(m)
    e0 = 2 * (n1 + n2) + 2 * m
    ntw = K._radix_twiddles_np(m).size
    return t[e0:e0 + m], t[e0 + m:e0 + m + ntw], t[e0 + m + ntw:]


def _pad(j):
    """Shared slot of row position j (``fft::pad``)."""
    return j + (j >> 4)


def _split_slot(m, f):
    """Shared slot of frequency f in the split layout [k1 (n2+1) + k2]
    (k1 = f % n1, k2 = f / n1), as the gather computes it."""
    n1, n2 = K.factors(m)
    return (f % n1) * (n2 + 1) + f // n1


def model_irfft_row(zr, zi, z0=None):
    """``irfft_row`` on (rows, M) f32 half spectra (lane 0 replaced by the
    complex column z0, if given) -> (rows, 2M) split-layout rows, as the
    kernel computes them (f32 arithmetic)."""
    rows, m = zr.shape
    n1, n2 = K.factors(m)
    _, tw, en = _table(m)
    z = (zr + 1j * zi).astype(np.complex64)
    if z0 is not None:
        z[:, 0] = z0
    # phase 1: split position pos = k1 n2 + k2 to slot k1 (n2+1) + k2
    pos = np.arange(m)
    sm = np.empty((rows, _split_slot(m, m - 1) + n2 + 1), np.complex64)
    sm[:, (pos // n2) * (n2 + 1) + pos % n2] = z
    # phase 2: gather f and M - f, unpack (w_inv_core's algebra)
    f = np.arange(m)
    zf, q = sm[:, _split_slot(m, f)], sm[:, _split_slot(m, (m - f) % m)]
    wr, wi = en[f].real, -en[f].imag
    h = np.float32(0.5)
    er, ei = h * (zf.real + q.real), h * (zf.imag - q.imag)
    dr, di = h * (zf.real - q.real), h * (zf.imag + q.imag)
    orr, oi = wr * dr - wi * di, wr * di + wi * dr
    er[:, 0], ei[:, 0] = h * (zf[:, 0].real + zf[:, 0].imag), 0
    orr[:, 0], oi[:, 0] = h * (zf[:, 0].real - zf[:, 0].imag), 0
    buf = ((er - oi) - 1j * (ei + orr)).astype(np.complex64)      # conj P[f]
    # phase 3: K1's forward passes on thread t's registers f = t + T r
    for r, length, off in _passes(m):
        posr, u = _positions(m, r, length)
        v = _dft_registers(buf[:, posr])
        if off is not None:
            qq = length // r
            c = np.arange(1, r)[None, None, :]
            v[..., 1:] = v[..., 1:] * tw[off + (c - 1) * qq + u]
        buf[:, posr] = v
    # phase 4: storage index i holds j = frequency(i); slot pad(j), read back
    # at j = t + T r: natural order
    out = np.empty_like(buf)
    out[:, _frequency(m, np.arange(m))] = buf
    p = (np.conj(out) * np.float32(1.0 / m)).astype(np.complex64)
    return np.concatenate([p.real, p.imag], axis=-1).astype(np.float32)


def model_k6(a0r, a0i, a1r, a1i, p0, p1, v, mask, dp, mu1):
    """K6's radix order in f32: image from a0 (z0 = p0), fwd from a1 (z0 =
    p1), v' = xv_update on each position, then rfft_core on v'.  v is the
    f32 value of the stored carry."""
    image = model_irfft_row(a0r, a0i, p0)
    fwd = model_irfft_row(a1r, a1i, p1)
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
    mu1, c_out, c_diff = np.float32(mu1), np.float32(c_out), np.float32(c_in - c_out)
    xi = mu1 * fwd - v
    xdv = c_out + c_diff * mask
    vn = (mu1 * (xdv * (xi + mu1 * fwd + dp)) - xi).astype(np.float32)
    vwr, vwi = model_rfft_w(vn)
    return image, vn, vwr, vwi


def test_unpack_section_is_the_split_section_in_frequency_order():
    """The natural-order unpack factors are the split section's values,
    bit for bit, moved to the frequencies their positions hold."""
    for m in MODEL_MS:
        e, _, en = _table(m)
        n1, n2 = K.factors(m)
        pos = np.arange(m)
        freq = pos // n2 + n1 * (pos % n2)
        assert en.shape == (m,) and np.array_equal(en[freq], e)


@pytest.mark.parametrize("m", K.RADIX_LENGTHS)
def test_irfft_schedule_covers_the_row(m):
    """The split layout's slots, the gather's slots (f and its mirror) and
    the output exchange's slots are permutations inside one buffer of
    fft::smem_bytes; a warp's exchange writes land on distinct bank pairs
    but for the two lanes a 64-bit access serves anyway."""
    n1, n2 = K.factors(m)
    cap = max(m + m // 16, n1 * (n2 + 1))
    pos = np.arange(m)
    slots = (pos // n2) * (n2 + 1) + pos % n2
    freq = pos // n2 + n1 * (pos % n2)
    assert len(set(slots)) == m and slots.max() < cap
    assert np.array_equal(_split_slot(m, freq), slots)
    assert np.array_equal(np.sort(_split_slot(m, (m - pos) % m)), np.sort(slots))
    out = _pad(_frequency(m, np.arange(m)))
    assert len(set(out)) == m and out.max() < cap
    nt, r_last = m // K.RADIX, K.radix_plan(m)[-1]
    t = np.arange(nt)
    for i in range(K.RADIX // r_last):
        for c in range(r_last):
            j = _pad(_frequency(m, (t + nt * i) * r_last + c))
            for w0 in range(0, nt, 32):
                banks = np.bincount(j[w0:w0 + 32] % 16, minlength=16)
                assert banks.max() <= 2


@pytest.mark.parametrize("m", MODEL_MS)
def test_irfft_model_matches_pallas(interpret, m):
    rng = np.random.RandomState(50 + m.bit_length())
    zr, zi = (rng.randn(8, m).astype(np.float32) for _ in range(2))
    ref = np.asarray(pk2.irfft_w(jnp.asarray(zr), jnp.asarray(zi), block_rows=8))
    out = model_irfft_row(zr, zi)
    assert np.abs(out - ref).max() <= TOL_KERNEL * np.abs(ref).max()


@pytest.mark.parametrize("m", MODEL_MS)
def test_irfft_model_matches_plain(m):
    """The model against the port's plain version (the kernel's yardstick
    on the card), and the round trip through K1's model."""
    rng = np.random.RandomState(60 + m.bit_length())
    zr, zi = (rng.randn(6, m).astype(np.float32) for _ in range(2))
    ref = K.irfft_w_plain(torch.from_numpy(zr), torch.from_numpy(zi)).numpy()
    out = model_irfft_row(zr, zi)
    assert np.abs(out - ref).max() <= TOL_PLAIN * np.abs(ref).max()
    x = rng.randn(6, 2 * m).astype(np.float32)
    back = model_irfft_row(*model_rfft_w(x))
    assert np.abs(back - x).max() <= TOL_PLAIN * np.abs(x).max()


@pytest.mark.parametrize("io,v", [("f32", "f32"), ("bf16", "i16")])
@pytest.mark.parametrize("m", (64, 256))
def test_k6_model_matches_pallas(jax_modes, m, io, v):
    """K6's radix order against the Pallas kernel at 16 rows, data only
    inside the support mask and v of order mu1 (as the loop gives them);
    each output in its storage dtype within test_torch_modes' bounds."""
    jax_modes(io=io, v=v)
    rows, n = 16, 2 * m
    rng = np.random.RandomState(70 + m.bit_length())
    spec = [_pair(rng.randn(rows, m).astype(np.float32), io) for _ in range(4)]
    cols = [rng.randn(rows).astype(np.float32) for _ in range(4)]
    zcols = []
    for c in cols:
        z = np.zeros((rows, 128), np.float32)
        z[:, 0] = c
        zcols.append(jnp.asarray(z))
    mask_np = (rng.rand(rows, n) > 0.5).astype(np.float32)
    jm, tm = _pair(mask_np, io)
    jd, td = _pair(mask_np * rng.rand(rows, n).astype(np.float32), io)
    jv, tv = _pair(MU1 * rng.randn(rows, n).astype(np.float32), v, K._v_scale(MU1))
    ref = pk2.irfft_w_dual_state(*(j for j, _ in spec), *zcols, jv, jm, jd, MU1,
                                 with_sat=False)
    f32 = [t.float().numpy() for _, t in spec]
    vf = K._load_carry(tv, K._v_scale(MU1)).numpy()
    image, vn, vwr, vwi = model_k6(*f32, cols[0] + 1j * cols[1], cols[2] + 1j * cols[3], vf,
                                   tm.float().numpy(), td.float().numpy(), MU1)
    io_t = spec[0][1].dtype
    out = (torch.from_numpy(image).to(io_t), K.encode_v(torch.from_numpy(vn), MU1, tv.dtype),
           torch.from_numpy(vwr).to(io_t), torch.from_numpy(vwi).to(io_t))
    for a, r in zip(out, ref[:4]):
        _check(a, r)


def test_design_is_a_shape_rule():
    """K2 and K6 take K1's rule: the radix design for M a power of two
    from 64 to 4096, the split one for any other M; the CPU wrappers run
    the plain versions whatever the design."""
    assert K.irfft_w_design is K.rfft_w_design
    assert K.irfft_w_dual_state_design is K.rfft_w_design
    for m in K.RADIX_LENGTHS:
        assert K.irfft_w_design(m) == K.irfft_w_dual_state_design(m) == "radix"
    for m in (16, 27, 135, 192, 480, 768, 8192):
        assert K.irfft_w_design(m) == K.irfft_w_dual_state_design(m) == "split"
    rng = np.random.RandomState(7)
    zr, zi = (torch.from_numpy(rng.randn(3, 192).astype(np.float32)) for _ in range(2))
    assert torch.equal(K.irfft_w(zr, zi), K.irfft_w_plain(zr, zi))
