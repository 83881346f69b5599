"""K5's radix design (csrc/lpt_fft.cuh, the column form) modelled on the CPU.

K5 ``h_combine_dual`` views its planes (n1, n2, W) and runs four length-n2
transforms down each column (k1, lane).  Its radix design takes n2 = 128
(``kernels.h_combine_dual_design``): each column is one transform of
Plan<128>, 8 threads, the passes of K1's row FFT (radix 16, then 8) with
the same thread-to-position maps and f32 twiddle table, but the positions
run down the column (row j2 of the view) instead of along a row.

- Forward (xa, then ya): pass 0 reads j2 = t + 8 r from device memory,
  one exchange, pass 1; each register then holds the frequency of its
  storage index in the final digit order (``_frequency``).
- The combine on the registers: H and R loaded at each register's own
  k2, F = R (A + conj(H) B), F1 = H F in f32.
- Inverse (F, then F1): the forward network transposed, in the
  conjugated domain: the last pass's DFTs first, one exchange, pass 0's
  twiddles then its DFTs, so that digit order goes in and natural order
  j2 = t + 8 r comes out, each register stored to its own row.

The model is held to the JAX package's ``fft_h_combine_dual`` in
interpret mode (K4's plain version on both sides of the model) and to
the port's plain version, so an index, order or twiddle mistake in the
schedule shows here before the kernel reaches a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from test_torch_rfft_radix import _dft_registers, _frequency, _passes, _positions

# f32: max |model - reference| / max |reference| per output plane (the
# bound chip_smoke.py holds the kernel to, and the plain version's own
# distance from the float64 transform is ~1e-6).  bf16 io, K5 alone: the
# storage modes' rule of tests/test_torch_modes.py (within one bf16 ulp
# plus 1e-5 of the plane's max, at most 1 % of the values not bit-equal).
# bf16 io, the K4 -> K5 -> K4 chain: a one-ulp flip of a K5 output spreads
# through K4's inverse over a column of outputs, most of them smaller, so
# the chain is held to one ulp of the plane's max, at most 1 % of the
# values not bit-equal (the plain version's chain against JAX is off by
# up to 0.21 % of the max at H = 768, W = 40, beyond the elementwise rule
# at 13 values)
TOL_KERNEL = 1e-4
TOL_PLAIN = 1e-5
BF16_ULP = 2.0 ** -7
TOL_FLOOR = 1e-5
TOL_FLIP_SHARE = 1e-2
N2 = 128
HEIGHTS = (256, 768)          # n1 = 2 and 6 over n2 = 128
# a lane count that fills the 32-lane tiles and one whose last tile is cut
LANES = (64, 40)
IO = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def jax_io(monkeypatch):
    """Pallas in interpret mode; returns a setter of the JAX package's io
    dtype, which its kernels read at call time."""
    pk2._set_interpret(True)
    try:
        yield lambda io: monkeypatch.setattr(pk2, "_IO_DTYPE", IO[io][0])
    finally:
        pk2._set_interpret(False)


def _h_table(h):
    """K5's constant table as complex64, as the wrapper passes it."""
    n2 = K.factors(h)[1]
    t = K._design_table(h, False, K.h_combine_dual_design(n2), torch.device("cpu"),
                        radix_n=n2)
    return torch.view_as_complex(t).numpy()


def _twiddles(h):
    """The radix twiddles the kernel reads: the table past the split
    design's [r1f | r2f | r1i | r2i | Tf | Ti]."""
    n1, n2 = K.factors(h)
    return _h_table(h)[2 * (n1 + n2) + 2 * h:]


def col_fft(cols, tw):
    """The forward column transform on (..., n2) complex64 columns, as the
    kernel's threads run it; returns the columns in storage order (index
    idx holds frequency ``_frequency(n2, idx)``)."""
    m = cols.shape[-1]
    buf = cols.astype(np.complex64).copy()
    for r, length, off in _passes(m):
        pos, u = _positions(m, r, length)
        v = _dft_registers(buf[..., pos])
        if off is not None:
            c = np.arange(1, r)[None, None, :]
            v[..., 1:] = v[..., 1:] * tw[off + (c - 1) * (length // r) + u]
        buf[..., pos] = v
    return buf


def col_ifft(spec, tw):
    """The unscaled inverse of storage-order spectra (..., n2), as the
    kernel runs it: the forward network transposed on conj(spec) (each
    pass from the last: pass 0's twiddles before its DFTs), then conj;
    natural order out."""
    m = spec.shape[-1]
    buf = np.conj(spec).astype(np.complex64)
    for r, length, off in reversed(_passes(m)):
        pos, u = _positions(m, r, length)
        v = buf[..., pos]
        if off is not None:
            c = np.arange(1, r)[None, None, :]
            v[..., 1:] = v[..., 1:] * tw[off + (c - 1) * (length // r) + u]
        buf[..., pos] = _dft_registers(v)
    return np.conj(buf)


def model_h_combine_dual(xar, xai, yar, yai, hr, hi, rr, h):
    """K5's radix design on (..., n1, n2, W) f32 views (the filter planes
    H and R a stack of Pc, broadcast over the P planes as plane p % Pc)
    -> (a0r, a0i, a1r, a1i), f32 as the kernel computes them."""
    n1, n2 = K.factors(h)
    tw = _twiddles(h)
    pl = xar.shape[:-3]

    def cols(x):               # (..., n1, n2, W) -> (..., n1, W, n2): one column a lane
        return np.swapaxes(x, -1, -2)

    def tile(c):               # filter stack -> the P planes' (plane p reads p % Pc)
        if not pl:
            return c
        pc = c.shape[0]
        return c[np.arange(pl[0]) % pc]

    a = col_fft(cols(xar) + 1j * cols(xai), tw)
    b = col_fft(cols(yar) + 1j * cols(yai), tw)
    # H and R at each register's own k2 (the frequency of its storage index)
    k2 = _frequency(n2, np.arange(n2))
    h_r, h_i, r = (cols(tile(c))[..., k2] for c in (hr, hi, rr))
    fr = r * (a.real + h_r * b.real + h_i * b.imag)
    fi = r * (a.imag + h_r * b.imag - h_i * b.real)
    f1r = fr * h_r - fi * h_i
    f1i = fr * h_i + fi * h_r
    g0 = col_ifft((fr + 1j * fi).astype(np.complex64), tw)
    g1 = col_ifft((f1r + 1j * f1i).astype(np.complex64), tw)
    return tuple(np.ascontiguousarray(cols(p)).astype(np.float32)
                 for g in (g0, g1) for p in (g.real, g.imag))


def model_fft_h_combine_dual(rkr, rki, vr, vi, hr, hi, rr, h, dtype=torch.float32):
    """``kernels.fft_h_combine_dual`` with K5 replaced by the model: K4's
    plain version forward, the model (on the io dtype's values, its
    outputs rounded to it), K4's plain version inverse."""
    n1, n2 = K.factors(h)

    def view(x):
        return torch.from_numpy(x).to(dtype).reshape(x.shape[:-2] + (n1, n2, x.shape[-1]))

    (xar, xai), (yar, yai) = K.h_passA_pair_plain(view(rkr), view(rki), view(vr), view(vi),
                                                  h, False)
    outs = model_h_combine_dual(*(t.float().numpy() for t in (xar, xai, yar, yai)),
                                *(view(c).float().numpy() for c in (hr, hi, rr)), h)
    a0r, a0i, a1r, a1i = (torch.from_numpy(o).to(dtype) for o in outs)
    (z0r, z0i), (z1r, z1i) = K.h_passA_pair_plain(a0r, a0i, a1r, a1i, h, True)
    return tuple(z.reshape(rkr.shape) for z in (z0r, z0i, z1r, z1i))


def _planes(rng, h, w):
    return [rng.randn(h, w).astype(np.float32) for _ in range(4)]


def _filters(rng, h, w):
    """H (r, i) and R (positive, as R = 1 / (...) in the solver)."""
    hr, hi = (rng.randn(h, w).astype(np.float32) for _ in range(2))
    return [hr, hi, rng.rand(h, w).astype(np.float32)]


def _close(out, ref, tol, chain=False):
    """An output plane against the reference in its dtype: f32 within
    ``tol`` of the plane's max; bf16 by the storage modes' rule, or with
    ``chain`` within one ulp of the plane's max (see TOL_KERNEL)."""
    a, b = out.float(), ref.float()
    d, top = (a - b).abs(), float(b.abs().max())
    if out.dtype == torch.bfloat16:
        near = d.max() <= BF16_ULP * top if chain else (d <= BF16_ULP * b.abs() + TOL_FLOOR * top).all()
        assert bool(near), float(d.max()) / top
        assert float((d != 0).float().mean()) <= TOL_FLIP_SHARE
    else:
        assert float(d.max()) <= tol * top, (float(d.max()), top)


def test_column_schedule_covers_the_column():
    """Plan<128>: two passes (radix 16, then 8) of 8 threads; each pass
    reads every position of a column once, pass 0 down the column at j2
    = t + 8 r, the last pass's storage indices give every frequency once."""
    assert K.radix_plan(N2) == (16, 8)
    for r, length, _ in _passes(N2):
        pos, _ = _positions(N2, r, length)
        assert pos.shape[0] == N2 // K.RADIX
        assert np.array_equal(np.sort(pos.reshape(-1)), np.arange(N2))
    pos0, _ = _positions(N2, 16, N2)
    t, r = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    assert np.array_equal(pos0[:, 0, :], t + 8 * r)
    # thread t's register 8 i + c holds storage index 8 (t + 8 i) + c and
    # frequency k2 = t + 8 i + 16 c (fft::frequency<128>)
    pos1, _ = _positions(N2, 8, 8)
    i, c = np.meshgrid(np.arange(2), np.arange(8), indexing="ij")
    for tt in range(8):
        assert np.array_equal(pos1[tt], 8 * (tt + 8 * i) + c)
        assert np.array_equal(_frequency(N2, pos1[tt]), tt + 8 * i + 16 * c)


def test_column_transforms_against_float64():
    """The forward schedule gives the DFT of each column at the frequency
    of each storage index, and the transposed one takes storage order back
    to natural order, unscaled (F2inv of the kernel's contract)."""
    rng = np.random.RandomState(3)
    x = (rng.randn(5, N2) + 1j * rng.randn(5, N2)).astype(np.complex64)
    tw = _twiddles(768)
    k = _frequency(N2, np.arange(N2))
    want = np.fft.fft(x.astype(np.complex128))[:, k]
    assert np.abs(col_fft(x, tw) - want).max() <= TOL_PLAIN * np.abs(want).max()
    back = col_ifft(col_fft(x, tw), tw)
    assert np.abs(back - N2 * x).max() <= TOL_PLAIN * N2 * np.abs(x).max()


def test_radix_twiddles_of_the_column():
    """The table's radix section is exp(-2 pi i u c / 128) from float64,
    rounded to f32, at entry (c - 1) 8 + u (pass 0: Q = 8 butterflies)."""
    tw = _twiddles(6144)
    c, u = np.meshgrid(np.arange(1, 16), np.arange(8), indexing="ij")
    want = np.exp(-2j * np.pi * (u * c).reshape(-1).astype(np.float64) / N2)
    assert tw.dtype == np.complex64 and np.array_equal(tw, want.astype(np.complex64))


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("w", LANES)
@pytest.mark.parametrize("h", HEIGHTS)
def test_model_matches_pallas(jax_io, h, w, io):
    jax_io(io)
    rng = np.random.RandomState(h + w)
    planes = _planes(rng, h, w) + _filters(rng, h, w)
    # both sides see the same io values
    dtype = IO[io][1]
    planes = [torch.from_numpy(p).to(dtype).float().numpy() for p in planes]
    ref = pk2.fft_h_combine_dual(*(jnp.asarray(p, IO[io][0]) for p in planes), h)
    out = model_fft_h_combine_dual(*planes, h, dtype=dtype)
    for o, r in zip(out, (ref[0][0], ref[0][1], ref[1][0], ref[1][1])):
        _close(o, torch.from_numpy(np.array(r, np.float32)).to(dtype), TOL_KERNEL, chain=True)


@pytest.mark.parametrize("w", LANES)
@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_model_matches_plain(io, w):
    """The model of K5 alone against the port's plain version on a stack
    of 4 planes over 2 filter planes (the plain version is the kernel's
    yardstick on the card)."""
    dtype = IO[io][1]
    rng = np.random.RandomState(50 + w)
    n1, n2 = K.factors(768)
    planes = [torch.from_numpy(rng.randn(4, n1, n2, w).astype(np.float32)).to(dtype)
              for _ in range(4)]
    filt = [torch.from_numpy(x.reshape(2, n1, n2, w)).to(dtype)
            for x in _filters(rng, 2 * n1 * n2, w)]
    ref = K.h_combine_dual_plain(*planes, *filt, 768)
    out = model_h_combine_dual(*(t.float().numpy() for t in planes + filt), 768)
    for o, r in zip(out, ref):
        _close(torch.from_numpy(o).to(dtype), r, TOL_PLAIN)


def test_design_is_a_shape_rule():
    """n2 = 128 takes the radix design; the 96-row and 540-row grids' n2
    (8 and 20) the split one, as any other n2; the CPU wrapper runs the
    plain version whatever the design."""
    assert K.h_combine_dual_design(128) == "radix"
    for h in HEIGHTS + (6144, 1024, 128):
        assert K.factors(h)[1] == 128 and K.h_combine_dual_design(K.factors(h)[1]) == "radix"
    assert (K.factors(96), K.factors(540)) == ((12, 8), (27, 20))
    for n2 in (8, 20, 4, 16, 64, 256, 120):
        assert K.h_combine_dual_design(n2) == "split"
    rng = np.random.RandomState(9)
    planes = [torch.from_numpy(rng.randn(2, 128, 40).astype(np.float32)) for _ in range(7)]
    for a, b in zip(K.h_combine_dual(*planes, 256), K.h_combine_dual_plain(*planes, 256)):
        assert torch.equal(a, b)


def test_c_entry_takes_the_same_rule():
    """``lpt_h_combine_dual`` runs the radix design for n2 == RN2 alone,
    and RN2 is ``kernels.H_RADIX_N2``: the two rules cannot drift apart
    (a radix launch on a split-only table would read past its end)."""
    src = (Path(K.__file__).parent / "csrc" / "h_combine.cu").read_text()
    rn2 = re.findall(r"constexpr int RN2 = (\d+);", src)
    assert rn2 == [str(K.H_RADIX_N2)]
    assert re.findall(r"if \(n2 == (\w+)\) return run_radix", src) == ["RN2"]


@pytest.mark.parametrize("h", (96, 540) + HEIGHTS + (6144,))
def test_table_keeps_the_split_table_as_prefix(h):
    """The radix table extends the split design's table by the radix
    twiddles of n2, so the C entry's argument reads the same constants
    for either design; a split n2 gets the split table alone."""
    full = _h_table(h)
    base = K._table_np(h, False)
    assert np.array_equal(full[:base.size], base)
    n2 = K.factors(h)[1]
    tail = K._radix_twiddles_np(n2) if K.h_combine_dual_design(n2) == "radix" else base[:0]
    assert np.array_equal(full[base.size:], tail)


@pytest.mark.parametrize("h,w", [(768, 64), (768, 40), (96, 40), (6144, 32)])
def test_card_path_passes_the_design_table(monkeypatch, h, w):
    """On the card the wrapper hands ``lpt_h_combine_dual`` the table of
    the design the shape rule names, with (n1, n2, W) beside it."""
    launched = []

    def on_card(name, tensors, combo, built, cols=()):
        assert combo in built
        return True

    monkeypatch.setattr(K, "_on_card", on_card)
    monkeypatch.setattr(K, "_launch", lambda lib, fn, sig, *args: launched.append((fn, args)))
    n1, n2 = K.factors(h)
    planes = [torch.zeros(n1, n2, w) for _ in range(7)]
    K.h_combine_dual(*planes, h)
    (fn, args), = launched
    assert fn == "lpt_h_combine_dual"
    tab = torch.view_as_complex(args[11]).numpy()
    assert np.array_equal(tab, _h_table(h))
    assert list(args[12:17]) == [1, 1, n1, n2, w]


def test_smoke_run_names_k5_designs():
    """chip_smoke.py's K5 rows carry the design the shape rule names: the
    radix design at 12 MP, 768 x 1024 and its guarded tile (a half width
    that is not a multiple of the 32-lane tile), the split design at the
    small grid and at GRIDS' other sensors."""
    import chip_smoke as cs
    for ph, pw in ((6144, 8192), (768, 1024), cs.K5_GUARDED):
        assert cs.design("h_combine_dual", ph, pw) == {"design": "radix"}
    assert (cs.K5_GUARDED[1] // 2) % 32
    for ph, pw in ((96, 128), (540, 960), (480, 640), (96, 270)):
        assert cs.design("h_combine_dual", ph, pw) == {"design": "split"}
    assert cs.design("rfft_w", 96, 384) == {"design": "split"}


@pytest.mark.parametrize("planes", [None, (4, 1)])
def test_smoke_run_holds_k5_at_the_full_width(planes):
    """chip_smoke.py's full-width cases hold K4 and K5 on the (n1, n2, W)
    view the full-width loop gives them, W the plane's width (the v3
    cases' is M = W / 2), alone and on a stack; K5's there is the radix
    design at n2 = 128 with a guarded lane tile at W = 80."""
    import chip_smoke as cs
    ph, pw = cs.K5_GUARDED
    gen = torch.Generator().manual_seed(3)
    cases = cs.split_kernel_cases(ph, pw, gen, *cs.SPLIT_MODES["f32"], planes=planes)
    lead = (planes[0],) if planes else ()
    for name in cs.FULL_WIDTH_H:
        args, flops = cases[name]
        assert tuple(args[0].shape) == lead + K.factors(ph) + (pw,) and flops > 0
    args, _ = cases["h_combine_dual:full_width"]
    assert cs.design("h_combine_dual", ph, pw) == {"design": "radix"} and pw % 32
    assert tuple(args[4].shape[-3:]) == K.factors(ph) + (pw,)
    for a, b in zip(K.h_combine_dual(*args), K.h_combine_dual_plain(*args)):
        assert torch.equal(a, b)
