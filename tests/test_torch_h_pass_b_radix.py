"""K15's and K17's radix design (csrc/h_pass_b.cu on the column form of
csrc/lpt_fft.cuh) modelled on the CPU.

K15 ``h_passB`` and K17 ``h_passB_dual`` run length-n2 transforms down
each column (k1, lane) of the (n1, n2, W) view.  Their radix design takes
n2 = 128 (``kernels.h_pass_b_design``, K5's rule) and runs K5's column
transforms without the combine:

- K15 forward: register r of thread t loads the natural row j2 = t + 8 r
  (times the filter at that row, with one), ``col_fft``, and register
  8 i + c is stored to the row of the frequency it holds,
  ``frequency(t + 8 i, c)``: natural order out, no second exchange.
- K15 inverse: register 8 i + c loads the row of that frequency (times the
  filter there), ``col_ifft`` (unscaled), register r is stored to the row
  j2 = t + 8 r.
- K17: K15's inverse of y and, from the same loads, of H y (H read at the
  same rows, the product in f32 in the JAX order).

The model is held to the JAX package's ``h_passB`` / ``h_passB_dual`` in
interpret mode and to the port's plain versions, so a row, order or
twiddle mistake shows here before the kernels reach a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from test_torch_h_radix import (BF16_ULP, HEIGHTS, IO, LANES, N2, TOL_FLIP_SHARE, TOL_FLOOR,
                                TOL_KERNEL, TOL_PLAIN, _h_table, _twiddles, col_fft, col_ifft)
from test_torch_rfft_radix import _frequency

# K15's forms: (inverse, with the filter)
FORMS = {"forward": (False, False), "inverse": (True, False), "filter": (False, True),
         "inverse_filter": (True, True)}
STACK = (2, 1)               # P planes over Pc constant planes


@pytest.fixture
def jax_io(monkeypatch):
    """Pallas in interpret mode; returns a setter of the JAX package's io
    dtype, which its kernels read at call time."""
    pk2._set_interpret(True)
    try:
        yield lambda io: monkeypatch.setattr(pk2, "_IO_DTYPE", IO[io][0])
    finally:
        pk2._set_interpret(False)


def _cols(x):
    """(..., n1, n2, W) -> (..., n1, W, n2): one column a lane."""
    return np.swapaxes(x, -1, -2)


def _tile(c, lead):
    """A constant stack (Pc, ...) -> the P planes' (plane p reads p % Pc)."""
    return c[np.arange(lead[0]) % c.shape[0]] if lead else c


def model_h_pass_b(yr, yi, h, inverse, fr=None, fi=None):
    """K15's radix design on (..., n1, n2, W) f32 views, the filter (fr,
    fi) a plane or a stack of Pc broadcast over the P planes -> (zr, zi),
    f32 as the kernel computes them."""
    n2 = K.factors(h)[1]
    tw = _twiddles(h)
    k2 = _frequency(n2, np.arange(n2))       # the frequency of each storage index
    rows = k2 if inverse else np.arange(n2)  # the row each storage index loads
    y_r, y_i = _cols(yr)[..., rows], _cols(yi)[..., rows]
    if fr is not None:
        f_r, f_i = (_cols(_tile(c, yr.shape[:-3]))[..., rows] for c in (fr, fi))
        y_r, y_i = y_r * f_r - y_i * f_i, y_r * f_i + y_i * f_r
    z = (y_r + 1j * y_i).astype(np.complex64)
    if inverse:
        out = col_ifft(z, tw)                # natural order j2 = t + 8 r
    else:
        out = np.empty_like(z)
        out[..., k2] = col_fft(z, tw)        # each register to its frequency's row
    return tuple(np.ascontiguousarray(_cols(p)).astype(np.float32) for p in (out.real, out.imag))


def model_h_pass_b_dual(yr, yi, hr, hi, h):
    """K17's radix design: K15's inverse of y and of H y from the same
    rows -> (a0r, a0i, a1r, a1i)."""
    return (*model_h_pass_b(yr, yi, h, True), *model_h_pass_b(yr, yi, h, True, hr, hi))


def _close(out, ref, tol):
    """An output plane against the reference in its dtype: f32 within
    ``tol`` of the plane's max; bf16 within one ulp plus TOL_FLOOR of the
    plane's max, at most TOL_FLIP_SHARE of the values not bit-equal."""
    a, b = out.float().numpy(), ref.float().numpy()
    d, top = np.abs(a - b), np.abs(b).max()
    if out.dtype == torch.bfloat16:
        assert (d <= BF16_ULP * np.abs(b) + TOL_FLOOR * top).all(), d.max() / top
        assert np.mean(d != 0) <= TOL_FLIP_SHARE
    else:
        assert d.max() <= tol * top, (d.max(), top)


def _planes(rng, n, lead, h, w, dtype):
    """n seeded (lead, n1, n2, W) planes, rounded to the io dtype, as f32
    numpy arrays."""
    n1, n2 = K.factors(h)
    return [torch.from_numpy(rng.randn(*lead, n1, n2, w).astype(np.float32)).to(dtype)
            .float().numpy() for _ in range(n)]


def _to(dtype, outs):
    return [torch.from_numpy(o).to(dtype) for o in outs]


def test_model_against_float64():
    """The forward model is the length-128 DFT of each column in natural
    order, the inverse the unscaled inverse, with and without the filter."""
    rng = np.random.RandomState(4)
    yr, yi, fr, fi = _planes(rng, 4, (), 256, 24, torch.float32)
    y = (yr + 1j * yi).astype(np.complex128)
    f = (fr + 1j * fi).astype(np.complex128)
    want = {"forward": np.fft.fft(y, axis=-2), "inverse": N2 * np.fft.ifft(y, axis=-2),
            "filter": np.fft.fft(y * f, axis=-2),
            "inverse_filter": N2 * np.fft.ifft(y * f, axis=-2)}
    for form, (inverse, filt) in FORMS.items():
        zr, zi = model_h_pass_b(yr, yi, 256, inverse, *((fr, fi) if filt else ()))
        ref = want[form]
        assert np.abs(zr + 1j * zi - ref).max() <= TOL_PLAIN * np.abs(ref).max(), form


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("w", LANES)
@pytest.mark.parametrize("h", HEIGHTS)
def test_k15_model_matches_pallas(jax_io, h, w, io):
    """Every form of K15 (forward, inverse, each with and without the
    filter) against the JAX package's h_passB on the same io values."""
    jax_io(io)
    dtype = IO[io][1]
    rng = np.random.RandomState(h + w)
    yr, yi, fr, fi = _planes(rng, 4, (), h, w, dtype)
    for form, (inverse, filt) in FORMS.items():
        f = (fr, fi) if filt else ()
        jy, jf = ([jnp.asarray(p, IO[io][0]) for p in ps] for ps in ((yr, yi), f))
        ref = pk2.h_passB(*jy, h, inverse, *jf)
        out = _to(dtype, model_h_pass_b(yr, yi, h, inverse, *f))
        for o, r in zip(out, ref):
            _close(o, torch.from_numpy(np.array(r, np.float32)).to(dtype), TOL_KERNEL)


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("w", LANES)
@pytest.mark.parametrize("h", HEIGHTS)
def test_k17_model_matches_pallas(jax_io, h, w, io):
    jax_io(io)
    dtype = IO[io][1]
    rng = np.random.RandomState(2 * h + w)
    planes = _planes(rng, 4, (), h, w, dtype)
    ref = pk2.h_passB_dual(*(jnp.asarray(p, IO[io][0]) for p in planes), h)
    out = _to(dtype, model_h_pass_b_dual(*planes, h))
    for o, r in zip(out, ref):
        _close(o, torch.from_numpy(np.array(r, np.float32)).to(dtype), TOL_KERNEL)


@pytest.mark.parametrize("w", LANES)
@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_model_matches_plain(io, w):
    """Every form of K15, and K17, on a stack of 2 planes over 1 constant
    plane against the port's plain versions (the kernels' yardstick on the
    card)."""
    dtype = IO[io][1]
    rng = np.random.RandomState(70 + w)
    h = HEIGHTS[-1]
    yr, yi = _planes(rng, 2, STACK[:1], h, w, dtype)
    fr, fi = _planes(rng, 2, STACK[1:], h, w, dtype)
    t = [torch.from_numpy(p).to(dtype) for p in (yr, yi, fr, fi)]
    for inverse, filt in FORMS.values():
        f = (fr, fi) if filt else ()
        ref = K.h_passB_plain(*t[:2], h, inverse, *(t[2:] if filt else ()))
        for o, r in zip(_to(dtype, model_h_pass_b(yr, yi, h, inverse, *f)), ref):
            _close(o, r, TOL_PLAIN)
    ref = K.h_passB_dual_plain(*t, h)
    for o, r in zip(_to(dtype, model_h_pass_b_dual(yr, yi, fr, fi, h)), ref):
        _close(o, r, TOL_PLAIN)


def test_design_is_k5s_shape_rule():
    """n2 = 128 takes the radix design, any other n2 the split one, by
    K5's rule; the CPU wrappers run the plain versions whatever the
    design."""
    assert K.h_pass_b_design is K.h_combine_dual_design
    for h in HEIGHTS + (6144, 1024, 128):
        assert K.h_pass_b_design(K.factors(h)[1]) == "radix"
    for n2 in (8, 20, 4, 16, 64, 256, 120):
        assert K.h_pass_b_design(n2) == "split"
    rng = np.random.RandomState(8)
    t = [torch.from_numpy(rng.randn(2, 128, 40).astype(np.float32)) for _ in range(4)]
    for inverse, filt in FORMS.values():
        f = t[2:] if filt else ()
        for a, b in zip(K.h_passB(*t[:2], 256, inverse, *f),
                        K.h_passB_plain(*t[:2], 256, inverse, *f)):
            assert torch.equal(a, b)
    for a, b in zip(K.h_passB_dual(*t, 256), K.h_passB_dual_plain(*t, 256)):
        assert torch.equal(a, b)


def test_c_entries_take_the_same_rule():
    """``lpt_h_pass_b`` and ``lpt_h_pass_b_dual`` run the radix design for
    n2 == RN2 alone, and RN2 is ``kernels.H_RADIX_N2``: the rules cannot
    drift apart (a radix launch on a split-only table would read past its
    end).  K16's and K18's entries take the same branch
    (tests/test_torch_h_combine_radix.py)."""
    src = (Path(K.__file__).parent / "csrc" / "h_pass_b.cu").read_text()
    assert re.findall(r"constexpr int RN2 = (\d+);", src) == [str(K.H_RADIX_N2)]
    assert re.findall(r"if \(n2 == (\w+)\) return (run_radix_\w+)<T", src) == [
        ("RN2", "run_radix_b"), ("RN2", "run_radix_dual"), ("RN2", "run_radix_combine")]

    def entry(name):
        body = src[src.index(f'extern "C" int {name}('):]
        return body[:body.index("\n}\n")]

    assert set(re.findall(r"return (\w+)<", entry("lpt_h_pass_b"))) == {"run_b"}
    assert set(re.findall(r"return (\w+)<", entry("lpt_h_pass_b_dual"))) == {"run_dual"}
    for name in ("lpt_h_pass_b_combine", "lpt_h_pass_b_combine2"):
        assert set(re.findall(r"return (\w+)<", entry(name))) == {"run_combine"}


@pytest.mark.parametrize("h", (96, 540) + HEIGHTS + (6144,))
def test_table_keeps_the_split_table_as_prefix(h):
    """The table K15 and K17 get extends the split design's by the radix
    twiddles of n2 (K5's table), so the C entry's argument reads the same
    constants for either design; a split n2 gets the split table alone."""
    n2 = K.factors(h)[1]
    t = K._design_table(h, False, K.h_pass_b_design(n2), torch.device("cpu"), radix_n=n2)
    full = torch.view_as_complex(t).numpy()
    base = K._table_np(h, False)
    assert np.array_equal(full[:base.size], base)
    tail = K._radix_twiddles_np(n2) if K.h_pass_b_design(n2) == "radix" else base[:0]
    assert np.array_equal(full[base.size:], tail)
    assert np.array_equal(full, _h_table(h))


@pytest.mark.parametrize("h,w", [(768, 64), (768, 40), (96, 40), (6144, 32)])
def test_card_path_passes_the_design_table(monkeypatch, h, w):
    """On the card K15, K16, K17 and K18 get the table of the design the
    shape rule names, each with (n1, n2, W) beside it."""
    launched = []

    def on_card(name, tensors, combo, built, cols=()):
        assert combo in built
        return True

    monkeypatch.setattr(K, "_on_card", on_card)
    monkeypatch.setattr(K, "_launch", lambda lib, fn, sig, *args: launched.append((fn, args)))
    n1, n2 = K.factors(h)
    p = [torch.zeros(n1, n2, w) for _ in range(7)]
    K.h_passB(*p[:2], h, False)
    K.h_passB(*p[:2], h, True, *p[2:4])
    K.h_passB_dual(*p[:4], h)
    K.h_passB_combine(*p, h)
    K.h_passB_combine2(*p, h)
    assert [fn for fn, _ in launched] == ["lpt_h_pass_b"] * 2 + [
        "lpt_h_pass_b_dual", "lpt_h_pass_b_combine", "lpt_h_pass_b_combine2"]
    for fn, args in launched:
        at = 6 if fn == "lpt_h_pass_b" else 8 if fn == "lpt_h_pass_b_dual" else 9
        tab = torch.view_as_complex(args[at]).numpy()
        assert np.array_equal(tab, _h_table(h)), fn
        assert list(args[at + 1:at + 6]) == [1, 1, n1, n2, w], fn


def test_smoke_run_names_and_holds_k15_k17_designs():
    """chip_smoke.py's K15 and K17 rows carry the design the shape rule
    names: the radix design at 12 MP, 768 x 1024, the guarded tile (the
    full width 80, not a multiple of the 32-lane tile) and the odd lane
    width 79, the split design
    at the pallas check's 96 x 512 grid and GRIDS' others (K16 and K18
    alike, tests/test_torch_h_combine_radix.py); its guarded-tile
    check holds every form of K15 and K17 that its pallas cases give, and
    the odd lane width where K15 takes one column a thread at bf16 too."""
    import chip_smoke as cs
    for name in ("h_passB", "h_passB:inverse_filter", "h_passB_dual"):
        for ph, pw in ((6144, 8192), (768, 1024), cs.K5_GUARDED, cs.K15_ODD_W):
            assert cs.design(name, ph, pw) == {"design": "radix"}, (name, ph)
        for ph, pw in ((2 * cs.SMALL_SPLIT[0], 2 * cs.SMALL_SPLIT[1]), (540, 960), (480, 640),
                       (96, 270)):
            assert cs.design(name, ph, pw) == {"design": "split"}, (name, ph)
    assert cs.K5_GUARDED[1] % 32 and cs.K15_ODD_W[1] % 2
    for name in ("h_passB_combine", "h_passB_combine2"):
        assert cs.design(name, 6144, 8192) == {"design": "radix"}
    gen = torch.Generator().manual_seed(5)
    cases = cs.pallas_kernel_cases(*cs.K5_GUARDED, gen, torch.float32, planes=cs.PLANES)
    forms = {n for n in cases if n.split(":")[0] in ("h_passB", "h_passB_dual")}
    assert forms == set(cs.K15_K17_FORMS)
    for name in cs.K15_K17_FORMS:
        args, flops = cases[name]
        assert tuple(args[0].shape) == (cs.PLANES[0],) + K.factors(cs.K5_GUARDED[0]) + (
            cs.K5_GUARDED[1],) and flops > 0
        fn = name.split(":")[0]
        for a, b in zip(cs.flatten(getattr(K, fn)(*args)),
                        cs.flatten(getattr(K, fn + "_plain")(*args))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["h_passB", "h_passB:inverse", "h_passB:filter",
                                  "h_passB:inverse_filter"])
def test_smoke_library_call_is_k15s_function(form):
    """chip_smoke.py's ``library_ms`` for K15 times one PyTorch call that
    computes the kernel's own function (the length-n2 DFT along n2; the
    inverse unscaled, its 1/n being stage 1's), equal to the plain version
    on the same inputs; the filtered forms, a product before the DFT, have
    no such call."""
    import chip_smoke as cs
    gen = torch.Generator().manual_seed(6)
    args, _ = cs.pallas_kernel_cases(*cs.K5_GUARDED, gen, torch.float32)[form]
    call = cs.library_call(form, args)
    if "filter" in form:
        assert call is None
        return
    z = call()
    zr, zi = K.h_passB_plain(*args)
    _close(z.real.contiguous(), zr, TOL_PLAIN)
    _close(z.imag.contiguous(), zi, TOL_PLAIN)
