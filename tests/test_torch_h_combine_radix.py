"""K16's and K18's radix design (csrc/h_pass_b.cu on the column form of
csrc/lpt_fft.cuh) modelled on the CPU.

K16 ``h_passB_combine`` and K18 ``h_passB_combine2`` run length-n2
forward transforms down each column (k1, lane) of the (n1, n2, W) view
and combine the spectra, F = R (a + conj(H) b).  Their radix design takes
n2 = 128 (``kernels.h_pass_b_design``, K5's rule) and combines on the
registers, as K5's radix design does:

- K16: register r of thread t loads the natural row j2 = t + 8 r of y,
  ``col_fft`` gives b, and register 8 i + c, which holds the frequency
  k2 = ``frequency(t + 8 i, c)``, reads a, H and R at row k2, forms F
  there in f32 in the JAX order and stores it to row k2.
- K18: K5's first half, ``col_fft`` of x (a) and of y (b) from the
  natural rows, then the same combine at the digit rows, H and R read
  there: a is never stored.

The model is held to the JAX package's ``h_passB_combine`` and to the
kernel of its ``fft_h_combine2`` (``_h_passB_combine2_kernel``, on the
stage-1 planes that ``fft_h_combine2`` gives it) in interpret mode, and to
the port's plain versions, with H and R drawn at random down each column
(a combine read at the natural rows instead of the digit rows fails
here), so a row, order or twiddle mistake shows before the kernels reach
a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from test_torch_h_pass_b_radix import STACK, _close, _cols, _planes, _tile, _to, jax_io  # noqa: F401
from test_torch_h_radix import (HEIGHTS, IO, LANES, N2, TOL_KERNEL, TOL_PLAIN, _h_table,
                                _twiddles, col_fft)
from test_torch_rfft_radix import _frequency

NAMES = ("h_passB_combine", "h_passB_combine2")


def _combine_at_digit_rows(a, b, hr, hi, rr, lead):
    """F = R (a + conj(H) b) in f32 in the JAX order on storage-order
    spectra (..., n1, W, n2), H and R (a plane or a stack of Pc) read at
    the frequency each storage index holds; F stored to that frequency's
    row -> (fr, fi) (..., n1, n2, W)."""
    n2 = a.shape[-1]
    k2 = _frequency(n2, np.arange(n2))
    h_r, h_i, r = (_cols(_tile(c, lead))[..., k2] for c in (hr, hi, rr))
    fr = r * (a.real + h_r * b.real + h_i * b.imag)
    fi = r * (a.imag + h_r * b.imag - h_i * b.real)
    out = np.empty(fr.shape, np.complex64)
    out[..., k2] = fr + 1j * fi
    return tuple(np.ascontiguousarray(_cols(p)).astype(np.float32) for p in (out.real, out.imag))


def model_h_pass_b_combine(yr, yi, ar, ai, hr, hi, rr, h):
    """K16's radix design on (..., n1, n2, W) f32 views -> (fr, fi)."""
    tw = _twiddles(h)
    n2 = K.factors(h)[1]
    k2 = _frequency(n2, np.arange(n2))
    b = col_fft((_cols(yr) + 1j * _cols(yi)).astype(np.complex64), tw)
    a = (_cols(ar)[..., k2] + 1j * _cols(ai)[..., k2]).astype(np.complex64)  # a at the digit rows
    return _combine_at_digit_rows(a, b, hr, hi, rr, yr.shape[:-3])


def model_h_pass_b_combine2(xr, xi, yr, yi, hr, hi, rr, h):
    """K18's radix design on (..., n1, n2, W) f32 views -> (fr, fi)."""
    tw = _twiddles(h)
    a = col_fft((_cols(xr) + 1j * _cols(xi)).astype(np.complex64), tw)
    b = col_fft((_cols(yr) + 1j * _cols(yi)).astype(np.complex64), tw)
    return _combine_at_digit_rows(a, b, hr, hi, rr, xr.shape[:-3])


MODELS = {"h_passB_combine": model_h_pass_b_combine,
          "h_passB_combine2": model_h_pass_b_combine2}


def _filters(rng, lead, h, w, dtype):
    """H (r, i) at random and R in (0, 1), positive as the solver's R =
    1 / (...), rounded to the io dtype."""
    hr, hi = _planes(rng, 2, lead, h, w, dtype)
    n1, n2 = K.factors(h)
    r = torch.from_numpy(rng.rand(*lead, n1, n2, w).astype(np.float32)).to(dtype).float().numpy()
    return [hr, hi, r]


def test_models_against_float64():
    """K16's model (y, a, H, R) is R (a + conj(H) F2 y) down each column
    in natural order, K18's (x, y, H, R) R (F2 x + conj(H) F2 y), against
    float64 np.fft."""
    rng = np.random.RandomState(11)
    p1r, p1i, p2r, p2i = _planes(rng, 4, (), 256, 24, torch.float32)
    hr, hi, rr = _filters(rng, (), 256, 24, torch.float32)
    p1 = (p1r + 1j * p1i).astype(np.complex128)
    p2 = (p2r + 1j * p2i).astype(np.complex128)
    hc = (hr - 1j * hi).astype(np.complex128)
    want = {"h_passB_combine": rr * (p2 + hc * np.fft.fft(p1, axis=-2)),
            "h_passB_combine2": rr * (np.fft.fft(p1, axis=-2) + hc * np.fft.fft(p2, axis=-2))}
    for name, model in MODELS.items():
        fr, fi = model(p1r, p1i, p2r, p2i, hr, hi, rr, 256)
        ref = want[name]
        assert np.abs(fr + 1j * fi - ref).max() <= TOL_PLAIN * np.abs(ref).max(), name


def test_combine_at_the_natural_rows_is_wrong():
    """H and R read at the natural rows instead of the frequency rows
    give another F: the filters' draw sees a row mistake."""
    rng = np.random.RandomState(12)
    yr, yi, ar, ai = _planes(rng, 4, (), 256, 8, torch.float32)
    hr, hi, rr = _filters(rng, (), 256, 8, torch.float32)
    fr, _ = model_h_pass_b_combine(yr, yi, ar, ai, hr, hi, rr, 256)
    b = col_fft((_cols(yr) + 1j * _cols(yi)).astype(np.complex64), _twiddles(256))
    k2 = _frequency(N2, np.arange(N2))
    wrong = _cols(rr) * (_cols(ar)[..., k2] + _cols(hr) * b.real + _cols(hi) * b.imag)
    out = np.empty_like(wrong)
    out[..., k2] = wrong
    assert np.abs(_cols(out) - fr).max() > 0.1 * np.abs(fr).max()


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("w", LANES)
@pytest.mark.parametrize("h", HEIGHTS)
def test_k16_model_matches_pallas(jax_io, h, w, io):
    jax_io(io)
    dtype = IO[io][1]
    rng = np.random.RandomState(3 * h + w)
    planes = _planes(rng, 4, (), h, w, dtype) + _filters(rng, (), h, w, dtype)
    ref = pk2.h_passB_combine(*(jnp.asarray(p, IO[io][0]) for p in planes), h)
    out = _to(dtype, model_h_pass_b_combine(*planes, h))
    for o, r in zip(out, ref):
        _close(o, torch.from_numpy(np.array(r, np.float32)).to(dtype), TOL_KERNEL)


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("w", LANES)
@pytest.mark.parametrize("h", HEIGHTS)
def test_k18_model_matches_pallas(jax_io, h, w, io):
    """K18's model on the stage-1 planes of rk and v (the JAX package's
    h_passA, as fft_h_combine2 runs it) against fft_h_combine2, whose
    kernel ``_h_passB_combine2_kernel`` takes those same planes."""
    jax_io(io)
    jt, dtype = IO[io]
    n1, n2 = K.factors(h)
    rng = np.random.RandomState(4 * h + w)
    rkr, rki, vr, vi = (rng.randn(h, w).astype(np.float32) for _ in range(4))
    hr, hi, rr = _filters(rng, (), h, w, dtype)
    J = [jnp.asarray(p, jt) for p in (rkr, rki, vr, vi)]
    C = [jnp.asarray(c.reshape(h, w), jt) for c in (hr, hi, rr)]
    ref = pk2.fft_h_combine2(*J, *C, h)
    xa = pk2.h_passA(J[0].reshape(n1, n2, w), J[1].reshape(n1, n2, w), h, False)
    ya = pk2.h_passA(J[2].reshape(n1, n2, w), J[3].reshape(n1, n2, w), h, False)
    stage1 = [np.array(p, np.float32) for p in (*xa, *ya)]
    out = _to(dtype, model_h_pass_b_combine2(*stage1, hr, hi, rr, h))
    for o, r in zip(out, ref):
        _close(o.reshape(h, w), torch.from_numpy(np.array(r, np.float32)).to(dtype), TOL_KERNEL)


@pytest.mark.parametrize("w", LANES)
@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_models_match_plain(io, w):
    """Both models on a stack of 2 planes over 1 constant plane against
    the port's plain versions (the kernels' yardstick on the card)."""
    dtype = IO[io][1]
    rng = np.random.RandomState(90 + w)
    h = HEIGHTS[-1]
    planes = _planes(rng, 4, STACK[:1], h, w, dtype) + _filters(rng, STACK[1:], h, w, dtype)
    t = [torch.from_numpy(p).to(dtype) for p in planes]
    for name, model in MODELS.items():
        ref = getattr(K, name + "_plain")(*t, h)
        for o, r in zip(_to(dtype, model(*planes, h)), ref):
            _close(o, r, TOL_PLAIN)


def test_design_is_k5s_shape_rule():
    """K16 and K18 take K15's rule (n2 = 128 radix, any other n2 split);
    the CPU wrappers run the plain versions whatever the design."""
    for h in HEIGHTS + (6144, 1024, 128):
        assert K.h_pass_b_design(K.factors(h)[1]) == "radix"
    for h in (96, 540, 480, 192):
        assert K.h_pass_b_design(K.factors(h)[1]) == "split"
    rng = np.random.RandomState(13)
    t = [torch.from_numpy(rng.randn(2, 128, 40).astype(np.float32)) for _ in range(7)]
    for name in NAMES:
        for a, b in zip(getattr(K, name)(*t, 256), getattr(K, name + "_plain")(*t, 256)):
            assert torch.equal(a, b)


def test_c_entries_take_the_same_rule():
    """``lpt_h_pass_b_combine`` (K16) and ``lpt_h_pass_b_combine2`` (K18)
    run the radix design for n2 == RN2 alone (RN2 =
    ``kernels.H_RADIX_N2``), the split kernel otherwise, each in both io
    types; K16's radix design takes K15's columns a thread (two at bf16 io
    where W is even), K18's one."""
    src = (Path(K.__file__).parent / "csrc" / "h_pass_b.cu").read_text()

    def body(head):
        b = src[src.index(head):]
        return b[:b.index("\n}\n")]

    assert re.findall(r"constexpr int RN2 = (\d+);", src) == [str(K.H_RADIX_N2)]
    run = body("static int run_combine(")
    assert re.findall(r"if \(n2 == (\w+)\) return (\w+)<T, kTwo>", run) == [
        ("RN2", "run_radix_combine")]
    assert set(re.findall(r"(h_pass_b_\w+_kernel)<T", run)) == {
        "h_pass_b_combine_kernel", "h_pass_b_combine2_kernel"}
    radix = body("static int run_radix_combine(")
    assert "if constexpr (!kTwo && k15_lanes<T>() == 2)" in radix and "if (w % 2 == 0)" in radix
    assert re.findall(r"return run_radix_combine_lanes<T, kTwo, (\d)>", radix) == ["2", "1"]
    assert "constexpr int k15_lanes() { return sizeof(T) == 2 ? 2 : 1; }" in src
    pick = body("static auto combine_radix_kernel(")
    assert re.findall(r"if constexpr \(kTwo\) return (\w+)<", pick) == [
        "h_pass_b_combine2_radix_kernel"]
    assert re.findall(r"else return (\w+)<", pick) == ["h_pass_b_combine_radix_kernel"]
    for entry, two in (("lpt_h_pass_b_combine", "false"), ("lpt_h_pass_b_combine2", "true")):
        calls = re.findall(r"return run_combine<(\w+), (\w+)>", body(f'extern "C" int {entry}('))
        assert calls == [("float", two), ("__nv_bfloat16", two)], entry


@pytest.mark.parametrize("h,w", [(768, 64), (768, 40), (96, 40), (6144, 32), (540, 30)])
def test_card_path_passes_the_design_table(monkeypatch, h, w):
    """On the card K16 and K18 get the table of the design the shape rule
    names (the split table, then the radix twiddles of n2 = 128), with
    (planes, Pc, n1, n2, W) beside it."""
    launched = []

    def on_card(name, tensors, combo, built, cols=()):
        assert combo in built
        return True

    monkeypatch.setattr(K, "_on_card", on_card)
    monkeypatch.setattr(K, "_launch", lambda lib, fn, sig, *args: launched.append((fn, args)))
    n1, n2 = K.factors(h)
    p = [torch.zeros(3, n1, n2, w) for _ in range(4)] + [torch.zeros(n1, n2, w)] * 3
    for name in NAMES:
        getattr(K, name)(*p, h)
    assert [fn for fn, _ in launched] == ["lpt_h_pass_b_combine", "lpt_h_pass_b_combine2"]
    for fn, args in launched:
        tab = torch.view_as_complex(args[9]).numpy()
        assert np.array_equal(tab, _h_table(h)), fn
        assert tab.size > K._table_np(h, False).size or K.h_pass_b_design(n2) == "split"
        assert list(args[10:15]) == [3, 1, n1, n2, w], fn


def test_smoke_run_names_and_holds_k16_k18_designs():
    """chip_smoke.py's K16 and K18 rows carry the design the shape rule
    names: radix at 12 MP, 768 x 1024, the guarded tile (the full width
    80) and the odd lane width 79, split at the 96 x 512 grid and GRIDS'
    others; its guarded-tile check runs both beside K15's and K17's
    forms, on the shapes the pallas loop gives them."""
    import chip_smoke as cs
    assert set(cs.K16_K18_FORMS) == set(NAMES)
    for name in NAMES:
        for ph, pw in ((6144, 8192), (768, 1024), cs.K5_GUARDED, cs.K15_ODD_W):
            assert cs.design(name, ph, pw) == {"design": "radix"}, (name, ph)
        for ph, pw in ((2 * cs.SMALL_SPLIT[0], 2 * cs.SMALL_SPLIT[1]), (540, 960), (480, 640),
                       (96, 270)):
            assert cs.design(name, ph, pw) == {"design": "split"}, (name, ph)
    gen = torch.Generator().manual_seed(7)
    for planes in (None, cs.PLANES):
        cases = cs.pallas_kernel_cases(*cs.K5_GUARDED, gen, torch.float32, planes=planes)
        lead = (cs.PLANES[0],) if planes else ()
        for name in cs.K16_K18_FORMS:
            args, flops = cases[name]
            assert tuple(args[0].shape) == lead + K.factors(cs.K5_GUARDED[0]) + (
                cs.K5_GUARDED[1],) and flops > 0
            assert tuple(args[4].shape[-3:]) == tuple(args[0].shape[-3:])
            for a, b in zip(getattr(K, name)(*args), getattr(K, name + "_plain")(*args)):
                assert torch.equal(a, b)
