"""K4's and K14's radix design (csrc/h_pass_a.cu on the length-48 pieces
of csrc/lpt_fft.cuh) modelled on the CPU.

K4 ``h_passA_pair`` and K14 ``h_passA`` view each plane (n1, n2, W) and
run one length-n1 DFT down each column (j2, lane).  Their radix design
takes n1 = 48 (``kernels.h_pass_a_design``), the 12 MP grid's H = 6144 =
48 x 128, as 3 x 16 with three threads a column: a block is RTW
consecutive lanes of one j2, thread t = (l, g) = (t % RTW, t // RTW).

- Load: thread (l, g) register j' holds position j1 = 3 j' + g.  The
  inverse multiplies it by T_inv[j1, j2] and conjugates it, so that the
  inverse DFT runs as the forward one.
- The thread's length-16 DFT (the in-register radix-2 DFT of the row
  FFT, ``fft::dft<16>``), the twiddle exp(-2 pi i g k' / 48) as an f32
  constant (``fft::mul_w48``), and a write to the buffer at [16 g + k'][l].
- After the barrier thread (l, c) forms frequency k1 = k' + 16 c from
  the three rows (``fft::radix3``) and stores it: the forward multiplied
  by T[k1, j2], the inverse conjugated and scaled by 1/n.

The model is held to float64 np.fft, to the JAX package's ``h_passA_pair``
and ``h_passA`` in interpret mode and to the port's plain versions, so an
index, order, root or twiddle mistake in the schedule shows here before
the kernel reaches a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from test_torch_rfft_radix import _dft_registers

# f32: max |model - reference| / max |reference| per output plane (the
# bound chip_smoke.py holds the kernel to).  bf16 io: the storage modes'
# rule of tests/test_torch_modes.py (within one bf16 ulp plus 1e-5 of the
# plane's max, at most 1 % of the values not bit-equal).  The column
# transform alone against float64: f32 round-off of a length-48 FFT.
TOL_KERNEL = 1e-4
TOL_F64 = 2e-6
BF16_ULP = 2.0 ** -7
TOL_FLOOR = 1e-5
TOL_FLIP_SHARE = 1e-2
N1 = 48
H = 6144                      # 48 x 128, the 12 MP grid's H
# a lane count of whole 32-lane warps and one whose last warp is cut
LANES = (64, 40)
IO = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CSRC = Path(K.__file__).parent / "csrc"
H3 = np.float32(0.86602540378443865)     # sin(2 pi / 3), the radix-3 constant


@pytest.fixture
def jax_io(monkeypatch):
    """Pallas in interpret mode; returns a setter of the JAX package's io
    dtype, which its kernels read at call time."""
    pk2._set_interpret(True)
    try:
        yield lambda io: monkeypatch.setattr(pk2, "_IO_DTYPE", IO[io][0])
    finally:
        pk2._set_interpret(False)


def _cos48():
    """The kernel's cos(2 pi q / 48), q = 0 .. 12 (``fft::cos48``), read
    from the source and rounded to f32 as nvcc rounds its literals."""
    src = (CSRC / "lpt_fft.cuh").read_text()
    body = src[src.index("float cos48(int q)"):]
    body = body[:body.index("default:")]
    vals = dict((int(q), np.float32(float(v))) for q, v in
                re.findall(r"case (\d+): return ([0-9.]+)f;", body))
    assert sorted(vals) == list(range(12))
    return np.array([vals[q] for q in range(12)] + [np.float32(0.0)], np.float32)


def _w48(m):
    """The root ``fft::mul_w48`` multiplies by, exp(-2 pi i m / 48), as
    complex64: a multiple of 3 a root of 16 (``mul_w16``'s f32 constants),
    any other cos48 (q) - i cos48 (12 - q) turned by m / 12 quarter turns."""
    m %= N1
    if m % 3 == 0:
        return np.complex64(np.exp(-2j * np.pi * (m // 3) / 16))
    c = _cos48()
    q = m % 12
    w = np.complex64(complex(c[q], -c[12 - q]))
    for _ in range(m // 12):
        w = np.complex64(complex(w.imag, -w.real))
    return w


def _load_positions():
    """(3, 16) column positions j1 = 3 j' + g of thread g's register j'."""
    g, jp = np.meshgrid(np.arange(3), np.arange(16), indexing="ij")
    return 3 * jp + g


def _buffer_rows():
    """(3, 16) buffer rows 16 g + k' that thread g writes its register k'
    to (one row of RTW lanes each)."""
    g, kp = np.meshgrid(np.arange(3), np.arange(16), indexing="ij")
    return 16 * g + kp


def _store_frequencies():
    """(3, 16) frequencies k1 = k' + 16 c that thread c stores, k' the
    buffer rows k', 16 + k', 32 + k' it reads."""
    c, kp = np.meshgrid(np.arange(3), np.arange(16), indexing="ij")
    return kp + 16 * c


def radix3(a, b, d, c):
    """``fft::radix3``: output c of the length-3 DFT of (a, b, d) in
    complex64, a + b + d or m -/+ i sin(2 pi / 3) t, m = a - (b + d) / 2,
    t = b - d."""
    s = b + d
    if c == 0:
        return a + s
    t = b - d
    m = a - np.float32(0.5) * s
    it = (1j * t).astype(np.complex64) * (H3 if c == 1 else -H3)
    return (m - it).astype(np.complex64)


def dft48(v):
    """The three threads of a column on (..., 3, 16) complex64 registers
    holding the positions of :func:`_load_positions` -> (..., 3, 16): the
    frequencies of :func:`_store_frequencies`, thread c's in row c."""
    y = _dft_registers(v.astype(np.complex64))
    for g in (1, 2):
        y[..., g, :] *= np.array([_w48(g * k) for k in range(16)], np.complex64)
    buf = np.empty(v.shape[:-2] + (48,), np.complex64)
    buf[..., _buffer_rows()] = y
    k = np.arange(16)
    return np.stack([radix3(buf[..., k], buf[..., 16 + k], buf[..., 32 + k], c)
                     for c in range(3)], axis=-2)


def _twiddles(h):
    """(T, T_inv), each (n1, n2) complex64, from the split table the
    wrapper passes (:func:`kernels._table`)."""
    n1, n2 = K.factors(h)
    tab = K._table_np(h, False)
    off = 2 * (n1 + n2)
    return tab[off:off + h].reshape(n1, n2), tab[off + h:off + 2 * h].reshape(n1, n2)


def model_h_passA(xr, xi, h, inverse):
    """One array of K4 / K14 in the radix design on (..., 48, n2, W) f32
    views -> (zr, zi) f32, as the kernel's threads compute them."""
    tf, ti = _twiddles(h)
    x = np.moveaxis(xr + 1j * xi, -3, -1).astype(np.complex64)   # (..., n2, W, 48)
    pos = _load_positions()
    v = x[..., pos]                                                 # (..., n2, W, 3, 16)
    if inverse:
        v = np.conj(v * ti.T[:, None, :][..., pos])
    y = dft48(v)
    z = np.empty_like(x)
    z[..., _store_frequencies()] = y
    if inverse:
        z = np.conj(z) * np.float32(1.0 / h)
    else:
        z = z * tf.T[:, None, :]
    z = np.moveaxis(z, -1, -3)
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _close(out, ref, tol=TOL_KERNEL):
    """An output plane against the reference in its dtype: f32 within
    ``tol`` of the plane's max, bf16 by the storage modes' rule."""
    a, b = out.float(), ref.float()
    d, top = (a - b).abs(), float(b.abs().max())
    if out.dtype == torch.bfloat16:
        assert bool((d <= BF16_ULP * b.abs() + TOL_FLOOR * top).all()), float(d.max()) / top
        assert float((d != 0).float().mean()) <= TOL_FLIP_SHARE
    else:
        assert float(d.max()) <= tol * top, (float(d.max()), top)


def _model_io(planes, h, inverse, dtype):
    """The model on io values, its outputs rounded to the io dtype."""
    outs = []
    for xr, xi in zip(planes[::2], planes[1::2]):
        zr, zi = model_h_passA(xr.float().numpy(), xi.float().numpy(), h, inverse)
        outs += [torch.from_numpy(zr).to(dtype), torch.from_numpy(zi).to(dtype)]
    return outs


def _planes(seed, shape, count, dtype):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
            for _ in range(count)]


def test_schedule_covers_the_column():
    """The three threads of a column load every position once, in the
    order j1 = 3 j' + g, write every buffer row once and store every
    frequency once, k1 = k' + 16 c; the block's threads are (l, g) with
    RTW lanes, so a warp is 32 consecutive lanes of one g (each device
    access 32 consecutive elements of a row of the view, each buffer
    access 32 consecutive float2)."""
    pos, rows, freq = _load_positions(), _buffer_rows(), _store_frequencies()
    for a in (pos, rows, freq):
        assert np.array_equal(np.sort(a.reshape(-1)), np.arange(N1))
    assert np.array_equal(pos[:, 0], [0, 1, 2]) and np.array_equal(pos[1], 3 * np.arange(16) + 1)
    assert np.array_equal(freq.reshape(-1), np.arange(N1))       # natural order by c
    src = (CSRC / "h_pass_a.cu").read_text()
    rtw = int(re.search(r"constexpr int RTW = (\d+);", src).group(1))
    assert rtw % 32 == 0 and 32 <= rtw <= 128
    assert "const int l = threadIdx.x % RTW, g = threadIdx.x / RTW;" in src
    assert "dim3(3 * RTW)" in src
    t = np.arange(3 * rtw)
    for warp in t.reshape(-1, 32):
        assert len(set(warp // rtw)) == 1 and np.array_equal(np.diff(warp % rtw), np.ones(31))


def test_roots_are_rounded_float64():
    """cos48's literals are cos(2 pi q / 48) from float64 rounded to f32,
    and every root mul_w48 takes (m = g k' <= 30) is exp(-2 pi i m / 48)
    within an f32 rounding."""
    want = np.cos(2 * np.pi * np.arange(13) / N1).astype(np.float32)
    want[12] = 0.0
    assert np.array_equal(_cos48(), want)
    for m in range(2 * 15 + 1):
        exact = np.exp(-2j * np.pi * m / N1)
        assert abs(complex(_w48(m)) - exact) <= 1.2e-7, m


def test_dft48_against_float64():
    """The three threads give the length-48 DFT at each stored frequency,
    and the inverse by conjugation gives n times the inverse DFT (the
    kernel's store scales it by 1/n)."""
    rng = np.random.RandomState(4)
    x = (rng.randn(7, N1) + 1j * rng.randn(7, N1)).astype(np.complex64)
    want = np.fft.fft(x.astype(np.complex128))
    got = dft48(x[..., _load_positions()])
    assert np.abs(got - want[..., _store_frequencies()]).max() <= TOL_F64 * np.abs(want).max()
    back = np.conj(dft48(np.conj(x)[..., _load_positions()]))
    inv = np.fft.ifft(x.astype(np.complex128)) * N1
    assert np.abs(back - inv[..., _store_frequencies()]).max() <= TOL_F64 * np.abs(inv).max()


def test_model_is_the_stage_in_float64():
    """The model of one array against the stage computed in float64 (the
    length-48 DFT down each column and T; or T_inv, the inverse DFT and
    1/n)."""
    n1, n2 = K.factors(H)
    rng = np.random.RandomState(5)
    xr, xi = (rng.randn(n1, n2, 8).astype(np.float32) for _ in range(2))
    x = xr.astype(np.float64) + 1j * xi
    j1 = np.arange(n1)[:, None, None]
    j2 = np.arange(n2)[None, :, None]
    for inverse in (False, True):
        sign = 1 if inverse else -1
        t = np.exp(sign * 2j * np.pi * j1 * j2 / H)
        # the inverse scales by 1/n, n = n1 n2 (np.fft.ifft by 1/n1)
        want = (np.fft.ifft(x * t, axis=0) / n2 if inverse else np.fft.fft(x, axis=0) * t)
        zr, zi = model_h_passA(xr, xi, H, inverse)
        err = np.abs(zr + 1j * zi - want).max()
        assert err <= TOL_F64 * np.abs(want).max(), (inverse, err)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("w", LANES)
def test_model_matches_pallas_pair(jax_io, w, io, inverse):
    """K4: the model on both arrays against the JAX package's
    ``h_passA_pair`` in interpret mode at H = 6144, on the same io values."""
    jax_io(io)
    dtype = IO[io][1]
    n1, n2 = K.factors(H)
    planes = _planes(w + 10 * inverse, (n1, n2, w), 4, dtype)
    ref = pk2.h_passA_pair(*(jnp.asarray(p.float().numpy(), IO[io][0]) for p in planes), H,
                           inverse)
    refs = [torch.from_numpy(np.array(r, np.float32)).to(dtype) for pr in ref for r in pr]
    for o, r in zip(_model_io(planes, H, inverse, dtype), refs):
        _close(o, r)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("w", LANES)
def test_model_matches_pallas_single(jax_io, w, io, inverse):
    """K14: the model on one array against the JAX package's ``h_passA``
    in interpret mode at H = 6144."""
    jax_io(io)
    dtype = IO[io][1]
    n1, n2 = K.factors(H)
    planes = _planes(20 + w + inverse, (n1, n2, w), 2, dtype)
    ref = pk2.h_passA(*(jnp.asarray(p.float().numpy(), IO[io][0]) for p in planes), H, inverse)
    refs = [torch.from_numpy(np.array(r, np.float32)).to(dtype) for r in ref]
    for o, r in zip(_model_io(planes, H, inverse, dtype), refs):
        _close(o, r)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_model_matches_plain_on_a_stack(io, inverse):
    """The model against the port's plain versions (the kernels' yardstick
    on the card) on a stack of 3 planes, K4's pair and K14's one array, a
    cut lane tile (W = 40) and an odd n2 (H = 1392 = 48 x 29)."""
    dtype = IO[io][1]
    for h in (H, 1392):
        n1, n2 = K.factors(h)
        assert n1 == N1
        planes = _planes(h + inverse, (3, n1, n2, 40), 4, dtype)
        pair = [t for pr in K.h_passA_pair_plain(*planes, h, inverse) for t in pr]
        one = K.h_passA_plain(*planes[:2], h, inverse)
        model = _model_io(planes, h, inverse, dtype)
        for o, r in zip(model, pair):
            _close(o, r)
        for o, r in zip(model[:2], one):
            _close(o, r)


def test_design_is_a_shape_rule():
    """n1 = 48 takes the radix design; the n1 of the smoke run's other
    grids (96, 768, 540, 480, 256, 192 rows: 12, 6, 27, 24, 2, 12) the
    split one, as any other n1; the CPU wrappers run the plain versions
    whatever the design."""
    assert K.H_RADIX_N1 == N1 and K.h_pass_a_design(48) == "radix"
    assert K.factors(H)[0] == 48 and K.h_pass_a_design(K.factors(H)[0]) == "radix"
    for h in (96, 768, 540, 480, 256, 192, 1024, 2048, 4096):
        assert K.h_pass_a_design(K.factors(h)[0]) == "split", h
    for n1 in (1, 2, 6, 12, 16, 24, 27, 32, 36, 47, 49, 64, 96):
        assert K.h_pass_a_design(n1) == "split"
    planes = _planes(9, (2, 48, 128, 40), 4, torch.float32)
    for a, b in zip(K.h_passA_pair(*planes, H, False), K.h_passA_pair_plain(*planes, H, False)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for a, b in zip(K.h_passA(*planes[:2], H, True), K.h_passA_plain(*planes[:2], H, True)):
        assert torch.equal(a, b)


def test_c_entries_take_the_same_rule():
    """``lpt_h_pass_a_pair`` and ``lpt_h_pass_a`` run the radix design for
    n1 == RN1 alone, and RN1 is fft::N48 = ``kernels.H_RADIX_N1``."""
    src = (CSRC / "h_pass_a.cu").read_text()
    assert re.findall(r"constexpr int RN1 = ([\w:]+);", src) == ["fft::N48"]
    n48 = re.findall(r"constexpr int N48 = (\d+);", (CSRC / "lpt_fft.cuh").read_text())
    assert n48 == [str(K.H_RADIX_N1)]
    assert re.findall(r"if \(n1 == (\w+)\)\s*return pair \? run_radix", src) == ["RN1"]
    # both C entries go through the one ``run`` that makes the choice
    assert len(re.findall(r"return run<", src)) == 4


@pytest.mark.parametrize("h,w,planes", [(H, 64, 1), (H, 40, 3), (96, 40, 1), (1392, 8, 2)])
def test_card_path_passes_the_split_table(monkeypatch, h, w, planes):
    """On the card both wrappers hand their C entry the split table (the
    radix design reads T and T_inv there, its roots are constants) with
    (planes, n1, n2, W, inverse, io) beside it."""
    launched = []

    def on_card(name, tensors, combo, built, cols=()):
        assert combo in built
        return True

    monkeypatch.setattr(K, "_on_card", on_card)
    monkeypatch.setattr(K, "_launch", lambda lib, fn, sig, *args: launched.append((fn, args)))
    n1, n2 = K.factors(h)
    lead = (planes,) if planes > 1 else ()
    xs = [torch.zeros(*lead, n1, n2, w, dtype=torch.bfloat16) for _ in range(4)]
    K.h_passA_pair(*xs, h, True)
    K.h_passA(*xs[:2], h, False)
    (fa, aa), (fb, ab) = launched
    assert (fa, fb) == ("lpt_h_pass_a_pair", "lpt_h_pass_a")
    want = K._table_np(h, False)
    for args, tab_at, inverse in ((aa, 8, 1), (ab, 4, 0)):
        assert np.array_equal(torch.view_as_complex(args[tab_at]).numpy(), want)
        assert list(args[tab_at + 1:]) == [planes, n1, n2, w, inverse, 1]


def test_smoke_run_names_k4_designs():
    """chip_smoke.py's K4 and K14 rows carry the design the shape rule
    names: radix at 12 MP (W = 4096 and 8192) and on the cut tile
    K4_GUARDED, split at the small grid and at GRIDS' sensors."""
    import chip_smoke as cs
    src = (CSRC / "h_pass_a.cu").read_text()
    rtw = int(re.search(r"constexpr int RTW = (\d+);", src).group(1))
    for name in cs.K4_NAMES:
        for ph, pw in ((6144, 8192), cs.K4_GUARDED):
            assert cs.design(name, ph, pw) == {"design": "radix"}
        for ph, pw in ((96, 128), (96, 512), (540, 960), (768, 1024), (480, 640), (96, 270)):
            assert cs.design(name, ph, pw) == {"design": "split"}
    assert cs.K4_GUARDED[1] % rtw and (cs.K4_GUARDED[1] // 2) % rtw


@pytest.mark.parametrize("planes", [None, (3, 3)])
def test_smoke_run_holds_k4_k14_on_the_cut_tile(planes):
    """chip_smoke.py's cases at K4_GUARDED give K4 (v3 lanes M = W / 2 and
    the full width W) and K14 (W), both directions, the (48, 128, lanes)
    view, alone and stacked; the CPU wrappers equal their plain versions."""
    import chip_smoke as cs
    ph, pw = cs.K4_GUARDED
    lead = (planes[0],) if planes else ()
    gen = torch.Generator().manual_seed(2)
    cases = {**cs.kernel_cases(ph, pw, gen, *cs.MODES["f32"], planes=planes),
             **cs.split_kernel_cases(ph, pw, gen, *cs.SPLIT_MODES["f32"], planes=planes),
             **cs.pallas_kernel_cases(ph, pw, gen, torch.float32, planes=planes)}
    want = {"h_passA_pair": pw // 2, "h_passA_pair:inverse": pw // 2,
            "h_passA_pair:full_width": pw, "h_passA_pair:full_width_inverse": pw,
            "h_passA:full_width": pw, "h_passA": pw, "h_passA:inverse": pw}
    for name, lanes in want.items():
        args, flops = cases[name]
        assert tuple(args[0].shape) == lead + (48, 128, lanes) and flops > 0, name
        fn = name.split(":")[0]
        out, ref = getattr(K, fn)(*args), getattr(K, fn + "_plain")(*args)
        for a, b in zip(cs.flatten(out), cs.flatten(ref)):
            assert torch.equal(a, b)


def test_smoke_run_holds_k4_in_both_directions():
    """chip_smoke.py holds K4's inverse (the v3 loop's second K4, and the
    pallas loop's K4 after K17) wherever it holds the forward: at the v3
    lanes and at the full width, on the cut tile (K4_NAMES), on the
    stacks (PLANE_KERNELS, FULL_WIDTH_H); every such case passes
    inverse=True and the forward ones False."""
    import chip_smoke as cs
    assert {"h_passA_pair", "h_passA_pair:inverse"} <= set(cs.K4_NAMES) & set(cs.PLANE_KERNELS)
    assert {"h_passA_pair:full_width", "h_passA_pair:full_width_inverse"} <= set(cs.FULL_WIDTH_H)
    gen = torch.Generator().manual_seed(3)
    cases = {**cs.kernel_cases(96, 128, gen, *cs.MODES["f32"]),
             **cs.split_kernel_cases(96, 128, gen, *cs.SPLIT_MODES["f32"])}
    for name, (args, _) in cases.items():
        if name.startswith("h_passA_pair"):
            assert args[-1] is name.endswith("inverse"), name


def test_smoke_reference_is_the_stage_without_its_twiddle():
    """chip_smoke.py times ``torch.fft.fft(x, dim=-3)`` beside K4 and K14
    (``reference_ms``): on the same planes it gives the forward stage
    divided by its twiddle T, a related function, not the kernels' own."""
    import chip_smoke as cs
    n1, n2 = K.factors(H)
    planes = _planes(31, (n1, n2, 8), 4, torch.float32)
    tf = torch.from_numpy(_twiddles(H)[0])[:, :, None]
    for name, args, outs in (
            ("h_passA_pair:full_width", planes,
             [t for pr in K.h_passA_pair_plain(*planes, H, False) for t in pr]),
            ("h_passA", planes[:2], list(K.h_passA_plain(*planes[:2], H, False)))):
        got = cs.reference_call(name, (*args, H, False))()
        want = torch.stack([torch.complex(r, i) / tf for r, i in zip(outs[::2], outs[1::2])])
        assert torch.allclose(got.reshape(want.shape), want, rtol=0, atol=1e-4 * want.abs().max())
    assert cs.reference_call("h_combine_dual", planes) is None
