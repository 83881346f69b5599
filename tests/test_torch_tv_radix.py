"""K3's and K10's radix designs (csrc/admm_state.cuh ``tv_pass0`` feeding
the radix FFT of csrc/lpt_fft.cuh) modelled on the CPU.

Both kernels run the TV / non-negativity step at a thread's pass-0
positions j = t + T r (r < 16, T = M / 16 threads) and hand the result to
the radix FFT in registers, with no shared row and no barrier before it:

- K3 ``e1_rtv`` (split lanes, M = pw / 2): a thread holds the even element
  at j and the odd one at M + j.  roll(+1) reads odd[j - 1] (odd[M - 1] at
  j = 0) for the even element and even[j] for the odd one; roll(-1) of a1'
  needs a1'_odd[j] (the thread's own) and a1'_even[j + 1], which the
  thread recomputes from image even[j + 1], odd[j] and a1 even[j + 1]
  (a1'_even[0] at j = M - 1).  v[r] = rk_even[j] + i rk_odd[j] is
  ``rfft_core``'s pass-0 input (K1's transform).
- K10 ``e1_carry`` (natural lanes, W = pw): roll(+1) reads image j - 1,
  a1'[j + 1] is recomputed from image j, j + 1 and a1 j + 1; the X / v
  update runs at the same j; z[r] = rk[j] + i v'[j] is the pass-0 input of
  K12's transform of two real rows (balanced by a power of two).

The H halo rows (image r - 1 and r + 1, a0 r + 1) are read per plane
(``plane_rows``).  The model computes those registers from the kernels'
own index reads in f32, writes them into a row at their positions and
runs the existing numpy models of the radix FFTs (tests/
test_torch_rfft_radix.py, tests/test_torch_w_radix.py) on it.  It is held
to the JAX package's ``e1_rtv`` and ``e1_carry`` in interpret mode, in
f32 and with 2-byte storage (the saturation channel included), and to
the port's plain versions on a stack, so an index, wrap, order or scale
mistake shows here before the kernels reach a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from test_torch_modes import JDT, TDT, _check, _pair
from test_torch_rfft_radix import _positions, model_rfft_w
from test_torch_v2 import _k8_inputs
from test_torch_w_radix import model_fft_w

P = tsplit.ADMMParams()
# f32 spectra: max |model - reference| / max |reference| of each row (the
# bound chip_smoke.py holds the kernels to); against the port's plain
# versions on a stack 1e-5 (the f32 round-off of two transform orders).
# Stored carries and 2-byte planes: test_torch_modes' ``_check``.
TOL_KERNEL = 1e-4
TOL_PLAIN = 1e-5
K3_MS = (64, 256, 4096)
K10_WS = (512, 1024, 8192)
ROWS = 8                      # one Pallas block: the halo rows wrap inside it
CSRC = Path(K.__file__).parent / "csrc"
F32 = np.float32


@pytest.fixture
def jax_modes(monkeypatch):
    """Pallas in interpret mode; returns a setter of the JAX storage
    globals (``_CARRY_TV_DTYPE`` for K3, ``_CARRY_DTYPE`` for K10's TV
    carries), which its kernels read at call time."""
    pk2._set_interpret(True)

    def set_modes(io="f32", tv="f32", v="f32"):
        monkeypatch.setattr(pk2, "_IO_DTYPE", JDT[io])
        monkeypatch.setattr(pk2, "_CARRY_TV_DTYPE", JDT[tv])
        monkeypatch.setattr(pk2, "_CARRY_DTYPE", JDT[tv])
        monkeypatch.setattr(pk2, "_CARRY_V_DTYPE", JDT[v])

    try:
        yield set_modes
    finally:
        pk2._set_interpret(False)


def _soft(x, thr):
    return np.copysign(np.maximum(np.abs(x) - thr, F32(0)), x)


def tv_dual(psi, a, mu2, thr):
    """``tv_dual``: mu2 soft(psi + eta / mu2, thr) - eta, eta = mu2 psi - a."""
    eta = mu2 * psi - a
    return mu2 * _soft(psi + eta / mu2, thr) - eta


def plane_rows(rows, ph):
    """(c, p, n): each row, its previous and its next row in the same
    plane of ph rows (``plane_rows``: periodic within the plane)."""
    r = np.arange(rows)
    lr = r % ph
    base = r - lr
    return r, base + (lr + ph - 1) % ph, base + (lr + 1) % ph


def pass0_positions(m):
    """(T, 16) positions j = t + T r of the thread's registers r."""
    nt = m // K.RADIX
    return np.arange(nt)[:, None] + nt * np.arange(K.RADIX)[None, :]


def model_tv_pass0(img, a0, a1, b, ph, natural, mu2=P.mu2, mu3=P.mu3, tau=P.tau):
    """``tv_pass0`` on (rows, n) f32 planes (carries widened to f32) ->
    (v, a0', a1', b', a1'[j + 1] as recomputed): v (rows, T, 16) the
    pass-0 registers, complex rk_even + i rk_odd in split lanes, real rk
    in natural lanes; each output plane written at the positions the
    threads store."""
    rows, n = img.shape
    m = n if natural else n // 2
    j = pass0_positions(m)
    jm, jp = np.where(j > 0, j - 1, m - 1), np.where(j + 1 < m, j + 1, 0)
    c, p, nx = plane_rows(rows, ph)
    mu2, mu3 = F32(mu2), F32(mu3)
    thr = F32(tau) / mu2
    a0o, a1o, bo = (np.full(img.shape, np.nan, F32) for _ in range(3))

    def h_part(q, x):
        """``tv_h`` at element q (T, 16) of every row, image x there."""
        a0c = tv_dual(img[p][:, q] - x, a0[c][:, q], mu2, thr)
        a0n = tv_dual(x - img[nx][:, q], a0[nx][:, q], mu2, thr)
        rho = mu3 * x - b[:, q]
        bn = mu3 * np.maximum(rho / mu3 + x, F32(0)) - rho
        a0o[:, q], bo[:, q] = a0c, bn
        return bn + (a0n - a0c)

    if natural:
        x = img[:, j]
        a1c = tv_dual(img[:, jm] - x, a1[:, j], mu2, thr)
        a1n = tv_dual(x - img[:, jp], a1[:, jp], mu2, thr)
        a1o[:, j] = a1c
        return h_part(j, x) + (a1n - a1c), a0o, a1o, bo, a1n
    xe, xo = img[:, j], img[:, m + j]
    ae = tv_dual(img[:, m + jm] - xe, a1[:, j], mu2, thr)
    ao = tv_dual(xe - xo, a1[:, m + j], mu2, thr)
    an = tv_dual(xo - img[:, jp], a1[:, jp], mu2, thr)
    a1o[:, j], a1o[:, m + j] = ae, ao
    v = (h_part(j, xe) + (ao - ae)) + 1j * (h_part(m + j, xo) + (an - ao))
    return v.astype(np.complex64), a0o, a1o, bo, an


def _row(v, m, natural):
    """Registers (rows, T, 16) -> the row they hold at j = t + T r: split
    lanes [real | imag] (2M values), natural lanes M values."""
    j = pass0_positions(m).reshape(-1)
    rows = v.shape[0]
    flat = v.reshape(rows, -1)
    if natural:
        out = np.empty((rows, m), F32)
        out[:, j] = flat
        return out
    out = np.empty((rows, 2 * m), F32)
    out[:, j], out[:, m + j] = flat.real, flat.imag
    return out


def _sat(a0o, a1o, bo, mu3=P.mu3, tau=P.tau):
    sc_a, sc_b = K._tv_scales(P.mu2, mu3, tau)
    amax = max(np.abs(a0o).max(), np.abs(a1o).max())
    return max(amax * F32(1.0 / sc_a), np.abs(bo).max() * F32(1.0 / sc_b))


def model_e1_rtv(img, a0, a1, b, ph):
    """K3's radix design on f32 planes -> (rkr, rki, a0', a1', b', sat)
    in f32, before the stores' rounding."""
    m = img.shape[-1] // 2
    v, a0o, a1o, bo, _ = model_tv_pass0(img, a0, a1, b, ph, natural=False)
    zr, zi = model_rfft_w(_row(v, m, natural=False))
    return zr, zi, a0o, a1o, bo, _sat(a0o, a1o, bo)


def xv_update(fw, v, mk, d, mu1=P.mu1):
    """``xv_update`` with the wrapper's f32 constants."""
    c_in, c_out = 1.0 / (1.0 + mu1), 1.0 / mu1
    mu1, c_diff, c_out = F32(mu1), F32(c_in - c_out), F32(c_out)
    xi = mu1 * fw - v
    xdv = c_out + c_diff * mk
    return mu1 * (xdv * (xi + mu1 * fw + d)) - xi


def model_e1_carry(img, fwd, v, b, a0, a1, mask_rows, dp, ph):
    """K10's radix design on f32 planes (``mask_rows`` the mask row each
    row reads) -> (rkr, rki, vwr, vwi, v', a0', a1', b') in f32: the
    registers z = rk + i s v' through K12's model, rows (rk, v') paired."""
    w = img.shape[-1]
    rk, a0o, a1o, bo, _ = model_tv_pass0(img, a0, a1, b, ph, natural=True)
    vn = xv_update(fwd, v, mask_rows, dp)
    pairs = np.empty((2 * img.shape[0], w), F32)
    pairs[0::2], pairs[1::2] = _row(rk, w, natural=True), vn
    zr, zi = model_fft_w(pairs)
    return zr[0::2], zi[0::2], zr[1::2], zi[1::2], vn, a0o, a1o, bo


def _row_errs(a, b):
    return np.abs(a - b).max(axis=-1) / np.abs(b).max(axis=-1)


def _spectrum_check(out, ref):
    """A model spectrum (f32 numpy) against a reference tensor or array in
    its storage dtype: f32 within TOL_KERNEL of each row's max, bf16 by
    test_torch_modes' rule after the store's rounding."""
    ref_t = ref if isinstance(ref, torch.Tensor) else None
    if ref_t is None:
        arr = np.asarray(ref)
        if arr.dtype == np.float32:
            assert _row_errs(out, arr).max() <= TOL_KERNEL
            return
        _check(torch.from_numpy(out).to(torch.bfloat16), ref)
        return
    if ref_t.dtype == torch.float32:
        assert _row_errs(out, ref_t.numpy().reshape(out.shape)).max() <= TOL_KERNEL
    else:
        _check(torch.from_numpy(out).to(ref_t.dtype), ref)


def _carry_out(x, like, scale):
    """A model carry stored as the kernel stores it (``_store_carry``)."""
    return K._store_carry(torch.from_numpy(x), like.dtype, scale)


# ---------------------------------------------------------------------------
# the register TV step alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", K.RADIX_LENGTHS + (8192,))
def test_pass0_positions_are_the_fft_pass0_reads(m):
    """tv_pass0's positions j = t + T r are where the radix FFT's pass 0
    reads thread t's register r (its first butterfly's inputs), and they
    cover the row once."""
    j = pass0_positions(m)
    pos, _ = _positions(m, K.radix_plan(m)[0], m)
    assert np.array_equal(pos[:, 0, :], j)
    assert np.array_equal(np.sort(j.reshape(-1)), np.arange(m))


@pytest.mark.parametrize("natural", [False, True], ids=["split", "natural"])
@pytest.mark.parametrize("m", (64, 512))
def test_register_step_is_the_tv_step(m, natural):
    """The register step at every position equals the port's row-wise TV
    step (``kernels._tv_step``, both lane layouts) on a 2-plane stack,
    and the recomputed a1'[j + 1] equals the a1' its own thread stores
    there (the roll(-1) partner, wrap included)."""
    rng = np.random.RandomState(3 + m + natural)
    n = m if natural else 2 * m
    ph = 5
    img = rng.randn(2 * ph, n).astype(F32)
    a0, a1 = (P.tau * rng.randn(2 * ph, n).astype(F32) for _ in range(2))
    b = P.mu3 * rng.randn(2 * ph, n).astype(F32)
    v, a0o, a1o, bo, partner = model_tv_pass0(img, a0, a1, b, ph, natural)
    ref = K._tv_step(*(torch.from_numpy(x.reshape(2, ph, n)) for x in (img, a0, a1, b)),
                     P.mu2, P.mu3, P.tau, natural=natural)
    rk = _row(v, m, natural)
    for got, want in zip((rk, a0o, a1o, bo), ref):
        want = want.reshape(2 * ph, n).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    j = pass0_positions(m)
    jp = np.where(j + 1 < m, j + 1, 0)
    assert np.array_equal(partner, a1o[:, jp])        # even plane at j + 1


def test_split_wrap_reads_the_row_ends():
    """In split lanes position 0's even element reads odd[M - 1] (roll +1)
    and position M - 1's odd element pairs with a1'_even[0] (roll -1):
    a change at those two ends moves exactly the rk values the wrap says."""
    m, ph = 64, 3
    rng = np.random.RandomState(4)
    img = rng.randn(ph, 2 * m).astype(F32)
    a0, a1 = (P.tau * rng.randn(ph, 2 * m).astype(F32) for _ in range(2))
    b = P.mu3 * rng.randn(ph, 2 * m).astype(F32)
    base = _row(model_tv_pass0(img, a0, a1, b, ph, False)[0], m, False)
    for col, moved in ((2 * m - 1, {m - 1, 2 * m - 1, 0}), (0, {0, m, 2 * m - 1})):
        bumped = img.copy()
        bumped[1, col] += 1.0
        out = _row(model_tv_pass0(bumped, a0, a1, b, ph, False)[0], m, False)
        changed = set(np.nonzero(np.abs(out[1] - base[1]) > 0)[0].tolist())
        assert changed == moved, (col, changed)


# ---------------------------------------------------------------------------
# the models against the Pallas kernels and the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("io,tv", [("f32", "f32"), ("bf16", "i16"), ("bf16", "bf16")])
@pytest.mark.parametrize("m", K3_MS)
def test_k3_model_matches_pallas(jax_modes, m, io, tv):
    """K3's radix model against the Pallas ``e1_rtv`` (ROWS rows, one
    periodic plane), carries at their KKT scale; with int16 carries the
    saturation value too."""
    jax_modes(io=io, tv=tv)
    rng = np.random.RandomState(60 + m.bit_length())
    sc_a, sc_b = K._tv_scales(P.mu2, P.mu3, P.tau)
    n = 2 * m
    ji, ti = _pair(rng.randn(ROWS, n).astype(F32), io)
    ja0, ta0 = _pair(P.tau * rng.randn(ROWS, n).astype(F32), tv, sc_a)
    ja1, ta1 = _pair(P.tau * rng.randn(ROWS, n).astype(F32), tv, sc_a)
    jb, tb = _pair(P.mu3 * rng.randn(ROWS, n).astype(F32), tv, sc_b)
    ref = pk2.e1_rtv(ji, ja0, ja1, jb, P.mu2, P.mu3, P.tau, block_rows=ROWS)
    f32 = [ti.float().numpy()] + [K._load_carry(t, s).numpy()
                                  for t, s in ((ta0, sc_a), (ta1, sc_a), (tb, sc_b))]
    zr, zi, a0o, a1o, bo, sat = model_e1_rtv(*f32, ph=ROWS)
    _spectrum_check(zr, ref[0])
    _spectrum_check(zi, ref[1])
    for x, like, scale, r in ((a0o, ta0, sc_a, ref[2]), (a1o, ta1, sc_a, ref[3]),
                              (bo, tb, sc_b, ref[4])):
        _check(_carry_out(x, like, scale), r)
    if tv == "i16":
        _check(torch.tensor(sat), ref[5])
        assert 0.0 < sat < 1.0


@pytest.mark.parametrize("io,tv,v", [("f32", "f32", "f32"), ("bf16", "f32", "i16"),
                                     ("bf16", "bf16", "bf16")])
@pytest.mark.parametrize("w", K10_WS)
def test_k10_model_matches_pallas(jax_modes, w, io, tv, v):
    """K10's radix model against the Pallas ``e1_carry`` (ROWS rows),
    data only inside the support mask, v of order mu1, carries at their
    KKT scale: f32, the bench mode (bf16 io, int16 v) and bf16 carries."""
    jax_modes(io=io, tv=tv, v=v)
    ins = _k8_inputs(np.random.RandomState(70 + w.bit_length()), io, tv, v, shape=(ROWS, w))
    ref = pk2.e1_carry(*(j for j, _ in ins), P.mu1, P.mu2, P.mu3, P.tau, block_rows=ROWS)
    img, fwd, vc, b, a0, a1, mask, dp = (t for _, t in ins)
    f = lambda t: t.float().numpy()
    outs = model_e1_carry(f(img), f(fwd), K._load_carry(vc, K._v_scale(P.mu1)).numpy(), f(b),
                          f(a0), f(a1), f(mask), f(dp), ph=ROWS)
    for o, r in zip(outs[:4], ref[:4]):
        _spectrum_check(o, r)
    _check(K.encode_v(torch.from_numpy(outs[4]), P.mu1, vc.dtype), ref[4])
    for o, like, r in zip(outs[5:], (a0, a1, b), ref[5:]):
        _check(torch.from_numpy(o).to(like.dtype), r)


@pytest.mark.parametrize("m", (64, 256))
def test_k3_model_matches_plain_on_a_stack(m):
    """K3's radix model against ``e1_rtv_plain`` (the kernel's yardstick on
    the card) on a stack of 4 planes of 6 rows, int16 carries: the halo
    rows wrap within each plane."""
    rng = np.random.RandomState(80 + m.bit_length())
    sc_a, sc_b = K._tv_scales(P.mu2, P.mu3, P.tau)
    shape = (4, 6, 2 * m)
    img = torch.from_numpy(rng.randn(*shape).astype(F32))
    a0, a1 = (K._store_carry(torch.from_numpy(P.tau * rng.randn(*shape).astype(F32)),
                             torch.int16, sc_a) for _ in range(2))
    b = K._store_carry(torch.from_numpy(P.mu3 * rng.randn(*shape).astype(F32)), torch.int16,
                       sc_b)
    ref = K.e1_rtv_plain(img, a0, a1, b, P.mu2, P.mu3, P.tau)
    flat = lambda t, s: K._load_carry(t, s).reshape(24, -1).numpy()
    zr, zi, a0o, a1o, bo, sat = model_e1_rtv(img.reshape(24, -1).numpy(), flat(a0, sc_a),
                                             flat(a1, sc_a), flat(b, sc_b), ph=6)
    for out, want in ((zr, ref[0]), (zi, ref[1])):
        assert _row_errs(out, want.reshape(24, m).numpy()).max() <= TOL_PLAIN
    for x, like, scale, want in ((a0o, a0, sc_a, ref[2]), (a1o, a1, sc_a, ref[3]),
                                 (bo, b, sc_b, ref[4])):
        _check(_carry_out(x, like, scale).reshape(shape), want)
    assert abs(sat - float(ref[5])) <= 1e-5 * float(ref[5])


@pytest.mark.parametrize("w", (512, 1024))
def test_k10_model_matches_plain_on_a_stack(w):
    """K10's radix model against ``e1_carry_plain`` on a stack of 4 planes
    of 3 rows over a mask of 2 planes (plane p reads mask plane p % 2),
    with plane 0 scaled by 1e3 so the balance matters."""
    rng = np.random.RandomState(90 + w.bit_length())
    ph, shape = 3, (4, 3, w)
    mask = torch.from_numpy((rng.rand(2, ph, w) > 0.5).astype(F32))
    st = lambda s=1.0: torch.from_numpy(s * rng.randn(*shape).astype(F32))
    img, fwd = st(), st()
    img[0] *= 1e3
    v, b, a0, a1 = st(P.mu1), st(P.mu3), st(P.tau), st(P.tau)
    dp = K.bmul(mask, torch.from_numpy(rng.rand(*shape).astype(F32)))
    ref = K.e1_carry_plain(img, fwd, v, b, a0, a1, mask, dp, P.mu1, P.mu2, P.mu3, P.tau)
    rows = lambda t: t.reshape(12, w).numpy()
    mask_rows = mask.repeat(2, 1, 1).reshape(12, w).numpy()
    outs = model_e1_carry(rows(img), rows(fwd), rows(v), rows(b), rows(a0), rows(a1),
                          mask_rows, rows(dp), ph=ph)
    for o, r in zip(outs[:4], ref[:4]):
        assert _row_errs(o, rows(r)).max() <= TOL_PLAIN
    for o, r in zip(outs[4:], ref[4:]):
        assert np.abs(o - rows(r)).max() <= TOL_PLAIN * np.abs(rows(r)).max()


# ---------------------------------------------------------------------------
# the design rules and the card path
# ---------------------------------------------------------------------------


def test_design_rules():
    """K3 takes K1's rule (radix for M a power of two from 64 to 4096), K10
    K12's (radix for W a power of two from 512 to 8192); the 12 MP grid
    (M = 4096, W = 8192) runs both radix designs, 96 x 384 and 96 x 1536
    their split ones."""
    assert K.e1_rtv_design is K.rfft_w_design
    assert K.e1_carry_design is K.fft_w_design
    assert K.e1_rtv_design(4096) == "radix" and K.e1_carry_design(8192) == "radix"
    for m in K.RADIX_LENGTHS:
        assert K.e1_rtv_design(m) == "radix"
    for w in K.IFFT_RADIX_WIDTHS:
        assert K.e1_carry_design(w) == "radix"
    for m in (32, 135, 192, 480, 768, 8192):
        assert K.e1_rtv_design(m) == "split"
    for w in (128, 256, 960, 1536, 16384):
        assert K.e1_carry_design(w) == "split"


@pytest.mark.parametrize("src,macro,lengths", [
    ("e1_rtv.cu", "LPT_E3R", K.RADIX_LENGTHS),
    ("e1_carry.cu", "LPT_E10R", K.IFFT_RADIX_WIDTHS)], ids=["e1_rtv", "e1_carry"])
def test_c_entry_takes_the_same_rule(src, macro, lengths):
    """The C entry launches the radix kernel for exactly the lengths of the
    Python rule, each case at its own length, and every other length
    falls to the split kernel (``run<``) in the switch's default."""
    text = (CSRC / src).read_text()
    cases = re.findall(rf"case (\d+): {macro}\((\d+)\);", text)
    assert sorted(int(a) for a, _ in cases) == list(lengths)
    assert all(a == b for a, b in cases)
    body = text[text.index(f"#define {macro}"):text.index(f"#undef {macro}")]
    assert re.search(r"default:\s*return run<", body)


@pytest.mark.parametrize("m", (64, 192))
def test_k3_card_path_passes_the_design_table(monkeypatch, m):
    """On the card ``e1_rtv`` hands its C entry the table of its design
    (the split table, extended by the radix twiddles and the natural-order
    unpack factors for the radix design) with (rows, ph, m, n1, n2)."""
    launched = []
    monkeypatch.setattr(K, "_on_card", lambda name, tensors, combo, built, cols=(): (
        combo in built) or pytest.fail(f"{combo} not built"))
    monkeypatch.setattr(K, "_launch", lambda lib, fn, sig, *args: launched.append((fn, sig, args)))
    shape = (3, 4, 2 * m)
    img = torch.zeros(shape, dtype=torch.bfloat16)
    carries = [torch.zeros(shape, dtype=torch.int16) for _ in range(3)]
    K.e1_rtv(img, *carries, P.mu2, P.mu3, P.tau)
    (fn, sig, args), = launched
    assert fn == "lpt_e1_rtv" and len(sig) == len(args)
    want = K._design_table(m, True, K.e1_rtv_design(m), torch.device("cpu"))
    assert torch.equal(args[9], want)
    assert list(args[10:15]) == [12, 4, m, *K.factors(m)]
    assert list(args[-2:]) == [1, 2]


@pytest.mark.parametrize("w", (512, 1536))
def test_k10_card_path_passes_the_design_table(monkeypatch, w):
    """On the card ``e1_carry`` hands its C entry the table of its design
    (the split table, extended by the radix twiddles of W for the radix
    design) with (rows, ph, pc, n1, n2)."""
    launched = []
    monkeypatch.setattr(K, "_on_card", lambda name, tensors, combo, built, cols=(): (
        combo in built) or pytest.fail(f"{combo} not built"))
    monkeypatch.setattr(K, "_launch", lambda lib, fn, sig, *args: launched.append((fn, sig, args)))
    shape = (4, 2, w)
    io = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2)]
    vc = torch.zeros(shape, dtype=torch.int16)
    tvs = [torch.zeros(shape) for _ in range(3)]
    mask = torch.zeros((2, 2, w), dtype=torch.bfloat16)
    K.e1_carry(*io, vc, *tvs, mask, io[0], P.mu1, P.mu2, P.mu3, P.tau)
    (fn, sig, args), = launched
    assert fn == "lpt_e1_carry" and len(sig) == len(args)
    want = K._design_table(w, False, K.e1_carry_design(w), torch.device("cpu"))
    assert torch.equal(args[16], want)
    assert list(args[17:22]) == [8, 2, 2, *K.factors(w)]
    assert list(args[-3:]) == [1, 0, 2]


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors both wrappers return their plain versions' outputs
    whatever the design (radix and split widths)."""
    rng = np.random.RandomState(5)
    for pw in (128, 384):
        x = [torch.from_numpy(rng.randn(2, 6, pw).astype(F32)) for _ in range(4)]
        for a, r in zip(K.e1_rtv(*x, P.mu2, P.mu3, P.tau),
                        K.e1_rtv_plain(*x, P.mu2, P.mu3, P.tau)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(r))
    for w in (512, 1536):
        x = [torch.from_numpy(rng.randn(2, 3, w).astype(F32)) for _ in range(8)]
        for a, r in zip(K.e1_carry(*x, P.mu1, P.mu2, P.mu3, P.tau),
                        K.e1_carry_plain(*x, P.mu1, P.mu2, P.mu3, P.tau)):
            assert torch.equal(a, r)


def test_smoke_run_names_k3_k10_designs():
    """chip_smoke.py holds K3 with the M-rule kernels (M_NAMES: 96 x 384
    and 96 x 1536 run its split design, the small grid and 12 MP its
    radix one) and K10 with the W-rule ones (W_SPLIT_NAMES: 96 x 1536
    split, 96 x 512 and 12 MP radix); their rows carry the design."""
    import chip_smoke as cs
    assert "e1_rtv" in cs.M_NAMES and "e1_carry" in cs.W_SPLIT_NAMES
    for name, grid, want in (
            ("e1_rtv", (6144, 8192), "radix"), ("e1_rtv", (96, 128), "radix"),
            ("e1_rtv", (2 * cs.K1_SPLIT[0], 2 * cs.K1_SPLIT[1]), "split"),
            ("e1_rtv", (2 * cs.W_SPLIT[0], 2 * cs.W_SPLIT[1]), "split"),
            ("e1_rtv", (540, 960), "split"), ("e1_rtv", (768, 1024), "radix"),
            ("e1_carry", (6144, 8192), "radix"), ("e1_carry", (96, 512), "radix"),
            ("e1_carry", (2 * cs.W_SPLIT[0], 2 * cs.W_SPLIT[1]), "split"),
            ("e1_carry", (540, 960), "split"), ("e1_carry", (768, 1024), "radix")):
        assert cs.design(name, *grid) == {"design": want}, (name, grid)
