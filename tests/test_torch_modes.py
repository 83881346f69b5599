"""The port's storage modes against the JAX package on the CPU: bf16
spectra (``io``), bf16 and int16 fixed-point carries (``carry_tv``,
``carry_v``), the saturation channel and the two kernels K2 ``irfft_w``
and K7 ``sat_scan_i16``.

The JAX side runs its Pallas kernels in interpret mode with its storage
globals set as tests/test_pallas_fft.py sets them.  Inputs come from numpy
with a fixed seed; a bf16 input is rounded once in each framework (both
round to nearest even, so both see the same values), an int16 input is
the same integers on both sides.

Tolerances: a bf16 output within one bf16 ulp of the JAX value (2^-7
relative, where the two f32 pre-images straddle a rounding boundary) plus
1e-5 of the plane's max; an int16 output within one LSB; and at most 1 %
of a bf16 or int16 plane's elements not bit-equal to the JAX ones (a store
that truncates instead of rounding to nearest even is off by one on about
half of them); an f32 output within 1e-5 of the plane's max; a saturation
value within 1e-5 relative.
The loop is held to the normalized 5e-2 of tests/test_pallas_fft.py:249:
a 3e-7 relative change of the data alone moves the JAX package's own
headline-mode loop by 1.9e-2 at n = 20, because bf16 and int16 rounding
flips grow along the trajectory, so no tighter loop bound means anything;
the per-kernel tests carry the exactness.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2
from lenslesspicam_tpu.recon import admm_split as jsplit

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit

from test_torch_scripts import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i16": jnp.int16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "i16": torch.int16}
P = tsplit.ADMMParams()
BF16_ULP = 2.0 ** -7
TOL_FLOOR = 1e-5           # times the plane's max |value|
TOL_SAT = 1e-5
TOL_FLIP_SHARE = 1e-2      # bf16/int16 elements not bit-equal to the reference
TOL_LOOP = 5e-2            # normalized, tests/test_pallas_fft.py:249

# (io, carry_tv, carry_v): each knob alone, bf16 carries, and the JAX
# bench's headline mode (bench.py:844-847)
LOOP_MODES = [("bf16", "f32", "f32"), ("f32", "i16", "f32"), ("f32", "f32", "i16"),
              ("f32", "bf16", "bf16"), ("bf16", "i16", "i16")]


@pytest.fixture
def jax_modes(monkeypatch):
    """Pallas in interpret mode; returns a setter of the JAX storage
    globals, which its kernels and solver read at call time."""
    pk2._set_interpret(True)

    def set_modes(io="f32", tv="f32", v="f32"):
        monkeypatch.setattr(pk2, "_IO_DTYPE", JDT[io])
        monkeypatch.setattr(pk2, "_CARRY_TV_DTYPE", JDT[tv])
        monkeypatch.setattr(pk2, "_CARRY_V_DTYPE", JDT[v])

    try:
        yield set_modes
    finally:
        pk2._set_interpret(False)


def _quantize(x, scale):
    return np.round(np.clip(x * (32767.0 / scale), -32767.0, 32767.0)).astype(np.int16)


def _pair(x, mode, scale=None):
    """(JAX array, port tensor) of the f32 numpy ``x`` stored as ``mode``
    (int16: fixed point at ``scale``)."""
    if mode == "i16":
        q = _quantize(x, scale)
        return jnp.asarray(q), torch.from_numpy(q)
    j = jnp.asarray(x, JDT[mode])
    t = torch.from_numpy(np.ascontiguousarray(x)).to(TDT[mode])
    assert torch.equal(convert.tensor(np.asarray(j), device="cpu"), t)
    return j, t


def _flip_share(d):
    """Share of the elements whose difference ``d`` is not zero."""
    return float((d != 0).float().mean())


def _check(out, ref):
    """One port output against the JAX one, in its storage dtype."""
    if not isinstance(out, torch.Tensor) or out.dim() == 0:
        r = float(np.max(np.asarray(ref)))
        assert abs(float(out) - r) <= TOL_SAT * abs(r), (float(out), r)
        return
    ref = convert.tensor(np.asarray(ref), device="cpu")
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if out.dtype == torch.int16:
        d = (out.int() - ref.int()).abs()
        assert int(d.max()) <= 1
        assert _flip_share(d) <= TOL_FLIP_SHARE, _flip_share(d)
        return
    a, b = out.float(), ref.float()
    d, top = (a - b).abs(), float(b.abs().max())
    if out.dtype == torch.bfloat16:
        assert bool((d <= BF16_ULP * b.abs() + TOL_FLOOR * top).all()), float(d.max())
        assert _flip_share(d) <= TOL_FLIP_SHARE, _flip_share(d)
    else:
        assert float(d.max()) <= TOL_FLOOR * top, (float(d.max()), top)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k1_rfft_w_modes(jax_modes, io):
    jax_modes(io=io)
    x = np.random.RandomState(20).randn(96, 128).astype(np.float32)
    jx, tx = _pair(x, io)
    for a, r in zip(K.rfft_w(tx), pk2.rfft_w(jx)):
        _check(a, r)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k2_irfft_w_modes(jax_modes, io):
    jax_modes(io=io)
    rng = np.random.RandomState(21)
    (jr, tr), (ji, ti) = (_pair(rng.randn(96, 64).astype(np.float32), io) for _ in range(2))
    _check(K.irfft_w(tr, ti), pk2.irfft_w(jr, ji))


@pytest.mark.parametrize("io,tv", [("bf16", "i16"), ("bf16", "f32"), ("f32", "i16"),
                                   ("f32", "bf16")])
def test_k3_e1_rtv_modes(jax_modes, io, tv):
    """K3 with its carries at their KKT scale (|a| ~ tau, |b| ~ mu3 |image|;
    ROADMAP.md Queue 3: O(1) carries cancel to 1e-4 and flip roundings)."""
    jax_modes(io=io, tv=tv)
    rng = np.random.RandomState(22)
    sc_a, sc_b = K._tv_scales(P.mu2, P.mu3, P.tau)
    ji, ti = _pair(rng.randn(96, 128).astype(np.float32), io)
    ja0, ta0 = _pair(P.tau * rng.randn(96, 128).astype(np.float32), tv, sc_a)
    ja1, ta1 = _pair(P.tau * rng.randn(96, 128).astype(np.float32), tv, sc_a)
    jb, tb = _pair(P.mu3 * rng.randn(96, 128).astype(np.float32), tv, sc_b)
    ref = pk2.e1_rtv(ji, ja0, ja1, jb, P.mu2, P.mu3, P.tau)
    out = K.e1_rtv(ti, ta0, ta1, tb, P.mu2, P.mu3, P.tau)
    for a, r in zip(out, ref):
        _check(a, r)
    if tv == "i16":
        assert 0.0 < float(out[5]) < 1.0
    else:
        assert out[5] == 0.0


@pytest.mark.parametrize("inverse", [False, True])
def test_k4_h_passA_pair_bf16(jax_modes, inverse):
    jax_modes(io="bf16")
    rng = np.random.RandomState(23)
    pairs = [_pair(rng.randn(12, 8, 64).astype(np.float32), "bf16") for _ in range(4)]
    ref = pk2.h_passA_pair(*(j for j, _ in pairs), 96, inverse)
    out = K.h_passA_pair(*(t for _, t in pairs), 96, inverse)
    for i in range(2):
        for k in range(2):
            _check(out[i][k], ref[i][k])


def test_k5_fft_h_combine_dual_bf16(jax_modes):
    jax_modes(io="bf16")
    rng = np.random.RandomState(24)
    pairs = [_pair(rng.randn(96, 64).astype(np.float32), "bf16") for _ in range(7)]
    ref = pk2.fft_h_combine_dual(*(j for j, _ in pairs), 96)
    out = K.fft_h_combine_dual(*(t for _, t in pairs), 96)
    for i in range(2):
        for k in range(2):
            _check(out[i][k], ref[i][k])


@pytest.mark.parametrize("with_sat", [True, False])
@pytest.mark.parametrize("io,v", [("bf16", "i16"), ("bf16", "f32"), ("f32", "i16"),
                                  ("f32", "bf16")])
def test_k6_irfft_w_dual_state_modes(jax_modes, io, v, with_sat):
    """K6 at a realistic scale: data only inside the support mask and v
    of order mu1, so v' stays inside the int16 full scale 256 mu1."""
    jax_modes(io=io, v=v)
    rng = np.random.RandomState(25)
    spec = [_pair(rng.randn(96, 64).astype(np.float32), io) for _ in range(4)]
    cols = [rng.randn(96).astype(np.float32) for _ in range(4)]
    zcols = []
    for c in cols:
        z = np.zeros((96, 128), np.float32)
        z[:, 0] = c
        zcols.append(jnp.asarray(z))
    mask_np = (rng.rand(96, 128) > 0.5).astype(np.float32)
    jm, tm = _pair(mask_np, io)
    jd, td = _pair(mask_np * rng.rand(96, 128).astype(np.float32), io)
    jv, tv_ = _pair(P.mu1 * rng.randn(96, 128).astype(np.float32), v, K._v_scale(P.mu1))
    ref = pk2.irfft_w_dual_state(*(j for j, _ in spec), *zcols, jv, jm, jd, P.mu1,
                                 with_sat=with_sat)
    out = K.irfft_w_dual_state(*(t for _, t in spec), *(torch.from_numpy(c) for c in cols),
                               tv_, tm, td, P.mu1, with_sat=with_sat)
    for a, r in zip(out, ref):
        _check(a, r)
    if with_sat and v == "i16":
        assert 0.0 < float(out[4]) < 1.0
    else:
        assert out[4] == 0.0


def test_k7_sat_scan_i16(jax_modes):
    """Full scale both ways and one -32768, which reads 32768/32767 > 1."""
    jax_modes()
    x = np.random.RandomState(26).randint(-20000, 20001, (96, 128)).astype(np.int16)
    x[1, 2], x[3, 4] = 32767, -32767
    ref = pk2.sat_scan_i16(jnp.asarray(x))
    out = K.sat_scan_i16(torch.from_numpy(x))
    _check(out, ref)
    assert float(out) == pytest.approx(1.0)
    x[5, 6] = -32768
    out = K.sat_scan_i16(torch.from_numpy(x))
    _check(out, pk2.sat_scan_i16(jnp.asarray(x)))
    assert float(out) == np.float32(32768.0) * np.float32(1.0 / 32767.0) > 1.0


def _loop_scene(seed, shape):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(*shape).astype(np.float32)
    return psf, data / data.max()      # the max-normalized contract


def _nerr(out, ref):
    ref = np.asarray(ref)
    return np.abs(out.numpy() - ref).max() / max(np.abs(ref).max(), 1e-9)


@pytest.mark.parametrize("io,tv,v", LOOP_MODES)
def test_loop_modes_match_jax(jax_modes, io, tv, v):
    """The fused loop (plain versions) against JAX run_split_rfused
    (interpret mode) at 48 x 64, n = 20."""
    jax_modes(io=io, tv=tv, v=v)
    psf, data = _loop_scene(12, (48, 64))
    ref, jsat = jsplit.run_split_rfused(jsplit.precompute_rsplit(psf, data),
                                        jsplit.ADMMParams(), 20, return_sat=True)
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    out, sat = tsplit.run_rsplit(pre, P, 20, return_sat=True, io=io, carry_tv=tv, carry_v=v)
    assert out.dtype == torch.float32 and out.shape == (48, 64)
    assert _nerr(out, ref) <= TOL_LOOP
    if "i16" in (tv, v):
        assert 0.0 < sat < 1.0 and 0.0 < float(jsat) < 1.0
    else:
        assert sat == 0.0 and float(jsat) == 0.0


@pytest.mark.parametrize("tv,v", [("i16", "i16"), ("f32", "i16")])
def test_out_of_contract_data_saturates(tv, v):
    """100x the max-normalized data drives the v carry past its full
    scale, and the channel reports it (tests/test_pallas_fft.py:251-256)."""
    psf, data = _loop_scene(11, (40, 56))
    pre = tsplit.precompute_rsplit(psf, 100.0 * data, device="cpu")
    _, sat = tsplit.run_rsplit(pre, P, 20, return_sat=True, io="bf16", carry_tv=tv, carry_v=v)
    assert sat >= 1.0


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_rfft_irfft_round_trip(io):
    """irfft_w(rfft_w(x)) == x: exact at f32, within the 8-bit rounding of
    the bf16 spectra at bf16."""
    x = torch.from_numpy(np.random.RandomState(27).randn(96, 256).astype(np.float32))
    xs = x.to(TDT[io])
    back = K.irfft_w(*K.rfft_w(xs))
    assert back.dtype == torch.float32
    err = float((back - xs.float()).abs().max() / xs.float().abs().max())
    assert err <= (1e-6 if io == "f32" else 1e-2)
    assert K.irfft_w(*K.rfft_w(xs), out_dtype=torch.bfloat16).dtype == torch.bfloat16


def test_launch_counts_cover_new_kernels_and_cpu_counts_nothing():
    K.reset_launches()
    x = torch.from_numpy(np.random.RandomState(28).randn(96, 128).astype(np.float32))
    K.irfft_w(*K.rfft_w(x.to(torch.bfloat16)))
    K.sat_scan_i16(x.to(torch.int16))
    counts = K.launch_counts()
    assert {"irfft_w", "sat_scan_i16"} <= set(counts)
    assert counts == {name: 0 for name in counts}


def test_modes_are_validated():
    psf, data = _loop_scene(3, (48, 64))
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    with pytest.raises(ValueError):
        tsplit.run_rsplit(pre, n_iter=1, io="i16")
    with pytest.raises(ValueError):
        tsplit.run_rsplit(pre, n_iter=1, carry_v="f16")
    with pytest.raises(ValueError):
        tsplit.run_rsplit(pre, n_iter=1, sat_every=0)


@pytest.mark.parametrize("modes", [{}, {"io": "bf16", "carry_tv": "i16", "carry_v": "i16"}])
def test_run_rsplit_is_the_fused_loop(modes):
    """run_rsplit runs run_split_rfused at the storage modes it is given,
    bit for bit; at f32 it is the exact solver within 1e-5."""
    psf, data = _loop_scene(21, (48, 64))
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    out, sat = tsplit.run_rsplit(pre, P, 10, return_sat=True, **modes)
    assert tuple(out.shape) == (48, 64)
    ref, ref_sat = tsplit.run_split_rfused(pre, P, 10, return_sat=True, **modes)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert sat == ref_sat
    if not modes:
        conv = tadmm.make_convolver(psf[None, :, :, None], device="cpu")
        exact = tadmm.run(conv, data[None, None, :, :, None], n_iter=10)[0, 0, :, :, 0]
        assert _nerr(out, exact.numpy()) <= 1e-5


@pytest.mark.parametrize("dtype", ["bf16", "i16"])
def test_check_rejects_a_truncating_store(dtype):
    """A store that truncates instead of rounding to nearest even stays
    within one ulp / one LSB but is off on about half of the elements:
    the share bound of ``_check`` rejects it."""
    x = np.random.RandomState(29).randn(96, 128).astype(np.float32)
    if dtype == "bf16":
        ref = jnp.asarray(x, jnp.bfloat16)
        trunc = torch.from_numpy(x).view(torch.int32) & -65536
        out = trunc.view(torch.float32).to(torch.bfloat16)
    else:
        scaled = x * 1000.0
        ref = jnp.asarray(np.round(scaled).astype(np.int16))
        out = torch.from_numpy(np.trunc(scaled).astype(np.int16))
    _check(convert.tensor(np.asarray(ref), device="cpu"), ref)
    with pytest.raises(AssertionError):
        _check(out, ref)
