"""The port's v2 kernel placement against the JAX package on the CPU: K8
``e1_rcarry`` and K9 ``irfft_w_dual`` (plain versions) against their
Pallas kernels in interpret mode, and the v2 loop against the port's v3
loop and against JAX's v2 loop (``LPT_RFUSED_V3=0``).

Tolerances are those of tests/test_torch_modes.py (its ``_check``): f32
outputs within 1e-5 of the plane's max, bf16 within one ulp, int16
within one LSB, at most 1 % of a plane not bit-equal.  K8 gets its TV
carries at their KKT scale (|a| ~ tau, |b| ~ mu3) and v of order mu1, as
K3 and K6 do there.  The v2 == v3 identity is the JAX package's own test
(tests/test_pallas_fft.py:190-214, 2e-6 at 40 x 56, n = 7); the loop
against JAX is held to 1e-5 normalized at f32 and to the 5e-2 of
tests/test_torch_modes.py in the headline mode, where rounding flips
grow along the trajectory.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2
from lenslesspicam_tpu.recon import admm_split as jsplit

from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from test_torch_modes import TOL_LOOP, _check, _loop_scene, _nerr, _pair, jax_modes  # noqa: F401

P = tsplit.ADMMParams()
TOL_IDENTITY = 2e-6        # v2 == v3, tests/test_pallas_fft.py:212
TOL_F32_LOOP = 1e-5        # normalized, f32, as tests/test_torch_admm.py:24
HEADLINE = ("bf16", "i16", "i16")

# (io, carry_tv, carry_v): f32, the JAX bench's headline mode, bf16 carries
K8_MODES = [("f32", "f32", "f32"), HEADLINE, ("f32", "bf16", "bf16")]


def _k8_inputs(rng, io, tv, v, shape=(96, 128)):
    """K8's operands, each as a (JAX array, port tensor) pair, at the
    scales of the loop: image and fwd O(1), carries at the KKT scale, v of
    order mu1, data only inside a {0,1} mask."""
    sc_a, sc_b = K._tv_scales(P.mu2, P.mu3, P.tau)
    mask = (rng.rand(*shape) > 0.5).astype(np.float32)
    return [_pair(rng.randn(*shape).astype(np.float32), io),                 # image
            _pair(rng.randn(*shape).astype(np.float32), io),                 # fwd
            _pair(P.mu1 * rng.randn(*shape).astype(np.float32), v, K._v_scale(P.mu1)),
            _pair(P.mu3 * rng.randn(*shape).astype(np.float32), tv, sc_b),   # b
            _pair(P.tau * rng.randn(*shape).astype(np.float32), tv, sc_a),   # a0
            _pair(P.tau * rng.randn(*shape).astype(np.float32), tv, sc_a),   # a1
            _pair(mask, io),
            _pair(mask * rng.rand(*shape).astype(np.float32), io)]           # dp


@pytest.mark.parametrize("io,tv,v", K8_MODES)
def test_k8_e1_rcarry_matches_pallas(jax_modes, io, tv, v):
    jax_modes(io=io, tv=tv, v=v)
    ins = _k8_inputs(np.random.RandomState(30), io, tv, v)
    consts = (P.mu1, P.mu2, P.mu3, P.tau)
    ref = pk2.e1_rcarry(*(j for j, _ in ins), *consts)
    out = K.e1_rcarry(*(t for _, t in ins), *consts)
    assert len(out) == len(ref) == 8
    for a, r in zip(out, ref):
        _check(a, r)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k9_irfft_w_dual_matches_pallas(jax_modes, io):
    """The port's (rows,) columns are the JAX kernel's (m, 128) column
    operands' column 0, the only one it reads."""
    jax_modes(io=io)
    rng = np.random.RandomState(31)
    spec = [_pair(rng.randn(96, 64).astype(np.float32), io) for _ in range(4)]
    cols = [rng.randn(96).astype(np.float32) for _ in range(4)]
    jcols = [jnp.asarray(np.pad(c[:, None], ((0, 0), (0, 127)))) for c in cols]
    ref = pk2.irfft_w_dual(*(j for j, _ in spec), *jcols)
    out = K.irfft_w_dual(*(t for _, t in spec), *(torch.from_numpy(c) for c in cols))
    assert len(out) == len(ref) == 2
    for a, r in zip(out, ref):
        _check(a, r)


def test_v2_equals_v3_at_f32():
    """The two placements run the same recurrence (the JAX package's
    tests/test_pallas_fft.py:190-214 on the port)."""
    psf, data = _loop_scene(7, (40, 56))
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    v3 = tsplit.run_rsplit(pre, P, 7, placement="v3")
    v2 = tsplit.run_rsplit(pre, P, 7, placement="v2")
    torch.testing.assert_close(v2, v3, rtol=0, atol=TOL_IDENTITY)


@pytest.mark.parametrize("io,tv,v", [("f32", "f32", "f32"), HEADLINE])
def test_v2_loop_matches_jax(jax_modes, monkeypatch, io, tv, v):
    """The v2 loop (plain versions) against JAX run_split_rfused with
    LPT_RFUSED_V3=0 (interpret mode) at 48 x 64, n = 20."""
    jax_modes(io=io, tv=tv, v=v)
    monkeypatch.setenv("LPT_RFUSED_V3", "0")
    psf, data = _loop_scene(12, (48, 64))
    ref, jsat = jsplit.run_split_rfused(jsplit.precompute_rsplit(psf, data),
                                        jsplit.ADMMParams(), 20, return_sat=True)
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    out, sat = tsplit.run_rsplit(pre, P, 20, return_sat=True, io=io, carry_tv=tv,
                                 carry_v=v, placement="v2")
    assert out.dtype == torch.float32 and out.shape == (48, 64)
    assert _nerr(out, ref) <= (TOL_F32_LOOP if io == "f32" else TOL_LOOP)
    if v == "i16":
        assert 0.0 < sat < 1.0
        assert sat == pytest.approx(float(jsat), rel=1e-2)
    else:
        assert sat == 0.0 and float(jsat) == 0.0


def test_v2_out_of_contract_data_saturates():
    """100x the max-normalized data clips the int16 v carry; v2 reads the
    stored (post-clip) carries, so it reports 1.0
    (tests/test_pallas_fft.py:258-262)."""
    psf, data = _loop_scene(11, (40, 56))
    pre = tsplit.precompute_rsplit(psf, 100.0 * data, device="cpu")
    _, sat = tsplit.run_rsplit(pre, P, 20, return_sat=True, io="bf16", carry_tv="i16",
                               carry_v="i16", placement="v2")
    assert sat >= 0.999


def _counting(ops):
    """``ops`` with every call counted by name."""
    calls = {}

    def wrap(name, fn):
        def f(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return f

    return SimpleNamespace(**{n: wrap(n, fn) for n, fn in vars(ops).items()}), calls


@pytest.mark.parametrize("placement,modes,want", [
    ("v2", HEADLINE, {"e1_rcarry": 5, "h_passA_pair": 10, "h_combine_dual": 5,
                      "irfft_w_dual": 5, "sat_scan_i16": 20}),
    ("v2", ("f32", "f32", "f32"), {"e1_rcarry": 5, "h_passA_pair": 10,
                                   "h_combine_dual": 5, "irfft_w_dual": 5}),
    ("v2", ("f32", "i16", "f32"), {"e1_rcarry": 5, "h_passA_pair": 10,
                                   "h_combine_dual": 5, "irfft_w_dual": 5,
                                   "sat_scan_i16": 15}),
    ("v3", HEADLINE, {"rfft_w": 1, "e1_rtv": 5, "h_passA_pair": 10, "h_combine_dual": 5,
                      "irfft_w_dual_state": 5, "sat_scan_i16": 1}),
])
def test_loop_calls_its_kernels(placement, modes, want):
    """Each placement calls exactly its kernels: v2 K8, K4, K5, K4, K9 and
    K7 on every int16 carry plane every iteration; v3 K1 once, K3, K4, K5,
    K4, K6, and K7 every 8th iteration.  Whatever P is, the counts are a
    single plane's (here P = 2 planes of one PSF)."""
    psf, data = _loop_scene(4, (48, 64))
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    for stack in (False, True):
        if stack:
            pre = pre._replace(data_pad=torch.stack([pre.data_pad, 0.5 * pre.data_pad]))
        ops, calls = _counting(K.PLAIN)
        io, tv, v = modes
        out = tsplit.run_split_rfused(pre, P, 5, ops=ops, io=io, carry_tv=tv, carry_v=v,
                                      placement=placement)
        assert calls == want
        assert tuple(out.shape) == ((2, 48, 64) if stack else (48, 64))


def test_placement_is_validated():
    psf, data = _loop_scene(3, (48, 64))
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    for bad in ("v1", "V2", ""):
        with pytest.raises(ValueError, match="placement"):
            tsplit.run_rsplit(pre, n_iter=1, placement=bad)


def test_carry_sat_fraction_matches_jax():
    """int16: max |x| / 32767 through K7's plain version; other dtypes:
    max |x| / scale (pallas_kernels2.py:337-344)."""
    rng = np.random.RandomState(32)
    x16 = rng.randint(-30000, 30001, (96, 128)).astype(np.int16)
    xf = rng.randn(96, 128).astype(np.float32)
    for x, scale in ((x16, 3.0), (xf, 7.0)):
        ref = float(pk2.carry_sat_fraction(jnp.asarray(x), scale))
        out = float(K.carry_sat_fraction(torch.from_numpy(x), scale))
        assert out == pytest.approx(ref, rel=1e-6)
