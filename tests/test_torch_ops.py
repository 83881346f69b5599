"""The port's operators and its kernels' plain versions against the JAX
package, on the CPU.  Inputs come from numpy with a fixed seed and go
unchanged to both; Pallas kernels run in interpret mode."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.eval import metrics as jmetrics
from lenslesspicam_tpu.ops import fft_conv as jfft_conv
from lenslesspicam_tpu.ops import padding as jpadding
from lenslesspicam_tpu.ops import pallas_fft as pf
from lenslesspicam_tpu.ops import pallas_kernels2 as pk2
from lenslesspicam_tpu.ops import tv as jtv

from lenslesspicam_tpu_torch.eval import metrics as tmetrics
from lenslesspicam_tpu_torch.ops import fft_conv as tfft_conv
from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.ops import padding as tpadding
from lenslesspicam_tpu_torch.ops import split_fft as sf
from lenslesspicam_tpu_torch.ops import tv as ttv

TOL_KERNEL = 1e-4    # max abs error, as tests/test_pallas_fft.py:158-161


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def interpret():
    pk2._set_interpret(True)
    try:
        yield
    finally:
        pk2._set_interpret(False)


@pytest.mark.parametrize("policy", ["ref", "even", "tpu"])
def test_padding_matches_jax(policy):
    for n in (1, 7, 48, 64, 100, 641, 3040, 4056):
        assert tpadding.padded_size(n, policy) == jpadding.padded_size(n, policy)
        assert tpadding.next_fast_len(n) == jpadding.next_fast_len(n)


def test_tv_ops_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 1, 12, 16, 1).astype(np.float32)
    u = rng.randn(2, 1, 12, 16, 1, 2).astype(np.float32)
    np.testing.assert_allclose(_np(ttv.soft_thresh(_t(x), 0.3)),
                               np.asarray(jtv.soft_thresh(jnp.asarray(x), 0.3)), atol=1e-7)
    np.testing.assert_allclose(_np(ttv.finite_diff(_t(x))),
                               np.asarray(jtv.finite_diff(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(_np(ttv.finite_diff_adj(_t(u))),
                               np.asarray(jtv.finite_diff_adj(jnp.asarray(u))), atol=1e-6)
    np.testing.assert_allclose(
        _np(ttv.finite_diff_gram_spectrum((1, 24, 32, 1))),
        np.asarray(jtv.finite_diff_gram_spectrum((1, 24, 32, 1))), atol=1e-6)


@pytest.mark.parametrize("pad,norm", [(True, "ortho"), (False, "backward")])
def test_fft_convolver_matches_jax(pad, norm):
    rng = np.random.RandomState(1)
    psf = rng.rand(1, 24, 32, 1).astype(np.float32)
    jc = jfft_conv.FFTConvolver.from_psf(jnp.asarray(psf), pad=pad, norm=norm)
    tc = tfft_conv.FFTConvolver.from_psf(psf, pad=pad, norm=norm, device="cpu")
    assert tc.padded_shape == jc.padded_shape and tc.start == jc.start
    shape = (2, 1, 24, 32, 1) if pad else (2,) + tuple(jc.padded_shape)
    x = rng.randn(*shape).astype(np.float32)
    for name in ("convolve", "deconvolve"):
        ref = np.asarray(getattr(jc, name)(jnp.asarray(x)))
        out = _np(getattr(tc, name)(_t(x)))
        np.testing.assert_allclose(out / np.abs(ref).max(), ref / np.abs(ref).max(),
                                   atol=1e-6)
    np.testing.assert_allclose(_np(tc.mag_sq()), np.asarray(jc.mag_sq()), rtol=1e-5,
                               atol=1e-6)


def test_metrics_match_jax():
    rng = np.random.RandomState(2)
    a = rng.rand(3, 8, 8, 1).astype(np.float32)
    b = rng.rand(3, 8, 8, 1).astype(np.float32)
    np.testing.assert_allclose(_np(tmetrics.psnr(_t(a), _t(b))),
                               np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics.mse(_t(a), _t(b))),
                               float(jmetrics.mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    z = np.concatenate([a[:1] * 0, a[1:]])
    np.testing.assert_allclose(_np(tmetrics.max_normalize(_t(z))),
                               np.asarray(jmetrics.max_normalize(jnp.asarray(z))), atol=1e-7)


@pytest.mark.parametrize("n", [96, 128, 4096, 6144])
def test_split_plans_equal_jax(n):
    assert sf._factor(n) == pf._factor(n)
    np.testing.assert_array_equal(sf.split_order_indices(n), pf.split_order_indices(n))
    for inverse in (False, True):
        for a, b in zip(sf._plan(n, inverse), pf._plan(n, inverse)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    er, ei = sf._rplan(2 * n)
    jr = pf._rplan(2 * n)
    np.testing.assert_array_equal(er, jr[3].reshape(-1))
    np.testing.assert_array_equal(ei, jr[4].reshape(-1))


def test_spectrum_to_split_matches_jax():
    rng = np.random.RandomState(3)
    s = (rng.randn(96, 128) + 1j * rng.randn(96, 128)).astype(np.complex64)
    np.testing.assert_array_equal(sf.spectrum_to_split(s, axes=(0, 1)),
                                  pf.spectrum_to_split(s, axes=(0, 1)))
    np.testing.assert_array_equal(sf.spectrum_to_half_split(s), pf.spectrum_to_half_split(s))


@pytest.mark.parametrize("n", [64, 128, 256])
def test_rfft_w_split_matches_numpy(n):
    """Packed-real half-spectrum W transform == numpy rfft in split order
    (relative 1e-5); exact round trip (atol 1e-4)."""
    rng = np.random.RandomState(7)
    m = n // 2
    x = rng.randn(5, n).astype(np.float32)
    zr, zi = sf.rfft_w_split(sf.to_split_layout(_t(x)))
    Z = np.fft.fft(x, axis=1)
    gold = Z[:, :m][:, sf.split_order_indices(m)]
    gold[:, 0] = Z[:, 0].real + 1j * Z[:, m].real
    got = _np(zr) + 1j * _np(zi)
    assert np.abs(got - gold).max() / np.abs(gold).max() < 1e-5
    back = _np(sf.from_split_layout(sf.irfft_w_split(zr, zi)))
    np.testing.assert_allclose(back, x, atol=1e-4)


@pytest.mark.parametrize("rows,n,block_rows", [(96, 128, None), (24, 256, 8)])
def test_k1_rfft_w_plain_matches_pallas(interpret, rows, n, block_rows):
    rng = np.random.RandomState(8)
    x = rng.randn(rows, n).astype(np.float32)
    ref = pk2.rfft_w(jnp.asarray(x), block_rows=block_rows)
    out = K.rfft_w(_t(x))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=TOL_KERNEL)
    back = _np(K.irfft_w_plain(*out))
    np.testing.assert_allclose(back, x, atol=TOL_KERNEL)


def test_k3_e1_rtv_plain_matches_pallas(interpret):
    rng = np.random.RandomState(9)
    img, a0, a1, b = (rng.randn(96, 128).astype(np.float32) for _ in range(4))
    ref = pk2.e1_rtv(*(jnp.asarray(v) for v in (img, a0, a1, b)), 1e-5, 4e-5, 1e-4)
    out = K.e1_rtv(*(_t(v) for v in (img, a0, a1, b)), 1e-5, 4e-5, 1e-4)
    for a, r in zip(out[:5], ref[:5]):
        np.testing.assert_allclose(_np(a), np.asarray(r), atol=TOL_KERNEL)
    assert out[5] == 0.0 and float(np.max(np.asarray(ref[5]))) == 0.0


@pytest.mark.parametrize("inverse", [False, True])
def test_k4_h_passA_pair_plain_matches_pallas(interpret, inverse):
    rng = np.random.RandomState(10)
    xs = [rng.randn(12, 8, 64).astype(np.float32) for _ in range(4)]
    ref = pk2.h_passA_pair(*(jnp.asarray(x) for x in xs), 96, inverse)
    out = K.h_passA_pair(*(_t(x) for x in xs), 96, inverse)
    for i in range(2):
        for k in range(2):
            np.testing.assert_allclose(_np(out[i][k]), np.asarray(ref[i][k]),
                                       atol=TOL_KERNEL)


def test_k5_fft_h_combine_dual_plain_matches_pallas(interpret):
    rng = np.random.RandomState(11)
    xs = [rng.randn(96, 64).astype(np.float32) for _ in range(7)]
    ref = pk2.fft_h_combine_dual(*(jnp.asarray(x) for x in xs), 96)
    out = K.fft_h_combine_dual(*(_t(x) for x in xs), 96)
    for i in range(2):
        for k in range(2):
            np.testing.assert_allclose(_np(out[i][k]), np.asarray(ref[i][k]),
                                       atol=TOL_KERNEL)


def test_k6_irfft_w_dual_state_plain_matches_pallas(interpret):
    rng = np.random.RandomState(12)
    spec = [rng.randn(96, 64).astype(np.float32) for _ in range(4)]
    cols = [rng.randn(96).astype(np.float32) for _ in range(4)]
    v, dp = rng.randn(96, 128).astype(np.float32), rng.randn(96, 128).astype(np.float32)
    mask = (rng.rand(96, 128) > 0.5).astype(np.float32)
    zcols = []
    for c in cols:
        z = np.zeros((96, 128), np.float32)
        z[:, 0] = c
        zcols.append(jnp.asarray(z))
    ref = pk2.irfft_w_dual_state(*(jnp.asarray(s) for s in spec), *zcols,
                                 jnp.asarray(v), jnp.asarray(mask), jnp.asarray(dp),
                                 1e-6, with_sat=False)
    out = K.irfft_w_dual_state(*(_t(s) for s in spec), *(_t(c) for c in cols),
                               _t(v), _t(mask), _t(dp), 1e-6)
    for a, r in zip(out, ref[:4]):
        np.testing.assert_allclose(_np(a), np.asarray(r), atol=TOL_KERNEL)


def test_wrappers_on_cpu_use_plain_and_count_nothing():
    K.reset_launches()
    rng = np.random.RandomState(13)
    x = _t(rng.randn(96, 128).astype(np.float32))
    for got, want in zip(K.rfft_w(x), K.rfft_w_plain(x)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    planes = [_t(rng.randn(12, 8, 64).astype(np.float32)) for _ in range(7)]
    K.h_passA_pair(*planes[:4], 96, False)
    K.h_combine_dual(*planes, 96)
    zr, zi = K.rfft_w(x)
    torch.testing.assert_close(K.irfft_w(zr, zi), K.irfft_w_plain(zr, zi), rtol=0, atol=0)
    x16 = (x * 1000).to(torch.int16)
    torch.testing.assert_close(K.sat_scan_i16(x16), K.sat_scan_i16_plain(x16), rtol=0, atol=0)
    assert K.launch_counts() == {name: 0 for name in K.launch_counts()}
    assert {"irfft_w", "sat_scan_i16"} <= set(K.launch_counts())


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrappers_reject_bad_input(bad):
    x = torch.zeros(8, 128)
    if bad == "dtype":
        with pytest.raises(TypeError):
            K.rfft_w(x.double())
    elif bad == "shape":
        with pytest.raises(ValueError):
            K.e1_rtv(x, x, x, torch.zeros(8, 64), 1e-5, 4e-5, 1e-4)
    else:
        with pytest.raises(ValueError):
            K.rfft_w(torch.zeros(8, 128, device="meta"))


@pytest.mark.parametrize("case", ["mixed_carries", "mixed_io", "irfft_out"])
def test_cuda_dtype_combination_not_built_raises(case):
    """A dtype combination the plain versions take on the CPU but the CUDA
    kernels were not built for raises TypeError on a non-CPU tensor
    (checked on the meta device, without a card), before any launch."""
    def z(*shape, dtype=torch.float32, device="meta"):
        return torch.zeros(*shape, dtype=dtype, device=device)

    bf, i16 = torch.bfloat16, torch.int16
    if case == "mixed_carries":
        args = (z(8, 128, dtype=bf), z(8, 128, dtype=i16), z(8, 128, dtype=bf),
                z(8, 128), 1e-5, 4e-5, 1e-4)
        fn = K.e1_rtv
    elif case == "mixed_io":
        args = (z(12, 8, 64, dtype=bf), z(12, 8, 64), z(12, 8, 64), z(12, 8, 64), 96, False)
        fn = K.h_passA_pair
    else:
        args = (z(8, 64, dtype=bf), z(8, 64))
        fn = K.irfft_w
    cpu_args = [torch.zeros_like(a, device="cpu") if isinstance(a, torch.Tensor) else a
                for a in args]
    if case == "mixed_carries":
        fn(*cpu_args)        # the plain version takes it
    with pytest.raises(TypeError):
        fn(*args)


def test_cuda_factor_limits():
    """The CUDA kernels take every factorization the plain versions take
    (the split designs' general form, csrc/lpt_dft.cuh general_form):
    the 12 MP and test grids, and the lengths whose factors are not
    multiples of 4 or whose n1 is 1, which the kernels once refused."""
    assert K.factors(4096) == (32, 128)
    assert K.factors(6144) == (48, 128)
    assert K.factors(64) == (8, 8)
    assert K.factors(96) == (12, 8)
    for n, f in ((128, (1, 128)), (6, (3, 2)), (7, (7, 1))):
        assert K.factors(n) == f
