"""K18 ``h_passB_combine2`` and its composition ``fft_h_combine2`` on the
CPU: the plain version against the Pallas kernel in interpret mode (fed
the JAX ``h_passA`` outputs), the port's composition against the JAX one,
and the gap between ``fft_h_combine2`` and ``fft_h`` then
``fft_h_combine``, which checks the bound ``chip_smoke.py`` holds the
card to.

Tolerances: those of tests/test_torch_modes.py's ``_check`` (f32 within
1e-5 of the plane's max, bf16 within one ulp, at most 1 % of a plane not
bit-equal).  K18 keeps the rk spectrum in f32 where ``fft_h`` stores it at
the io dtype, so at bf16 io the two compositions differ by the rounding
of a (at most 2^-8 of max |R a|) and by one flip of the output's rounding
(at most 2^-7 of max |F|): ``kernels.TOL_COMBINE2`` bounds the
normalized gap by two bf16 ulps (2^-6), and the JAX package's own gap
(3.9e-3 and 6.8e-3 here) must be above 0 and within it; at f32 the two
are the same arithmetic.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.ops import split_fft as sf
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from test_torch_modes import TDT, _check, _pair
from test_torch_split import jax_full_modes  # noqa: F401

P = tsplit.ADMMParams()
H, W = 96, 256                 # the H axis factors as 12 x 8
VIEW = sf._factor(H) + (W,)


def _inputs(seed, io):
    """(JAX, port) pairs of rk (r, i), v (r, i), H (r, i) and R (at its
    loop scale, up to 1/mu3) as (H, W) split-order planes at ``io``."""
    rng = np.random.RandomState(seed)
    ins = [_pair(rng.randn(H, W).astype(np.float32), io) for _ in range(6)]
    return ins + [_pair(rng.rand(H, W).astype(np.float32) / P.mu3, io)]


def _check_all(out, ref):
    assert len(out) == len(ref) == 2
    for a, r in zip(out, ref):
        _check(a, r)


def _jgap(out, ref):
    """spectra_gap of two JAX pairs."""
    return K.spectra_gap(*[[convert.tensor(np.asarray(t), device="cpu") for t in z]
                         for z in (out, ref)])


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k18_plain_matches_pallas_on_jax_stage1(jax_full_modes, io):  # noqa: F811
    """The plain K18, fed the JAX K14 outputs of rk and v, against
    ``pk2.fft_h_combine2`` (whose kernel runs on those same outputs)."""
    jax_full_modes(io=io)
    J, T = zip(*_inputs(80, io))
    ref = pk2.fft_h_combine2(*J, H)
    stage1 = [convert.tensor(np.asarray(t), device="cpu")
              for z in (pk2.h_passA(J[0].reshape(VIEW), J[1].reshape(VIEW), H, False),
                        pk2.h_passA(J[2].reshape(VIEW), J[3].reshape(VIEW), H, False))
              for t in z]
    out = K.h_passB_combine2(*stage1, *(t.reshape(VIEW) for t in T[4:]), H)
    _check_all([t.reshape(H, W) for t in out], ref)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_fft_h_combine2_matches_pallas(jax_full_modes, io):  # noqa: F811
    jax_full_modes(io=io)
    J, T = zip(*_inputs(81, io))
    out = K.fft_h_combine2(*T, H)
    assert all(t.dtype == TDT[io] and tuple(t.shape) == (H, W) for t in out)
    _check_all(out, pk2.fft_h_combine2(*J, H))


@pytest.mark.parametrize("seed", [82, 83])
@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_combine2_gap_sets_the_chip_bound(jax_full_modes, io, seed):  # noqa: F811
    """fft_h_combine2 against fft_h then fft_h_combine, in the JAX package
    and in the port, within TOL_COMBINE2 (1e-5 at f32, 2^-6 at bf16 io);
    at bf16 io the JAX package's gap is above 0 (the rk spectrum's
    rounding shows)."""
    jax_full_modes(io=io)
    J, T = zip(*_inputs(seed, io))
    tol = K.TOL_COMBINE2[TDT[io]]
    jgap = _jgap(pk2.fft_h_combine2(*J, H),
                 pk2.fft_h_combine(J[2], J[3], *pk2.fft_h(J[0], J[1], H), *J[4:], H))
    tgap = K.spectra_gap(K.fft_h_combine2(*T, H),
                       K.fft_h_combine(T[2], T[3], *K.fft_h(T[0], T[1], H), *T[4:], H))
    assert jgap <= tol and tgap <= tol, (jgap, tgap)
    assert (jgap > 0.0) == (io == "bf16"), jgap


def test_fft_h_combine2_runs_k14_twice_then_k18_and_cpu_counts_nothing():
    """Through a counting kernel set the composition calls K14 twice and
    K18 once, on a plane and on a stack of 2 over 1 constant plane; the
    wrappers on CPU tensors count no launch and give the same result."""
    rng = np.random.RandomState(84)
    for lead in ((), (2,)):
        t = [torch.from_numpy(rng.randn(*lead, H, W).astype(np.float32)) for _ in range(4)]
        c = [torch.from_numpy(rng.randn(H, W).astype(np.float32)) for _ in range(3)]
        calls = dict.fromkeys(("h_passA", "h_passB_combine2"), 0)

        def counting(name):
            def fn(*a, **k):
                calls[name] += 1
                return getattr(K.PLAIN, name)(*a, **k)
            return fn

        ref = K.fft_h_combine2(*t, *c, H, ops=SimpleNamespace(**{k: counting(k) for k in calls}))
        assert calls == {"h_passA": 2, "h_passB_combine2": 1}
        K.reset_launches()
        out = K.fft_h_combine2(*t, *c, H)
        assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
        assert all(tuple(z.shape) == tuple(t[0].shape) for z in out)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k18_rejects_what_the_kernel_does_not_take():
    """Mixed data dtypes raise TypeError; constants that do not divide the
    planes, or planes that do not view the H axis, raise ValueError."""
    rng = np.random.RandomState(85)

    def st(*lead):
        return torch.from_numpy(rng.randn(*lead, *VIEW).astype(np.float32))

    x = [st(4) for _ in range(4)]
    with pytest.raises(TypeError):
        K.h_passB_combine2(*x[:3], x[3].to(torch.int16), st(), st(), st(), H)
    with pytest.raises(ValueError):
        K.h_passB_combine2(*x, st(3), st(3), st(3), H)
    with pytest.raises(ValueError):
        K.h_passB_combine2(*x, st(), st(), st(), 2 * H)
