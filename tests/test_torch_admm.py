"""The port's solvers against the JAX package on the CPU: the exact ADMM
solver, the fused half-spectrum solver (the port's kernels' plain
versions against the Pallas kernels in interpret mode), the solver
constants, the user-facing ADMM class, and state carried across with
``convert``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lenslesspicam_tpu as lpt
from lenslesspicam_tpu.ops import pallas_kernels2 as pk2
from lenslesspicam_tpu.recon import admm as jadmm
from lenslesspicam_tpu.recon import admm_split as jsplit

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from lenslesspicam_tpu_torch.recon.base import ADMM, apply_admm

# normalized max error; a transcription of admm.step into torch.fft gave
# 1.8e-7 (n = 1) to 8.2e-7 (n = 20) against admm.run_jit
TOL_SOLVER = 1e-5


def _scene(seed, shape=(48, 64)):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(*shape).astype(np.float32)
    return psf, data


def _nerr(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-9)


@pytest.fixture
def interpret():
    pk2._set_interpret(True)
    try:
        yield
    finally:
        pk2._set_interpret(False)


@pytest.mark.parametrize("n_iter", [1, 5, 10, 20])
def test_exact_solver_matches_jax(n_iter):
    psf, data = _scene(12)
    conv = jadmm.make_convolver(psf[None, :, :, None])
    ref = jadmm.run_jit(conv, data[None, None, :, :, None], n_iter=n_iter)
    tconv = tadmm.make_convolver(psf[None, :, :, None], device="cpu")
    out = tadmm.run(tconv, data[None, None, :, :, None], n_iter=n_iter)
    assert out.shape == ref.shape
    assert _nerr(out, ref) <= TOL_SOLVER


def test_exact_solver_initial_estimate_matches_jax():
    psf, data = _scene(14)
    conv = jadmm.make_convolver(psf[None, :, :, None])
    init = np.random.RandomState(1).rand(1, *conv.padded_shape).astype(np.float32)
    ref = jadmm.run_jit(conv, data[None, None, :, :, None], n_iter=5,
                        initial_est=jnp.asarray(init))
    tconv = tadmm.make_convolver(psf[None, :, :, None], device="cpu")
    out = tadmm.run(tconv, data[None, None, :, :, None], n_iter=5,
                    initial_est=torch.from_numpy(init))
    assert _nerr(out, ref) <= TOL_SOLVER


def test_exact_step_from_converted_jax_state():
    """One port step from the JAX solver's converted convolver, constants
    and state (5 JAX iterations in) == the JAX step."""
    psf, data = _scene(3)
    params = jadmm.ADMMParams()
    conv = jadmm.make_convolver(psf[None, :, :, None])
    pre = jadmm.precompute(conv, data[None, None, :, :, None], params)
    state = jadmm.init_state(conv, 1, None, params)
    for _ in range(5):
        state = jadmm.step(state, conv, pre, params)
    ref = jadmm.step(state, conv, pre, params)

    tconv = convert.convolver(np.asarray(conv.H), conv.psf_shape, conv.padded_shape,
                              conv.start, conv.pad, conv.norm, conv.shift_folded,
                              device="cpu")
    tpre = convert.admm_precomp({f: np.asarray(getattr(pre, f)) for f in pre._fields},
                                device="cpu")
    tstate = convert.admm_state({f: np.asarray(getattr(state, f)) for f in state._fields},
                                device="cpu")
    out = tadmm.step(tstate, tconv, tpre, convert.admm_params(params))
    for f in ref._fields:
        assert _nerr(getattr(out, f), getattr(ref, f)) <= TOL_SOLVER, f


def test_precompute_rsplit_equals_jax():
    psf, data = _scene(5)
    ref = jsplit.precompute_rsplit(psf, data)
    out = tsplit.precompute_rsplit(psf, data, device="cpu")
    for f in tsplit.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
    assert (out.psf_shape, out.padded_shape, out.start) == (
        ref.psf_shape, ref.padded_shape, ref.start)


def test_rsplit_matches_jax_and_exact(interpret):
    """The fused slice (plain versions on the CPU) == JAX run_rsplit_jit
    (Pallas kernels in interpret mode) and == the port's exact solver,
    at 48 x 64, n = 10, normalized 1e-5 (tests/test_pallas_fft.py:166)."""
    psf, data = _scene(12)
    ref = jsplit.run_rsplit_jit(jsplit.precompute_rsplit(psf, data),
                                jsplit.ADMMParams(), 10)
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    out, sat = tsplit.run_rsplit(pre, tsplit.ADMMParams(), 10, return_sat=True)
    assert sat == 0.0
    assert _nerr(out, ref) <= TOL_SOLVER
    tconv = tadmm.make_convolver(psf[None, :, :, None], device="cpu")
    exact = tadmm.run(tconv, data[None, None, :, :, None], n_iter=10)[0, 0, :, :, 0]
    assert _nerr(out, exact.numpy()) <= TOL_SOLVER


@pytest.mark.parametrize("shape", [(48, 64), (40, 56)])
def test_rsplit_from_converted_jax_constants(shape):
    """The fused slice run from constants converted out of JAX == the
    same slice from the port's own precompute."""
    psf, data = _scene(7, shape)
    jpre = jsplit.precompute_rsplit(psf, data)
    pre = convert.rsplit_precomp({f: np.asarray(getattr(jpre, f)) for f in tsplit.ARRAY_FIELDS},
                                 jpre.psf_shape, jpre.padded_shape, jpre.start,
                                 device="cpu")
    own = tsplit.precompute_rsplit(psf, data, device="cpu")
    a = tsplit.run_rsplit(pre, n_iter=5)
    b = tsplit.run_rsplit(own, n_iter=5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_admm_class_matches_jax():
    psf, data = _scene(21)
    jrec = lpt.ADMM(psf[None, :, :, None])
    jrec.set_data(data[None, :, :, None])
    ref = jrec.apply(n_iter=10)
    rec = ADMM(psf[None, :, :, None], device="cpu")
    rec.set_data(data[None, :, :, None])
    out = rec.apply(n_iter=10)
    assert tuple(out.shape) == tuple(ref.shape) == (1, 48, 64, 1)
    assert _nerr(out, ref) <= TOL_SOLVER
    one_shot = apply_admm(psf[None, :, :, None], data[None, :, :, None], n_iter=10,
                          device="cpu")
    torch.testing.assert_close(one_shot, out, rtol=0, atol=0)
    batch = rec.batch_apply(np.stack([data, data])[:, None, :, :, None], n_iter=10)
    assert tuple(batch.shape) == (2, 1, 48, 64, 1)
    assert _nerr(batch[1], out.numpy()) <= TOL_SOLVER
    bg = rec.apply(n_iter=10, background=np.zeros((1, 48, 64, 1), np.float32))
    torch.testing.assert_close(bg, out, rtol=0, atol=0)
