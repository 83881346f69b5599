"""The port's classical solvers and public API against the JAX package on
the CPU: ``make_convolver``, the noise models, the GD family, APGD (its
cubic PSF resize and early stop), plug-and-play ADMM, the reconstruction
classes' ``apply`` (``disp_iter`` chunks, callbacks, warm starts,
``reconstruction_error``), Tikhonov, the MirFlickr ADMM, the package's
public names and the full-width solver's default backend.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances are max |port - JAX| / max |JAX|:

- the GD family, APGD and ``run_pnp`` at n = 20: 1e-4 (the golden
  solver tolerance of tests/test_solvers_golden.py);
- ``apply`` in chunks against one run, ``reconstruction_error``, warm
  starts, Tikhonov, the resizes and the noise arithmetic: 1e-5;
- the full-width solver's default backend against ``run_split_jit``: the
  1e-5 of tests/test_torch_split.py;
- APGD's early-stop iteration count: equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lenslesspicam_tpu as jlpt
from lenslesspicam_tpu.ops import noise as jnoise
from lenslesspicam_tpu.recon import admm as jadmm
from lenslesspicam_tpu.recon import admm_split as jsplit
from lenslesspicam_tpu.recon import apgd as japgd
from lenslesspicam_tpu.recon import gd as jgd
from lenslesspicam_tpu.recon import mirflickr as jmir
from lenslesspicam_tpu.recon import tikhonov as jtik

import lenslesspicam_tpu_torch as tlpt
from lenslesspicam_tpu_torch.ops import fft_conv as tfft
from lenslesspicam_tpu_torch.ops import noise as tnoise
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from lenslesspicam_tpu_torch.recon import apgd as tapgd
from lenslesspicam_tpu_torch.recon import gd as tgd
from lenslesspicam_tpu_torch.recon import mirflickr as tmir

from test_torch_scripts import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = "cpu"
TOL_SOLVER = 1e-4
TOL_EXACT = 1e-5
SHAPES = [(1, 32, 40, 3), (1, 33, 27, 1)]   # tests/test_solvers_golden.py:26
CLASSES = ["ADMM", "FISTA", "GradientDescent", "NesterovGradientDescent"]


def _problem(shape=(1, 32, 40, 3), seed=0):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    return psf, rng.rand(*shape[1:]).astype(np.float32)


def _rel(out, ref):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


# --- module 1: make_convolver ------------------------------------------------

@pytest.mark.parametrize("pad,norm", [(True, "ortho"), (False, "backward"), (True, "forward")])
def test_make_convolver_matches_jax(pad, norm):
    psf, data = _problem((1, 24, 30, 3), seed=1)
    jc = jlpt.make_convolver(psf, pad=pad, norm=norm)
    tc = tlpt.make_convolver(psf, pad=pad, norm=norm, device=CPU)
    assert tlpt.make_convolver is tfft.make_convolver
    assert (tc.padded_shape, tc.start, tc.norm) == (jc.padded_shape, jc.start, jc.norm)
    assert _rel(tc.H, jc.H) <= TOL_EXACT
    x = data[None, None] if pad else np.asarray(jc.pad_input(jnp.asarray(data[None, None])))
    for op in ("convolve", "deconvolve"):
        assert _rel(getattr(tc, op)(torch.from_numpy(np.array(x))),
                    getattr(jc, op)(jnp.asarray(x))) <= TOL_EXACT


# --- module 2: noise ----------------------------------------------------------

@pytest.mark.parametrize("snr", [5.0, 20.0])
def test_noise_arithmetic_matches_jax(snr):
    """The same normal draw through both packages (jax.random has no torch
    counterpart, so the port's helpers take the draw)."""
    x = np.random.RandomState(2).rand(2, 1, 16, 20, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    normal = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    xt = torch.from_numpy(x)
    assert _rel(tnoise._shot_noise(xt, snr, normal),
                jnoise.add_shot_noise(jnp.asarray(x), snr, key)) <= TOL_EXACT
    assert _rel(tnoise._gaussian_noise(xt, snr, normal),
                jnoise.add_gaussian_noise_snr(jnp.asarray(x), snr, key)) <= TOL_EXACT


def test_noise_entry_points_use_the_generator():
    x = torch.from_numpy(np.random.RandomState(4).rand(64, 64).astype(np.float32))
    for fn in (tnoise.add_shot_noise, tnoise.add_gaussian_noise_snr):
        a = fn(x, 10.0, torch.Generator().manual_seed(1))
        b = fn(x, 10.0, torch.Generator().manual_seed(1))
        c = fn(x, 10.0, torch.Generator().manual_seed(2))
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert a.shape == x.shape and a.device.type == CPU
    noisy = tnoise.add_gaussian_noise_snr(x, 10.0, torch.Generator().manual_seed(5))
    snr = 10 * np.log10(float(torch.mean(x ** 2) / torch.mean((noisy - x) ** 2)))
    assert abs(snr - 10.0) < 0.5


# --- module 4: the GD family ---------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gd_family_matches_jax(shape):
    psf, data = _problem(shape, seed=1)
    jc = jgd.make_convolver(psf)
    tc = tgd.make_convolver(psf, device=CPU)
    assert _rel(tgd.step_size(tc), jgd.step_size(jc)) <= TOL_EXACT
    assert _rel(tgd.half_intensity_init(tc, psf, 2), jgd.half_intensity_init(jc, psf, 2)) == 0
    for method in ("vanilla", "nesterov", "fista"):
        ref = jgd.run(jc, psf, data, 20, method=method)
        out = tgd.run(tc, psf, data, 20, method=method)
        assert out.shape == (1,) + shape and _rel(out, ref) <= TOL_SOLVER, method
    ref = jgd.fista(psf, data, n_iter=20)
    assert _rel(tgd.fista(psf, data, n_iter=20, device=CPU), ref) <= TOL_SOLVER


def test_gd_state_continues_exactly():
    """Two calls continuing ``return_state`` equal one call, per method,
    and the states are the JAX package's."""
    psf, data = _problem()
    jc, tc = jgd.make_convolver(psf), tgd.make_convolver(psf, device=CPU)
    for method in ("vanilla", "nesterov", "fista"):
        full = tgd.run(tc, psf, data, 7, method=method)
        img, st = tgd.run(tc, psf, data, 3, method=method, return_state=True)
        _, jst = jgd.run(jc, psf, data, 3, method=method, return_state=True)
        for a, b in zip(jax.tree_util.tree_leaves(jst),
                        st if isinstance(st, tuple) else (st,)):
            assert _rel(b, a) <= TOL_EXACT
        out = tgd.run(tc, psf, data, 4, method=method, initial_state=st)
        assert _rel(out, full) <= TOL_EXACT
    with pytest.raises(ValueError, match="unknown method"):
        tgd.run(tc, psf, data, 1, method="adam")


# --- module 5: plug-and-play ADMM -----------------------------------------------

def _t_denoise(x, level):
    return (x + torch.roll(x, 1, dims=-3) + torch.roll(x, 1, dims=-2)) / (3.0 + 1e-3 * level)


def _j_denoise(x, level):
    return (x + jnp.roll(x, 1, axis=-3) + jnp.roll(x, 1, axis=-2)) / (3.0 + 1e-3 * level)


@pytest.mark.parametrize("use_dual", [False, True])
def test_run_pnp_matches_jax(use_dual):
    psf, data = _problem((1, 24, 30, 3), seed=6)
    jc, tc = jadmm.make_convolver(psf), tadmm.make_convolver(psf, device=CPU)
    init = np.random.RandomState(7).rand(*jc.padded_shape).astype(np.float32)
    for est in (None, init):
        ref = jadmm.run_pnp(jc, data, _j_denoise, n_iter=20, use_dual=use_dual,
                            initial_est=None if est is None else jnp.asarray(est))
        out = tadmm.run_pnp(tc, data, _t_denoise, n_iter=20, use_dual=use_dual,
                            initial_est=est)
        assert out.shape == (1, 1, 24, 30, 3) and _rel(out, ref) <= TOL_SOLVER


# --- module 7: the reconstruction classes ------------------------------------------

@pytest.mark.parametrize("name", CLASSES)
def test_apply_disp_iter_exact_continuation(name):
    """tests/test_api.py's chunked solve on the port, held to one run and
    to the JAX package's run."""
    rng = np.random.RandomState(0)
    psf = rng.rand(1, 32, 40, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(1, 1, 32, 40, 3).astype(np.float32)
    r = getattr(tlpt, name)(psf, device=CPU)
    r.set_data(data)
    full = r.apply(n_iter=12)
    seen = []
    r2 = getattr(tlpt, name)(psf, device=CPU)
    r2.set_data(data)
    chunked = r2.apply(n_iter=12, disp_iter=5, callback=lambda img, it: seen.append(it),
                       unknown_keyword=1)
    assert seen == [5, 10, 12]
    assert _rel(chunked, full) <= TOL_EXACT
    j = getattr(jlpt, name)(psf)
    j.set_data(data)
    assert _rel(full, j.apply(n_iter=12)) <= TOL_SOLVER


def test_reconstruction_error_matches_jax():
    psf, data = _problem()
    for name in CLASSES:
        t, j = getattr(tlpt, name)(psf, device=CPU), getattr(jlpt, name)(psf)
        t.set_data(data)
        j.set_data(data)
        out = t.apply(n_iter=5)
        err = t.reconstruction_error(out, data[None, None])
        assert err.shape == (1,) and bool(torch.isfinite(err).all())
        ref = j.reconstruction_error(j.apply(n_iter=5), data[None, None])
        assert _rel(err, ref) <= TOL_EXACT, name
        assert _rel(t.reconstruction_error(out, data[None, None], normalize=False),
                    j.reconstruction_error(np.asarray(out), data[None, None],
                                           normalize=False)) <= TOL_EXACT


def test_initial_estimate_warm_start():
    """tests/test_api.py's warm start, held to the JAX package; ADMM's
    estimate is placed on the padded grid (the JAX package does that only
    in its chunked path, so it is held to ``apply(disp_iter=n)`` there)."""
    psf, data = _problem()
    est = np.random.RandomState(8).rand(1, 32, 40, 3).astype(np.float32)
    for name in ("FISTA", "GradientDescent", "NesterovGradientDescent"):
        base = getattr(tlpt, name)(psf, device=CPU)
        base.set_data(data)
        warm = getattr(tlpt, name)(psf, initial_est=np.zeros_like(est), device=CPU)
        warm.set_data(data)
        out = warm.apply(n_iter=3)
        assert out.shape == (1, 32, 40, 3) and not torch.allclose(out, base.apply(n_iter=3))
        jw = getattr(jlpt, name)(psf, initial_est=np.zeros_like(est))
        jw.set_data(data)
        assert _rel(out, jw.apply(n_iter=3)) <= TOL_EXACT
    t = tlpt.ADMM(psf, initial_est=est, device=CPU)
    t.set_data(data)
    j = jlpt.ADMM(psf, initial_est=est)
    j.set_data(data)
    out = t.apply(n_iter=6)
    assert _rel(out, j.apply(n_iter=6, disp_iter=6)) <= TOL_EXACT
    assert _rel(t.apply(n_iter=6, disp_iter=4), out) <= TOL_EXACT
    with pytest.raises(ValueError, match="at least 4D"):
        tlpt.FISTA(psf, initial_est=est[0], device=CPU)


def test_apply_saves_each_chunk(tmp_path):
    psf, data = _problem()
    r = tlpt.FISTA(psf, device=CPU)
    r.set_data(data)
    r.apply(n_iter=4, disp_iter=2, save=str(tmp_path), gamma=2.2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["recon_iter2.png",
                                                           "recon_iter4.png"]


# --- module 8: APGD ---------------------------------------------------------------

APGD_CASES = {"nonneg": {}, "l1": dict(prox_penalty="l1", prox_lambda=1e-3),
              "l2_none": dict(prox_penalty=None, diff_penalty="l2"),
              "plain": dict(acceleration=False)}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_apgd_matches_jax(shape):
    psf, data = _problem(shape, seed=9)
    jc, tc = japgd.make_convolver(psf), tapgd.make_convolver(psf, device=CPU)
    for name, kw in APGD_CASES.items():
        out = tapgd.run(tc, data, 20, **kw)
        assert out.shape == (1,) + shape
        assert _rel(out, japgd.run(jc, data, 20, **kw)) <= TOL_SOLVER, name
    assert tlpt.APGD is tapgd.run
    assert tlpt.APGDPriors.all_values() == jlpt.APGDPriors.all_values()


@pytest.mark.parametrize("hw,new", [((32, 40), (16, 20)), ((33, 27), (11, 9)),
                                    ((20, 24), (40, 36)), ((30, 40), (30, 20))])
def test_cubic_resize_matches_jax_image_resize(hw, new):
    psf = np.random.RandomState(10).rand(2, *hw, 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(psf), (2,) + new + (3,), method="cubic")
    assert _rel(tapgd.resize_cubic(psf, new), ref) <= TOL_EXACT


def test_apgd_downsampled_measurement_matches_jax():
    psf, _ = _problem((1, 34, 42, 3), seed=11)
    data = np.random.RandomState(12).rand(17, 14, 3).astype(np.float32)
    jc, jds = japgd.make_downsampling_convolver(psf, data.shape)
    tc, tds = tapgd.make_downsampling_convolver(psf, data.shape, device=CPU)
    assert tds == jds == (2, 3) and tc.psf_shape == jc.psf_shape
    assert _rel(tc.H, jc.H) <= TOL_EXACT
    out = tapgd.run(tc, data, 20, ds_factor=tds)
    assert _rel(out, japgd.run(jc, data, 20, ds_factor=jds)) <= TOL_SOLVER
    one_shot = tapgd.apgd(psf, data, n_iter=20, img_shape=data.shape, device=CPU)
    assert _rel(one_shot, out) == 0
    with pytest.raises(ValueError, match="smaller than PSF"):
        tapgd.make_downsampling_convolver(psf, (40, 10), device=CPU)


def test_apgd_early_stop_count_matches_jax():
    """With rel_error both stop after the same number of iterations: the
    count is read by matching each package's early-stopped result against
    its own fixed-count runs."""
    psf, data = _problem(seed=13)
    jc, tc = japgd.make_convolver(psf), tapgd.make_convolver(psf, device=CPU)
    tol, cap = 5e-2, 30
    jrun = jax.jit(lambda c, d, n: japgd.run(c, d, n))
    jfixed = [np.asarray(jrun(jc, data, jnp.asarray(k))) for k in range(1, cap + 1)]
    tfixed = [tapgd.run(tc, data, k).numpy() for k in range(1, cap + 1)]
    jstop = np.asarray(japgd.run(jc, data, cap, rel_error=tol))
    tstop = tapgd.run(tc, data, cap, rel_error=tol).numpy()
    jk = 1 + int(np.argmin([np.abs(x - jstop).max() for x in jfixed]))
    tk = 1 + int(np.argmin([np.abs(x - tstop).max() for x in tfixed]))
    assert np.abs(tfixed[tk - 1] - tstop).max() == 0
    assert 1 < jk < cap and tk == jk


# --- module 9: Tikhonov ---------------------------------------------------------------

def test_tikhonov_matches_jax():
    rng = np.random.RandomState(14)
    image_shape, res = (20, 24), (30, 36)
    P, Q = rng.randn(res[0], image_shape[0]), rng.randn(res[1], image_shape[1])
    mask = SimpleNamespace(resolution=res, get_conv_matrices=lambda shape: (P, Q))
    meas = rng.rand(*res, 3).astype(np.float32)
    for kw in (dict(P=P, Q=Q), {}):
        t = tlpt.CodedApertureReconstruction(mask, image_shape, lmbd=1e-2, device=CPU, **kw)
        j = jtik.CodedApertureReconstruction(mask, image_shape, lmbd=1e-2, **kw)
        out = t.apply(meas)
        assert out.shape == image_shape + (3,) and _rel(out, j.apply(meas)) <= TOL_EXACT
    with pytest.raises(ValueError, match="P shape"):
        tlpt.CodedApertureReconstruction(mask, (21, 24), P=P, Q=Q, device=CPU)


# --- module 10: MirFlickr -------------------------------------------------------------

def test_mirflickr_matches_jax():
    psf, data = _problem((1, 96, 128, 3), seed=15)
    img = np.random.RandomState(16).rand(96, 128, 3).astype(np.float32) * 1.5 - 0.2
    assert _rel(tmir.postprocess(img, device=CPU), jmir.postprocess(img)) == 0
    t = tmir.ADMM_MIRFLICKR(psf, device=CPU)
    t.set_data(data)
    j = jmir.ADMM_MIRFLICKR(psf)
    j.set_data(data)
    out = t.apply(n_iter=3)
    assert out.shape == (36, 28, 3) and _rel(out, j.apply(n_iter=3)) <= TOL_EXACT


# --- module 13: the public surface ------------------------------------------------------

def test_public_surface_mirrors_jax():
    public = ["FFTConvolver", "make_convolver", "ReconstructionAlgorithm", "ADMM",
              "GradientDescent", "NesterovGradientDescent", "FISTA", "apply_admm",
              "APGDPriors", "CodedApertureReconstruction", "SensorOptions", "VirtualSensor",
              "sensor_dict"]
    for name in public:
        assert hasattr(jlpt, name) and hasattr(tlpt, name), name
    assert callable(tlpt.APGD)
    for name in ("UnrolledADMM", "UNetRes", "TrainableRecon", "Restormer"):
        # the learned models resolve to the port's modules
        assert getattr(tlpt, name).__module__.startswith("lenslesspicam_tpu_torch.models.")
    with pytest.raises(AttributeError):
        tlpt.no_such_name


def test_new_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    psf, data = _problem()
    for cls in (tlpt.GradientDescent, tlpt.NesterovGradientDescent, tlpt.FISTA):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(psf)
        assert cls(psf, device=CPU)._convolver.H.device.type == CPU
    mask = SimpleNamespace(resolution=(4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlpt.CodedApertureReconstruction(mask, (4, 4), P=np.eye(4), Q=np.eye(4))
    for fn in (lambda: tapgd.apgd(psf, data, 1), lambda: tgd.fista(psf, data, 1),
               lambda: tlpt.make_convolver(psf),
               lambda: tnoise.add_shot_noise(data, 10.0, torch.Generator()),
               lambda: tmir.postprocess(data)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# --- the repair: run_split's default backend --------------------------------------------

def test_run_split_default_backend_matches_jax_default():
    psf, data = _problem((1, 24, 40, 1), seed=17)
    psf2, data2 = psf[0, :, :, 0], data[:, :, 0]
    P = tsplit.ADMMParams()
    ref = jsplit.run_split_jit(jsplit.precompute_split(psf2, data2), jsplit.ADMMParams(), 10)
    pre = tsplit.precompute_split(psf2, data2, device=CPU)
    out = tsplit.run_split(pre, P, 10)
    assert _rel(out, ref) <= TOL_EXACT
    assert torch.equal(out, tsplit.run_split(pre, P, 10, backend="torch"))
    jpre, info = jsplit.precompute_split_general(psf, data[None])
    ref = jsplit.run_split_general(jpre, info, data[None], jsplit.ADMMParams(), 10)
    tpre, tinfo = tsplit.precompute_split_general(psf, data[None], device=CPU)
    assert _rel(tsplit.run_split_general(tpre, tinfo, data[None], P, 10), ref) <= TOL_EXACT
