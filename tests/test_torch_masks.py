"""The port's hardware layer against the JAX package's on the CPU: the mask
designs (MLS and MURA patterns, MURA at p = 5, 7, 11, 13, FZA, the
micro-lens array, PhaseContour with its phase retrieval, ``from_sensor``,
the separable simulation; tests/test_masks.py:24-93), the apertures, the
SLM layout and programmable mask, the trainable masks (``TrainablePSF``,
``AdafruitLCD``'s PSF and gradient, ``TrainableCodedAperture``,
``prep_trainable_mask``), ``SimulatedDatasetTrainableMask``'s items, and
the trainer co-optimizing a ``TrainablePSF`` (tests/test_trainable_mask.py:
91-115).

Inputs come from numpy with a fixed seed.  Tolerances, max |port - JAX| /
max |JAX|:

- patterns, layouts, apertures and projections: equal;
- PSFs (a float32 phase of 1e4 rad and more, rounded as XLA rounds it,
  tests/test_torch_optics.py): 1e-5;
- ``AdafruitLCD``'s gradient against ``jax.grad``: 1e-4.  The loss weighs
  the PSF by a seeded image: the JAX test's ``sum(psf ** 2)`` is 1 for
  every mask (the PSF is L2-normalized), so its gradient is round-off;
- PhaseContour's retrieved phase: the unit fields ``exp(i phi)`` within
  1e-3 (ten Fresnel round trips of float32 fields; the phase wraps at 2 pi);
- the mask's parameters after two trainer steps: 1e-5 with SGD (7.3e-8
  measured), 5e-5 with Adam (2.28e-5 measured), whose normalized steps
  carry the gradients' relative differences into parameters whose size
  the steps set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lenslesspicam_tpu.data import datasets as jds
from lenslesspicam_tpu.data import simulation as jsim
from lenslesspicam_tpu.hardware import aperture as jap
from lenslesspicam_tpu.hardware import mask as jmask
from lenslesspicam_tpu.hardware import slm as jslm
from lenslesspicam_tpu.hardware import trainable_mask as jtm
from lenslesspicam_tpu.hardware.sensor import VirtualSensor as JSensor
from lenslesspicam_tpu.models.trainable_recon import TrainableRecon as JRecon
from lenslesspicam_tpu.models.unrolled import UnrolledADMM as JADMM
from lenslesspicam_tpu.ops.propagation import fresnel_conv as jfresnel
from lenslesspicam_tpu.train import trainer as jt

from lenslesspicam_tpu_torch.data import datasets as tds
from lenslesspicam_tpu_torch.data import simulation as tsim
from lenslesspicam_tpu_torch.hardware import aperture as tap
from lenslesspicam_tpu_torch.hardware import mask as tmask
from lenslesspicam_tpu_torch.hardware import slm as tslm
from lenslesspicam_tpu_torch.hardware import trainable_mask as ttm
from lenslesspicam_tpu_torch.hardware.sensor import VirtualSensor as TSensor
from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon as TRecon
from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM as TADMM
from lenslesspicam_tpu_torch.train import trainer as tt

CPU = "cpu"
TOL_PSF = 1e-5
TOL_GRAD = 1e-4
TOL_PHASE = 1e-3
TOL_MASK = 1e-5
TOL_MASK_ADAM = 5e-5
RES = (64, 80)                     # tests/test_masks.py:20-22
D_SENSOR = 4e-3
FEATURE = 30e-6


def _rel(out, ref):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jit(fn, *args):
    """``fn(*args)`` jitted, XLA's backend optimisation off (one compile
    instead of op-by-op dispatch)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- hardware/mask.py -----------------------------------------------------------------

@pytest.mark.parametrize("method,n_bits", [("MLS", 4), ("MLS", 5), ("MURA", 5)])
def test_coded_aperture_matches_jax(method, n_bits):
    """The pattern resized to RES (cv2's INTER_NEAREST), the separable
    factors and the PSF."""
    kw = dict(method=method, n_bits=n_bits, resolution=RES, feature_size=FEATURE,
              distance_sensor=D_SENSOR)
    j, t = jmask.CodedAperture(**kw), tmask.CodedAperture(**kw, device=CPU)
    assert t.mask.dtype == np.asarray(j.mask).dtype
    np.testing.assert_array_equal(t.mask, np.asarray(j.mask))
    assert set(np.unique(t.mask)).issubset({0.0, 1.0})
    if method == "MLS":
        np.testing.assert_array_equal(t.row, j.row)
        for a, b in zip(t.get_conv_matrices((24, 24, 3)), j.get_conv_matrices((24, 24, 3))):
            np.testing.assert_array_equal(a, b)
    assert tuple(t.psf.shape) == RES + (3,)
    assert _rel(t.psf, j.psf) <= TOL_PSF


@pytest.mark.parametrize("p", [5, 7, 11, 13])
def test_mura_pattern_golden(p):
    """The MURA golden cases of tests/test_masks.py:42-53 at their native
    size, bit-equal to the JAX package's."""
    kw = dict(method="MURA", n_bits=p, resolution=(p, p), feature_size=FEATURE)
    t = tmask.CodedAperture(**kw, device=CPU)
    np.testing.assert_array_equal(t.mask, np.asarray(jmask.CodedAperture(**kw).mask))
    assert t.psf is None
    assert tmask.quadratic_residues(p) == jmask.quadratic_residues(p)
    with pytest.raises(ValueError, match="prime"):
        tmask.CodedAperture(method="MURA", n_bits=p + 1, resolution=(p, p),
                            feature_size=FEATURE, device=CPU)


def test_fza_mla_and_from_sensor_match_jax():
    kw = dict(resolution=RES, feature_size=FEATURE, distance_sensor=D_SENSOR)
    j, t = (jmask.FresnelZoneAperture(radius=0.5e-3, **kw),
            tmask.FresnelZoneAperture(radius=0.5e-3, device=CPU, **kw))
    np.testing.assert_array_equal(t.mask, j.mask)
    assert _rel(t.psf, j.psf) <= TOL_PSF
    j, t = (jmask.MultiLensArray(N=10, seed=1, **kw),
            tmask.MultiLensArray(N=10, seed=1, device=CPU, **kw))
    np.testing.assert_array_equal(t.height_map, j.height_map)
    np.testing.assert_array_equal(t.focal_length, j.focal_length)
    assert _rel(t.psf, j.psf) <= TOL_PSF
    j, t = (jmask.CodedAperture.from_sensor("rpi_hq", downsample=16, method="MLS", n_bits=4,
                                            distance_sensor=D_SENSOR),
            tmask.CodedAperture.from_sensor("rpi_hq", downsample=16, method="MLS", n_bits=4,
                                            distance_sensor=D_SENSOR, device=CPU))
    assert t.mask.shape == (190, 253)
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.feature_size, j.feature_size)
    assert _rel(t.psf, j.psf) <= TOL_PSF


def test_phase_contour_and_retrieval_match_jax():
    """PhaseContour (tests/test_masks.py:66-87): the Perlin noise and the
    Canny target equal, the retrieved phase as unit fields, and the
    reference's quality test on the port's height map."""
    kw = dict(noise_period=(8, 8), n_iter=10, resolution=RES, feature_size=FEATURE,
              distance_sensor=D_SENSOR)
    j, t = jmask.PhaseContour(**kw), tmask.PhaseContour(device=CPU, **kw)
    np.testing.assert_array_equal(tmask.perlin_noise_2d((64, 80), (8, 8), 3),
                                  jmask.perlin_noise_2d((64, 80), (8, 8), 3))
    np.testing.assert_array_equal(t.target_psf, j.target_psf)
    wv = t.design_wv
    phase = [m.height_map * (2 * np.pi * (m.refractive_index - 1) / wv) for m in (t, j)]
    assert np.abs(np.exp(1j * phase[0]) - np.exp(1j * phase[1])).max() <= TOL_PHASE
    assert _rel(t.psf, j.psf) <= TOL_PSF
    phi = tmask.phase_retrieval(t.target_psf, wv, FEATURE, D_SENSOR, n_iter=3, device=CPU)
    jphi = jmask.phase_retrieval(t.target_psf, wv, FEATURE, D_SENSOR, n_iter=3)
    assert np.abs(np.exp(1j * _np(phi)) - np.exp(1j * np.asarray(jphi))).max() <= TOL_PHASE
    field = t.height_map_to_field(wv)
    psf = np.abs(np.asarray(jfresnel(jnp.asarray(field, jnp.complex64), wv,
                                     (FEATURE, FEATURE), D_SENSOR))) ** 2
    target = t.target_psf / t.target_psf.max()
    assert float(np.mean((psf / psf.max() - target) ** 2)) < 0.1


def test_separable_simulate_matches_jax():
    kw = dict(method="MLS", n_bits=4, resolution=(32, 32), feature_size=FEATURE)
    j, t = jmask.CodedAperture(**kw), tmask.CodedAperture(**kw, device=CPU)
    obj = np.zeros((24, 24, 3), np.float32)
    obj[8:16, 8:16, :] = 1.0
    meas = t.simulate(obj, snr_db=None)
    assert _rel(meas, j.simulate(jnp.asarray(obj), snr_db=None)) <= TOL_PSF
    noisy = t.simulate(obj, snr_db=20, generator=torch.Generator().manual_seed(3))
    assert tuple(noisy.shape) == (32, 32, 3) and not torch.equal(noisy, meas)


# --- hardware/aperture.py and hardware/slm.py -------------------------------------------

def test_apertures_match_jax():
    shape, pitch = (60, 80), (1e-4, 1e-4)
    for name, args in (("rect_aperture", ((2e-3, 3e-3),)), ("square_aperture", (2e-3,)),
                       ("line_aperture", (3e-3,)), ("circ_aperture", (1.5e-3,))):
        t = getattr(tap, name)(shape, pitch, *args)
        j = getattr(jap, name)(shape, pitch, *args)
        np.testing.assert_array_equal(t.values, j.values)
    a, b = tap.Aperture(shape, pitch), jap.Aperture(shape, pitch)
    for ap in (a, b):
        ap.at((slice(1e-3, 2e-3), slice(0, 3e-3)), value=7)
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.dim, b.dim)
    assert tap.ApertureOptions.values() == jap.ApertureOptions.values()


@pytest.mark.parametrize("deadspace", [True, False])
def test_slm_layout_and_programmable_mask_match_jax(deadspace):
    sensor_t, sensor_j = (TSensor.from_name("rpi_hq", downsample=16),
                          JSensor.from_name("rpi_hq", downsample=16))
    vals = np.random.RandomState(1).rand(12, 15).astype(np.float32)
    lt = tslm.build_layout(vals.shape, sensor_t, deadspace=deadspace)
    lj = jslm.build_layout(vals.shape, sensor_j, deadspace=deadspace)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    for flipud in (False, True):
        m = tslm.get_programmable_mask(torch.from_numpy(vals), lt, flipud=flipud)
        assert m.shape == (3,) + tuple(sensor_t.resolution)
        np.testing.assert_array_equal(
            _np(m), np.asarray(jslm.get_programmable_mask(jnp.asarray(vals), lj, flipud=flipud)))
    np.testing.assert_array_equal(tslm.get_centers((4, 5), (1.0, 2.0)),
                                  jslm.get_centers((4, 5), (1.0, 2.0)))
    sub = np.arange(12 * 15, dtype=np.uint8).reshape(12, 15)
    full = tslm.adafruit_sub2full(sub, (59, 76))
    np.testing.assert_array_equal(full, jslm.adafruit_sub2full(sub, (59, 76)))
    np.testing.assert_array_equal(tslm.adafruit_full2subpattern(full, (12, 15), (59, 76)),
                                  jslm.adafruit_full2subpattern(full, (12, 15), (59, 76)))


# --- hardware/trainable_mask.py --------------------------------------------------------

def test_trainable_psf_matches_jax():
    rng = np.random.RandomState(0)
    psf0 = rng.rand(1, 24, 32, 3).astype(np.float32)
    for gray in (False, True):
        j, t = jtm.TrainablePSF(psf0, grayscale=gray), ttm.TrainablePSF(psf0, grayscale=gray,
                                                                       device=CPU)
        assert t.params["psf"].requires_grad and t.params["psf"].is_leaf
        assert _rel(t.get_psf(t.params), j.get_psf(j.params)) <= 1e-7
    dirty = psf0 * 3 - 1
    np.testing.assert_array_equal(_np(t.project({"psf": torch.from_numpy(dirty)})["psf"]),
                                  np.asarray(j.project({"psf": jnp.asarray(dirty)})["psf"]))
    assert ttm.prep_trainable_mask({}) is None
    m = ttm.prep_trainable_mask({"mask_type": "TrainablePSF", "device": CPU}, psf=psf0)
    assert isinstance(m, ttm.TrainablePSF)
    with pytest.raises(ValueError, match="unknown"):
        ttm.prep_trainable_mask({"mask_type": "Lens"})


@pytest.mark.parametrize("downsample,shape", [(32, (10, 12)), (8, (19, 26))])
def test_adafruit_lcd_psf_and_grad_match_jax(downsample, shape):
    """tests/test_trainable_mask.py:38-52 and the DigiCam geometry of
    configs/sim_digicam_psf.yaml (downsample 8, a 19 x 26 controllable
    region)."""
    rng = np.random.RandomState(2)
    vals = rng.rand(*shape).astype(np.float32)
    kw = dict(sensor="rpi_hq", downsample=downsample, scene2mask=0.3, mask2sensor=0.002)
    j, t = jtm.AdafruitLCD(vals, **kw), ttm.AdafruitLCD(vals, device=CPU, **kw)
    psf = t.get_psf(t.params)
    assert psf.ndim == 4 and psf.shape[0] == 1 and psf.shape[-1] == 3
    weight = rng.rand(*psf.shape).astype(np.float32)
    (_, jpsf), g = _jit(jax.value_and_grad(
        lambda p: (jnp.sum(j.get_psf(p) * weight), j.get_psf(p)), has_aux=True), j.params)
    assert _rel(psf, jpsf) <= TOL_PSF
    np.testing.assert_allclose(float(torch.linalg.vector_norm(psf.detach())), 1.0, rtol=1e-5)
    (psf * torch.from_numpy(weight)).sum().backward()
    assert _rel(t.params["vals"].grad, g["vals"]) <= TOL_GRAD
    clipped = t.project({"vals": torch.from_numpy(vals * 2 - 0.5)})["vals"]
    np.testing.assert_array_equal(_np(clipped), np.asarray(
        j.project({"vals": jnp.asarray(vals * 2 - 0.5)})["vals"]))


def test_adafruit_lcd_options_match_jax():
    """Fixed values with a trainable color filter, alignment shifts, no
    flip and no deadspace."""
    rng = np.random.RandomState(4)
    vals = rng.rand(10, 12).astype(np.float32)
    cf = rng.rand(120, 3).astype(np.float32)
    kw = dict(sensor="rpi_hq", downsample=32, scene2mask=0.3, mask2sensor=0.002,
              vertical_shift=3, horizontal_shift=-2, flipud=False, train_mask_vals=False,
              color_filter=cf, train_color_filter=True, deadspace=False)
    j, t = jtm.AdafruitLCD(vals, **kw), ttm.AdafruitLCD(vals, device=CPU, **kw)
    assert list(t.params) == ["color_filter"]
    assert _rel(t.get_psf(t.params), j.get_psf(j.params)) <= TOL_PSF
    proj = t.project({"color_filter": torch.from_numpy(cf * 2 - 0.5)})["color_filter"]
    assert _rel(proj, j.project({"color_filter": jnp.asarray(cf * 2 - 0.5)})["color_filter"]) \
        <= 1e-7
    for name, cls in (("Adam", torch.optim.Adam), ("AdamW", torch.optim.AdamW),
                      ("SGD", torch.optim.SGD)):
        opt = ttm.AdafruitLCD(vals, device=CPU, optimizer=name, lr=0.5, **kw).make_optimizer()
        assert type(opt) is cls and opt.param_groups[0]["lr"] == 0.5
    assert opt.param_groups[0]["momentum"] == 0
    assert ttm.AdafruitLCD(vals, device=CPU, optimizer="AdamW", **kw).make_optimizer() \
        .param_groups[0]["weight_decay"] == 1e-4


def test_trainable_coded_aperture_matches_jax():
    j = jtm.TrainableCodedAperture(downsample=32, binary=True)
    t = ttm.TrainableCodedAperture(downsample=32, binary=True, device=CPU)
    for k in j.params:
        np.testing.assert_array_equal(_np(t.params[k]), np.asarray(j.params[k]))
    assert _rel(t.get_psf(t.params), j.get_psf(j.params)) <= TOL_PSF
    proj = t.project({k: v * 0.6 for k, v in t.params.items()})
    jproj = j.project({k: v * 0.6 for k, v in j.params.items()})
    for k, v in proj.items():
        assert set(np.unique(_np(v))).issubset({0.0, 1.0})
        np.testing.assert_array_equal(_np(v), np.asarray(jproj[k]))
    full = ttm.prep_trainable_mask({"mask_type": "TrainableCodedAperture", "downsample": 32,
                                    "separable": False, "device": CPU})
    assert list(full.params) == ["mask"] and full.get_psf(full.params).shape[-1] == 3


# --- data/datasets.py: SimulatedDatasetTrainableMask ------------------------------------

def test_simulated_dataset_trainable_mask_matches_jax():
    """Items simulated through the mask's PSF, before and after
    ``set_psf`` with new mask values; a quantizing simulator is refused."""
    rng = np.random.RandomState(6)
    vals = rng.rand(10, 12).astype(np.float32)
    kw = dict(sensor="rpi_hq", downsample=32, scene2mask=0.3, mask2sensor=0.002)
    jm, tm = jtm.AdafruitLCD(vals, **kw), ttm.AdafruitLCD(vals, device=CPU, **kw)
    images = [rng.rand(20, 24, 3).astype(np.float32) for _ in range(2)]
    sim = dict(object_height=0.3, scene2mask=0.3, mask2sensor=0.002, sensor="rpi_hq",
               quantize=False)
    j = jds.SimulatedDatasetTrainableMask(jm, images, jsim.FarFieldSimulator(**sim))
    t = tds.SimulatedDatasetTrainableMask(tm, images, tsim.FarFieldSimulator(device=CPU, **sim))
    assert _rel(t.psf, j.psf) <= TOL_PSF

    def same_items():
        for idx in range(len(j)):
            for a, b in zip(t[idx], j[idx]):
                assert _rel(a, b) <= TOL_PSF
        tb, jb = next(t.batches(2)), next(j.batches(2))
        assert _rel(tb["lensless"], jb["lensless"]) <= TOL_PSF

    same_items()
    new = rng.rand(10, 12).astype(np.float32)
    jm.params = {"vals": jnp.asarray(new)}
    with torch.no_grad():
        tm.params["vals"].copy_(torch.from_numpy(new))
    t.set_psf()
    j.set_psf()
    assert _rel(t.psf, j.psf) <= TOL_PSF
    same_items()
    with pytest.raises(ValueError, match="quantize"):
        tds.SimulatedDatasetTrainableMask(tm, images, tsim.FarFieldSimulator(
            device=CPU, **dict(sim, quantize=True)))


# --- the trainer with a trainable mask ---------------------------------------------------

@pytest.mark.parametrize("optimizer,tol", [("Adam", TOL_MASK_ADAM), ("SGD", TOL_MASK)])
def test_trainer_with_trainable_mask_matches_jax(optimizer, tol):
    """tests/test_trainable_mask.py:91-115: two steps co-optimizing a
    TrainablePSF (lr 1e-2, Adam as there, and SGD) with an unrolled ADMM: the
    mask's parameters against JAX's, inside [0, 1] and moved (both
    models' schedules start at the flax init, the port's defaults)."""
    torch.set_num_threads(1)
    rng = np.random.RandomState(5)
    psf = rng.rand(1, 16, 24, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    batches = [{"lensless": rng.rand(2, 1, 16, 24, 3).astype(np.float32),
                "lensed": rng.rand(2, 1, 16, 24, 3).astype(np.float32)} for _ in range(2)]
    cfg = dict(epochs=1, lr=1e-3, l1_mask=1e-4)
    jmask = jtm.TrainablePSF(psf, lr=1e-2, optimizer=optimizer)
    tmask_ = ttm.TrainablePSF(psf, lr=1e-2, optimizer=optimizer, device=CPU)
    jtr = jt.Trainer(JRecon(camera_inversion=JADMM(n_iter=2)), psf,
                     lambda: iter(batches), batches[:1], jt.TrainerConfig(**cfg), mask=jmask)
    ttr = tt.Trainer(TRecon(camera_inversion=TADMM(n_iter=2, device=CPU), device=CPU), psf,
                     lambda: iter(batches), batches[:1], tt.TrainerConfig(**cfg), mask=tmask_,
                     device=CPU)
    jloss, tloss = jtr.train_epoch(), ttr.train_epoch()
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    after = _np(tmask_.params["psf"])
    assert _rel(after, jmask.params["psf"]) <= tol
    assert not np.allclose(psf, after), "mask params did not update"
    assert after.min() >= 0 and after.max() <= 1, "projection not applied"
