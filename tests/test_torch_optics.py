"""The port's optics and offline datasets against the JAX package on the
CPU: ``ops.propagation`` (angular spectrum with ``pad`` and ``bandlimit``
on and off, Fresnel, the spherical wavefront), ``data.simulation``'s
``FarFieldSimulator`` on the same draws, and ``data.datasets``'s offline
part (``DualDataset`` and its batches, downsample, flips, input-SNR noise
and ``extract_roi``; ``MeasuredDataset``; ``natural_sort``;
``SimulatedFarFieldDataset`` and the offline ``simulate_dataset``; the
DiffuserCam and DigiCam folders), on the cases of
``tests/test_datasets.py``.

Inputs come from numpy with a fixed seed.  A random draw goes to both
packages: the port's draw helpers (``data.simulation._uniform`` /
``_randint``, ``ops.noise._normal``) are patched to return the
``jax.random`` draws the JAX package makes from its key.  Tolerances are
max |port - JAX| / max |JAX|:

- propagation and the simulator: 1e-5; a quantized simulation within one
  level on at most 1 % of the pixels (the rounding to levels turns a
  1e-7 difference into a level now and then), as ``tests/test_torch_eval.py``
  holds ``VirtualSensor.capture`` (the float32 transfer function
  rounds as the JAX package's compiled code does, see
  ``ops/propagation.py``; the complex128 path is held to a float64 numpy
  evaluation of the same formulas at 1e-9, the float64 round-off of a
  phase of 1e6 rad);
- the datasets: 1e-5 where a resize or the noise runs (``data.image.resize``
  is held to OpenCV at 1e-5 in ``tests/test_torch_eval.py``), else bit-equal.
"""

import io
import os
import sys
from contextlib import redirect_stdout

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lenslesspicam_tpu.data import datasets as jds
from lenslesspicam_tpu.data import simulation as jsim
from lenslesspicam_tpu.ops import propagation as jprop

from lenslesspicam_tpu_torch.data import datasets as tds
from lenslesspicam_tpu_torch.data import simulation as tsim
from lenslesspicam_tpu_torch.ops import noise as tnoise
from lenslesspicam_tpu_torch.ops import propagation as tprop

CPU = "cpu"
TOL = 1e-5
TOL_SHARE = 0.01   # quantized outputs: one level on at most 1 % of the pixels
TOL_F64 = 1e-9     # a phase of 1e5-1e6 rad carries 1e-11-1e-10 rad of float64 round-off
PITCH = (2e-6, 3e-6)


def _rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _field(shape=(2, 64, 96), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * np.exp(1j * 6 * rng.rand(*shape))).astype(np.complex64)


# --- propagation ----------------------------------------------------------------------

def _np_angular_spectrum(u, wv, pitch, dz, pad, bandlimit):
    """float64 numpy evaluation of the angular-spectrum formulas."""
    ny, nx = u.shape[-2:]
    if pad:
        u = np.pad(u, [(0, 0)] * (u.ndim - 2) + [(ny // 2, ny // 2), (nx // 2, nx // 2)])
    Ny, Nx = u.shape[-2:]
    fyy, fxx = np.meshgrid(np.fft.fftfreq(Ny, pitch[0]), np.fft.fftfreq(Nx, pitch[1]),
                           indexing="ij")
    arg = 1.0 - (wv * fxx) ** 2 - (wv * fyy) ** 2
    H = np.where(arg > 0, np.exp(1j * 2 * np.pi / wv * np.sqrt(np.maximum(arg, 0)) * abs(dz)),
                 0)
    H = H if dz >= 0 else np.conj(H)
    if bandlimit:
        lim = [1 / (wv * np.sqrt((2 * abs(dz) / (n * p)) ** 2 + 1))
               for n, p in ((Nx, pitch[1]), (Ny, pitch[0]))]
        H = np.where((np.abs(fxx) <= lim[0]) & (np.abs(fyy) <= lim[1]), H, 0)
    out = np.fft.ifft2(np.fft.fft2(u) * H)
    return out[..., ny // 2:ny // 2 + ny, nx // 2:nx // 2 + nx] if pad else out


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("bandlimit", [True, False])
@pytest.mark.parametrize("dz,wv", [(1e-3, 532e-9), (-2e-3, 640e-9), (5e-2, 460e-9)])
def test_angular_spectrum_matches_jax(pad, bandlimit, dz, wv):
    u = _field(seed=1)
    out = tprop.angular_spectrum(u, wv, PITCH, dz, pad=pad, bandlimit=bandlimit, device=CPU)
    assert out.dtype == torch.complex64 and out.device.type == CPU
    ref = jprop.angular_spectrum(u, wv, PITCH, dz, pad=pad, bandlimit=bandlimit)
    assert _rel(out, ref) <= TOL
    out64 = tprop.angular_spectrum(u.astype(np.complex128), wv, PITCH, dz, pad=pad,
                                   bandlimit=bandlimit, device=CPU)
    assert out64.dtype == torch.complex128
    assert _rel(out64, _np_angular_spectrum(u.astype(np.complex128), wv, PITCH, dz, pad,
                                            bandlimit)) <= TOL_F64


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("dz", [1e-3, 5e-2])
def test_fresnel_conv_matches_jax(pad, dz):
    u = _field(seed=2)
    out = tprop.fresnel_conv(u, 532e-9, PITCH, dz, pad=pad, device=CPU)
    assert _rel(out, jprop.fresnel_conv(u, 532e-9, PITCH, dz, pad=pad)) <= TOL


def test_spherical_wavefront_and_gradient():
    out = tprop.spherical_wavefront((64, 96), PITCH, 532e-9, 0.01, device=CPU)
    assert _rel(out, jprop.spherical_wavefront((64, 96), PITCH, 532e-9, 0.01)) <= TOL
    u = torch.from_numpy(_field((64, 96), seed=3)).requires_grad_()
    torch.abs(tprop.angular_spectrum(u, 532e-9, PITCH, 1e-3)).sum().backward()
    assert u.grad is not None and bool(torch.isfinite(u.grad).all())


# --- the far-field simulator ------------------------------------------------------------

@pytest.fixture
def jax_draws(monkeypatch):
    """Patch the port's draws to the ones the JAX simulator makes from
    ``key``: the height's uniform, the shift's two randints (from
    ``jax.random.split(key)``) and the noise's normal."""

    def use(key):
        ky, kx = jax.random.split(key)
        shifts = [ky, kx]
        monkeypatch.setattr(tsim, "_uniform", lambda g: float(jax.random.uniform(key, ())))
        monkeypatch.setattr(tsim, "_randint", lambda g, high: int(
            jax.random.randint(shifts.pop(0), (), 0, high)))
        monkeypatch.setattr(tnoise, "_normal", lambda x, g: torch.from_numpy(
            np.array(jax.random.normal(key, tuple(x.shape), jnp.float32))))
    return use


def _psf(shape=(1, 48, 64, 3), seed=4):
    psf = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return psf / np.linalg.norm(psf)


SIM_CASES = {
    "centered": dict(object_height=0.3),
    "random": dict(object_height=(0.2, 0.4), random_shift=True, snr_db=20,
                   output_dim=(30, 40)),
    "shifted": dict(object_height=0.3, quantize=False, vertical_shift=3, horizontal_shift=-2,
                    snr_db=30),
}


@pytest.mark.parametrize("case", SIM_CASES)
@pytest.mark.parametrize("obj_shape", [(30, 40, 3), (2, 30, 40, 1)])
def test_far_field_simulator_matches_jax(jax_draws, case, obj_shape):
    """An RGB and a batch of gray objects (repeated to the RGB PSF's
    channels) through both simulators on the same draws."""
    kw = SIM_CASES[case]
    obj = np.random.RandomState(5).rand(*obj_shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jax_draws(key)
    t = tsim.FarFieldSimulator(scene2mask=0.4, mask2sensor=0.002, sensor="rpi_hq",
                               psf=_psf(), device=CPU, **kw)
    j = jsim.FarFieldSimulator(scene2mask=0.4, mask2sensor=0.002, sensor="rpi_hq", psf=_psf(),
                               **kw)
    out, plane = t.propagate_image(obj, return_object_plane=True, generator=torch.Generator())
    ref, ref_plane = j.propagate_image(obj, return_object_plane=True, key=key)
    assert out.device.type == CPU
    if kw.get("quantize", True):
        d = np.abs(out.numpy() - np.asarray(ref))
        assert d.max() <= 1.0 and (d != 0).mean() <= TOL_SHARE
    else:
        assert _rel(out, ref) <= TOL
    assert _rel(plane, ref_plane) <= TOL
    assert t.params == j.params


def test_far_field_simulator_without_psf_and_key():
    """No PSF: the object plane on ``output_dim`` (numpy); no generator:
    the range's midpoint, centered; the shot noise from a generator
    seeded with 0 has the JAX package's scale."""
    obj = np.random.RandomState(6).rand(20, 30, 3).astype(np.float32)
    kw = dict(object_height=(0.2, 0.4), scene2mask=0.4, mask2sensor=0.002, sensor="rpi_hq",
              output_dim=(40, 52))
    out = tsim.FarFieldSimulator(device=CPU, **kw).propagate_image(obj)
    assert isinstance(out, np.ndarray)
    assert _rel(out, jsim.FarFieldSimulator(**kw).propagate_image(obj)) <= TOL
    noisy = tsim.FarFieldSimulator(scene2mask=0.4, mask2sensor=0.002, sensor="rpi_hq",
                                   psf=_psf(), snr_db=20, quantize=False, object_height=0.3,
                                   device=CPU).propagate_image(obj)
    clean = tsim.FarFieldSimulator(scene2mask=0.4, mask2sensor=0.002, sensor="rpi_hq",
                                   psf=_psf(), quantize=False, object_height=0.3,
                                   device=CPU).propagate_image(obj)
    snr = 10 * np.log10(float((clean ** 2).mean() / ((noisy - clean) ** 2).mean()))
    assert 17 < snr < 23


# --- the offline datasets ----------------------------------------------------------------

def _toy(pkg):
    class Toy(pkg.DualDataset):
        def __init__(self, n=6, **kwargs):
            super().__init__(**kwargs)
            self.n = n
            rng = np.random.RandomState(0)
            self.lensless = rng.rand(n, 16, 24, 3).astype(np.float32)
            self.lensed = rng.rand(n, 16, 24, 3).astype(np.float32)

        def __len__(self):
            return self.n

        def _get_images_pair(self, idx):
            return self.lensless[idx], self.lensed[idx]
    return Toy


@pytest.fixture
def seeded_normal(monkeypatch):
    """The port's normal draw for a generator seeded with s is
    ``jax.random.normal(PRNGKey(s))``, the JAX dataset's draw for the same
    seed of its RandomState stream."""
    monkeypatch.setattr(tnoise, "_normal", lambda x, g: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(g.initial_seed()), tuple(x.shape), jnp.float32))))


@pytest.mark.parametrize("kw", [dict(input_snr=20, flip_lr=True), dict(downsample=2),
                                dict(flip=True, background=0.1), dict(flip_ud=True, seed=3,
                                                                      input_snr=10)])
def test_dual_dataset_pipeline_and_batches(seeded_normal, kw):
    t, j = _toy(tds)(**kw), _toy(jds)(**kw)
    tb, jb = list(t.batches(batch_size=4)), list(j.batches(batch_size=4))
    assert [b["lensless"].shape for b in tb] == [b["lensless"].shape for b in jb]
    for a, b in zip(tb, jb):
        for key in ("lensless", "lensed"):
            assert _rel(a[key], b[key]) <= TOL
    shuffled = [b["lensed"] for b in _toy(tds)(**kw).batches(batch_size=4, shuffle=True, seed=2)]
    ref = [b["lensed"] for b in _toy(jds)(**kw).batches(batch_size=4, shuffle=True, seed=2)]
    assert all(_rel(a, b) <= TOL for a, b in zip(shuffled, ref))


def test_extract_roi_matches_jax():
    recon = np.random.RandomState(1).rand(2, 1, 16, 24, 3).astype(np.float32)
    lensed = np.random.RandomState(2).rand(2, 1, 16, 24, 3).astype(np.float32)
    flags = np.array([True, False])
    t, j = _toy(tds)(), _toy(jds)()
    for attr, value in (("crop", {"vertical": (2, 10), "horizontal": (4, 20)}),
                        ("alignment", {"top_left": (2, 4), "height": 8, "width": 16})):
        setattr(t, attr, value)
        setattr(j, attr, value)
        for kwargs in ({}, {"lensed": lensed}, {"flip_lr": flags}, {"flip_ud": flags[::-1],
                                                                    "lensed": lensed}):
            out, ref = t.extract_roi(recon, **kwargs), j.extract_roi(recon, **kwargs)
            for a, b in zip(out if isinstance(out, tuple) else (out,),
                            ref if isinstance(ref, tuple) else (ref,)):
                np.testing.assert_array_equal(a, b)
        setattr(t, attr, None)
        setattr(j, attr, None)
    out = t.extract_roi(torch.from_numpy(recon), flip_lr=flags)
    np.testing.assert_array_equal(out, j.extract_roi(recon, flip_lr=flags))


def _pairs(root, names, ext="npy", seed=3):
    rng = np.random.RandomState(seed)
    for sub in ("diffuser", "lensed"):
        os.makedirs(root / sub, exist_ok=True)
    for name in names:
        for sub in ("diffuser", "lensed"):
            img = rng.rand(8, 10, 3).astype(np.float32)
            if ext == "npy":
                np.save(root / sub / f"{name}.npy", img)
            else:
                cv2.imwrite(str(root / sub / f"{name}.{ext}"), (img * 255).astype(np.uint8))


@pytest.mark.parametrize("ext", ["npy", "png"])
def test_measured_dataset_matches_jax(tmp_path, ext):
    _pairs(tmp_path, ["im10", "im2", "im1", "im3"], ext)
    t = tds.MeasuredDataset(str(tmp_path), image_ext=ext, downsample=2)
    j = jds.MeasuredDataset(str(tmp_path), image_ext=ext, downsample=2)
    assert [os.path.basename(f) for f in t.lensless_files] == \
        [f"im{i}.{ext}" for i in (1, 2, 3, 10)]
    for a, b in zip(t.batches(3), j.batches(3)):
        assert _rel(a["lensless"], b["lensless"]) <= TOL and _rel(a["lensed"], b["lensed"]) <= TOL
    os.remove(tmp_path / "lensed" / f"im3.{ext}")
    with pytest.raises(ValueError):
        tds.MeasuredDataset(str(tmp_path), image_ext=ext)


def test_natural_sort_and_registry():
    files = ["im10.npy", "im2.npy", "Im1.npy", "a20b3", "a3b10"]
    assert tds.natural_sort(files) == jds.natural_sort(files)
    assert tds.available_datasets == jds.available_datasets
    out_t, out_j = io.StringIO(), io.StringIO()
    with redirect_stdout(out_t):
        tds.print_available_datasets()
    with redirect_stdout(out_j):
        jds.print_available_datasets()
    assert out_t.getvalue() == out_j.getvalue()


@pytest.mark.parametrize("images", ["random", "arrays"])
def test_simulate_dataset_offline_matches_jax(monkeypatch, images):
    """The offline ``simulate_dataset`` (seeded random images, or arrays)
    on the same PSF: both packages' items, the noise drawn with
    ``PRNGKey(0)`` as the JAX simulator draws it without a key; without
    the ``datasets`` package both raise ImportError on a hub name (its
    call is in tests/test_torch_hub_datasets.py)."""
    monkeypatch.setattr(tnoise, "_normal", lambda x, g: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), tuple(x.shape), jnp.float32))))
    psf = _psf((1, 32, 48, 3))
    cfg = {"dataset": "random", "n_files": 3}
    if images == "arrays":
        cfg["dataset"] = [np.random.RandomState(8).rand(20, 24, 3).astype(np.float32)] * 2
    t = tds.simulate_dataset(cfg, psf=psf, device=CPU)
    j = jds.simulate_dataset(cfg, psf=psf)
    assert len(t) == len(j) and _rel(t.psf, j.psf) <= TOL
    for idx in range(len(t)):
        for a, b in zip(t[idx], j[idx]):
            assert _rel(a, b) <= TOL
    monkeypatch.setitem(sys.modules, "datasets", None)    # the hub's names need the package
    for simulate, kw in ((tds.simulate_dataset, dict(device=CPU)), (jds.simulate_dataset, {})):
        with pytest.raises(ImportError):
            simulate({"dataset": "mnist"}, psf=psf, **kw)


def test_diffusercam_folders_match_jax(tmp_path):
    """``DiffuserCamMirflickr`` (BGR -> RGB, its own folder names, a PSF at
    1/4) and ``DiffuserCamTestDataset`` (``psf.tiff`` beside the pairs)."""
    rng = np.random.RandomState(9)
    psf = (rng.rand(64, 80, 3) * 60000).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "psf.tiff"), psf)
    for sub in ("diffuser_images", "ground_truth_lensed"):
        os.makedirs(tmp_path / sub)
        for i in range(3):
            np.save(tmp_path / sub / f"im{i}.npy", rng.rand(16, 20, 3).astype(np.float32))
    t = tds.DiffuserCamMirflickr(str(tmp_path), str(tmp_path / "psf.tiff"))
    j = jds.DiffuserCamMirflickr(str(tmp_path), str(tmp_path / "psf.tiff"))
    assert _rel(t.psf, j.psf) <= TOL and np.array_equal(t.allowed_idx, j.allowed_idx)
    for a, b in zip(t[1], j[1]):
        assert _rel(a, b) <= TOL
    _pairs(tmp_path, ["a1", "a2"])
    t, j = tds.DiffuserCamTestDataset(str(tmp_path)), jds.DiffuserCamTestDataset(str(tmp_path))
    assert _rel(t.psf, j.psf) <= TOL and len(t) == len(j) == 2
    for a, b in zip(t[0], j[0]):
        assert _rel(a, b) <= TOL


def test_digicam_celeba_matches_jax(tmp_path):
    """Measured PNGs paired with CelebA JPEGs projected to the lensed
    plane (no PSF: the object plane on the PSF's grid), crop and shifts
    scaled by ``downsample``."""
    rng = np.random.RandomState(10)
    celeba = tmp_path / "celeba" / "celeba" / "img_align_celeba"
    measured = tmp_path / "measured"
    os.makedirs(celeba)
    os.makedirs(measured)
    for i in (2, 10):
        cv2.imwrite(str(measured / f"{i:06d}.png"), (rng.rand(60, 80, 3) * 255).astype(np.uint8))
        cv2.imwrite(str(celeba / f"{i:06d}.jpg"), (rng.rand(54, 44, 3) * 255).astype(np.uint8))
    cv2.imwrite(str(tmp_path / "psf.png"), (rng.rand(240, 320, 3) * 255).astype(np.uint8))
    kw = dict(downsample=2, simulation_config={"object_height": 0.3, "scene2mask": 0.25,
                                               "mask2sensor": 0.002})
    t = tds.DigiCamCelebA(str(tmp_path / "celeba"), str(measured), str(tmp_path / "psf.png"),
                          device=CPU, **kw)
    j = jds.DigiCamCelebA(str(tmp_path / "celeba"), str(measured), str(tmp_path / "psf.png"),
                          **kw)
    assert t.files == j.files and t.crop == j.crop
    assert _rel(t.psf, j.psf) <= TOL and _rel(t.background, j.background) <= TOL
    for a, b in zip(t[1], j[1]):
        assert _rel(a, b) <= TOL
