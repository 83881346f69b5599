"""The port's mask, PSF and dataset simulation apps
(``lenslesspicam_tpu_torch/scripts/sim``: ``mask_single_file``,
``mask_dataset``, ``digicam_psf``, ``dataset``, ``torch_dataset``) against
the JAX package's scripts of the same paths (``torch_dataset`` against
``jax_dataset.py``), in-process on the CPU (``LPT_PLATFORM=cpu``) on the
same seeded inputs at ``tests/test_scripts.py``'s sizes: 48 x 64 x 3 PNGs,
``simulation.downsample=16`` (the RPi HQ sensor at 190 x 253) for the mask
apps, ``digicam.downsample=16``, 3-5 iterations.  The noise is drawn as
the JAX package draws it (``jax_noise``); the helpers and tolerances are
``tests/test_torch_scripts.py``'s.

Each simulated pair is recorded where it is made (both packages'
``FarFieldSimulator.propagate_image`` and ``CodedAperture.simulate``
wrapped) and held within TOL_SIM of its max without noise
(``simulation.snr_db=null``, as the card's phase runs them); what ADMM
makes of it within TOL_SIM_RECON; the Tikhonov estimate of a FlatCam
measurement within TOL_TIKHONOV, 1e-5 of its max
(``tests/test_torch_classical.py``'s tolerance for
``CodedApertureReconstruction``), of a quantized far-field plane within
TOL_SIM_RECON as ADMM's; the printed metrics within TOL_METRIC relative; a
saved 8-bit PNG within one level.  Two tolerances differ:

- a noisy pair (the noise drawn as JAX draws it) within TOL_NOISY, 1e-4:
  the shot noise scales with sqrt(signal), whose slope is unbounded where
  the clean plane is near 0, and the packages' float32 convolutions differ
  there (6.0e-5 of the max measured);
- a ``PhaseContour`` PSF, and what is simulated with it, within
  TOL_PHASE_CONTOUR, 1e-4: ten Fresnel phase-retrieval round trips carry
  the packages' float32 differences into the height map
  (``tests/test_torch_masks.py`` holds its phase at 1e-3), 8.9e-5 of the
  PSF's max measured at 190 x 253.
"""

import os
import re

import cv2
import numpy as np
import pytest

import lenslesspicam_tpu.data.simulation as jsim
import lenslesspicam_tpu.hardware.mask as jmask
import lenslesspicam_tpu_torch.data.simulation as tsim
import lenslesspicam_tpu_torch.hardware.mask as tmask
from lenslesspicam_tpu_torch._device import as_host

from test_torch_scripts import (APPS, TOL_METRIC, TOL_SIM, TOL_SIM_RECON, _both_printed, _nerr,
                                _png_levels, _rel, _run, _saved, jax_noise,  # noqa: F401
                                one_thread)  # noqa: F401

TOL_TIKHONOV = 1e-5
TOL_NOISY = 1e-4
TOL_PHASE_CONTOUR = 1e-4
MASK = ["simulation.downsample=16"]
CLEAN = ["simulation.snr_db=null"]


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")




@pytest.fixture
def images(tmp_path):
    """A folder of five seeded 48 x 64 x 3 PNGs and one of them alone."""
    rng = np.random.RandomState(1)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in range(5):
        cv2.imwrite(str(folder / f"im{i}.png"), (rng.rand(48, 64, 3) * 255).astype(np.uint8))
    return folder


@pytest.fixture
def made(monkeypatch):
    """Every simulated pair and FlatCam measurement, as numpy, in the order
    each package made them: ``made["jax"]``, ``made["port"]``.  A
    quantized pair is recorded with the same call made again without the
    quantization (the same noise: JAX's fixed key, the port's patched
    draw), whose planes are compared; the quantized measurement itself is
    held to one level (a rounding tie may fall either way)."""
    got = {"jax": [], "port": [], "levels": []}

    def wrap(cls, name, side):
        inner = getattr(cls, name)

        def recorded(self, *args, **kwargs):
            out = inner(self, *args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            quantized = getattr(self, "quantize", False)
            if quantized:
                got["levels"].append((side, as_host(outs[0])))
                self.quantize = False
                try:
                    again = inner(self, *args, **kwargs)
                finally:
                    self.quantize = True
                outs = again if isinstance(again, tuple) else (again,)
            got[side].append(tuple(as_host(o) for o in outs))
            return out

        monkeypatch.setattr(cls, name, recorded)

    for cls, side in ((jsim.FarFieldSimulator, "jax"), (tsim.FarFieldSimulator, "port")):
        wrap(cls, "propagate_image", side)
    for cls, side in ((jmask.CodedAperture, "jax"), (tmask.CodedAperture, "port")):
        wrap(cls, "simulate", side)
    return got


def _same_made(made, tol=TOL_SIM):
    assert len(made["port"]) == len(made["jax"]) > 0
    for p, j in zip(made["port"], made["jax"]):
        assert len(p) == len(j)
        for a, b in zip(p, j):
            assert _nerr(a, b) <= tol
    levels = {side: [m for s, m in made["levels"] if s == side] for side in ("port", "jax")}
    assert len(levels["port"]) == len(levels["jax"])
    for a, b in zip(levels["port"], levels["jax"]):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1




def _printed(text):
    """The metric lines ``NAME value`` or ``NAME (avg) value``, by name."""
    return {m[0]: float(m[1]) for m in
            re.findall(r"^(MSE|PSNR|SSIM|LPIPS)(?: \(avg\))? (\S+)$", text, re.M)}


def _same_printed(port_out, jax_out):
    ours, ref = _printed(port_out), _printed(jax_out)
    assert sorted(ours) == sorted(ref) and {"MSE", "PSNR", "SSIM"} <= set(ref)
    for k in ref:
        assert _rel(ours[k], ref[k]) <= TOL_METRIC, (k, ours[k], ref[k])


# --- mask_single_file --------------------------------------------------------------------

SINGLE = {
    "mls_flatcam_tikhonov": ["mask.type=MLS", "simulation.flatcam=True", "recon.algo=tikhonov"],
    "mura_admm": ["mask.type=MURA", "mask.n_bits=3", "recon.algo=admm", "recon.admm.n_iter=5"],
    "fza_admm": ["mask.type=FZA", "recon.algo=admm", "recon.admm.n_iter=3"],
    "phase_contour_admm": ["mask.type=PhaseContour", "mask.phase_mask_iter=3",
                           "recon.algo=admm", "recon.admm.n_iter=3"],
    "mls_bayer_tikhonov": ["mask.type=MLS", "simulation.flatcam=True", "recon.algo=tikhonov",
                           "simulation.image_format=bayer_rggb"],
}


def _check_single(out, ref, port_out, jax_out, made, tmp_path, case, tol_made=TOL_SIM):
    _same_made(made, TOL_PHASE_CONTOUR if "phase" in case else tol_made)
    tol = TOL_TIKHONOV if "tikhonov" in case else TOL_SIM_RECON
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert _nerr(out, ref) <= tol
    _same_printed(port_out, jax_out)
    for name in ("original.png", "psf.png"):     # lensless.png: held in _same_made
        assert _png_levels(_saved(tmp_path / "port", name), _saved(tmp_path / "jax", name)) <= 1


def _noisy(case):
    """Tikhonov cases keep the config's noise (without it the FlatCam
    inverse is exact to float precision, an MSE of 1e-13 that no
    relative tolerance can compare); ``+noise`` adds it to another."""
    return "tikhonov" in case or case.endswith("+noise")


@pytest.mark.parametrize("case", [*SINGLE, "mura_admm+noise"])
def test_mask_single_file_app_matches_jax(images, tmp_path, capsys, jax_noise, made, case):
    """Each mask type and recon, without noise or with the config's 20 dB
    drawn as JAX draws it."""
    noisy = _noisy(case)
    args = [f"files.original={images / 'im0.png'}", *MASK, *SINGLE[case.split("+")[0]],
            *([] if noisy else CLEAN)]
    _check_single(*_both_printed(tmp_path, "sim.mask_single_file", args, capsys), made, tmp_path,
                  case, tol_made=TOL_NOISY if noisy else TOL_SIM)


def test_mask_single_file_app_resizes_a_tikhonov_estimate(images, tmp_path, capsys):
    """The FlatCam model at the mask's resolution, the far-field object
    plane on the sensor's: the estimate comes back at the object plane's
    shape through ``cv2.resize``, as in the JAX app."""
    args = [f"files.original={images / 'im0.png'}", *MASK, *CLEAN, "mask.type=MLS",
            "recon.algo=tikhonov"]
    out, ref, port_out, jax_out = _both_printed(tmp_path, "sim.mask_single_file", args, capsys)
    assert out.shape == ref.shape == (190, 253, 3)
    assert _nerr(out, ref) <= TOL_SIM_RECON     # of a quantized plane, whose ties may differ
    _same_printed(port_out, jax_out)


def test_mask_single_file_app_refuses_admm_on_bayer(images, tmp_path):
    port, _, entry = APPS["sim.mask_single_file"]
    with pytest.raises(ValueError, match="Bayer"):
        _run(getattr(port, entry), [f"files.original={images / 'im0.png'}", *MASK,
                                    "mask.type=MLS", "recon.algo=admm",
                                    "simulation.image_format=bayer_rggb"], tmp_path)


@pytest.mark.parametrize("kind", ["MLS", "MURA", "FZA", "PhaseContour"])
def test_build_mask_matches_jax(kind):
    """``build_mask`` of each mask type: the same pattern and PSF."""
    from lenslesspicam_tpu_torch.scripts.sim.mask_single_file import build_mask
    from lenslesspicam_tpu_torch.utils.config import load_config

    from scripts.sim.mask_single_file import build_mask as jbuild

    config = load_config(APPS["sim.mask_single_file"][0]._CONFIG,
                         {"mask.type": kind, "mask.n_bits": 3, "mask.phase_mask_iter": 3})
    ours, ref = build_mask(config, "cpu"), jbuild(config)
    assert type(ours).__name__ == type(ref).__name__
    np.testing.assert_array_equal(np.asarray(ours.mask), np.asarray(ref.mask))
    tol = TOL_PHASE_CONTOUR if kind == "PhaseContour" else TOL_SIM
    assert _nerr(as_host(ours.psf), np.asarray(ref.psf)) <= tol


# --- mask_dataset ------------------------------------------------------------------------

DATASET = {
    "mls_flatcam_tikhonov": ["mask.type=MLS", "simulation.flatcam=True", "recon.algo=tikhonov"],
    "mura_admm": ["mask.type=MURA", "mask.n_bits=3", "recon.algo=admm", "recon.admm.n_iter=5",
                  "recon.batch_size=2"],
    "fza_admm_grayscale": ["mask.type=FZA", "recon.algo=admm", "recon.admm.n_iter=3",
                           "simulation.grayscale=True"],
}


@pytest.mark.parametrize("case", ["mls_flatcam_tikhonov", "mura_admm+noise",
                                  "fza_admm_grayscale"])
def test_mask_dataset_app_matches_jax(images, tmp_path, capsys, jax_noise, made, case):
    """Five files (ADMM in calls of ``recon.batch_size=2``), without noise
    and with the config's 20 dB: every pair, the averaged metrics and
    each saved reconstruction."""
    noisy = _noisy(case)
    args = [f"files.dataset={images}", *MASK, *DATASET[case.split("+")[0]],
            *([] if noisy else CLEAN)]
    out, ref, port_out, jax_out = _both_printed(tmp_path, "sim.mask_dataset", args, capsys)
    _same_made(made, TOL_NOISY if noisy else TOL_SIM)
    assert len(made["port"]) == (10 if "flatcam" in case else 5)
    _same_printed(port_out, jax_out)
    assert os.path.basename(out) == os.path.basename(ref)
    for i in range(5):
        for sub in ("reconstruction", "object_plane"):   # sensor_plane: held in _same_made
            assert _png_levels(_saved(out, f"{sub}/im{i}.png"),
                               _saved(ref, f"{sub}/im{i}.png")) <= 1


def test_mask_dataset_app_simulates_only(images, tmp_path, capsys, made):
    """``recon.algo=null``: the pairs saved, the folder returned."""
    args = [f"files.dataset={images}", *MASK, *CLEAN, "mask.type=FZA", "recon.algo=null"]
    out, ref, port_out, jax_out = _both_printed(tmp_path, "sim.mask_dataset", args, capsys)
    _same_made(made)
    assert "Simulated dataset saved to" in port_out and "PSNR" not in port_out
    assert os.path.basename(out) == os.path.basename(ref) == "imgs_FZA"


# --- digicam_psf ---------------------------------------------------------------------------

@pytest.fixture
def pattern(tmp_path):
    path = tmp_path / "pattern.npy"
    np.save(path, (np.random.RandomState(0).rand(3, 128, 160) * 255).astype(np.uint8))
    return path


def test_digicam_psf_app_matches_jax(pattern, tmp_path, capsys):
    """The PSF, the saved mask values (column-major) and the PNG; a
    measured PSF given, the overlay drawn."""
    psf_fp = tmp_path / "meas.png"
    cv2.imwrite(str(psf_fp), (np.random.RandomState(1).rand(190, 253, 3) * 255)
                .astype(np.uint8))
    args = [f"files.pattern={pattern}", "digicam.downsample=16", f"files.psf={psf_fp}"]
    out, ref, port_out, jax_out = _both_printed(tmp_path, "sim.digicam_psf", args, capsys)
    assert out.shape == ref.shape == (190, 253, 3)
    assert _nerr(out, ref) <= TOL_SIM
    np.testing.assert_array_equal(np.load(_saved(tmp_path / "port", "mask_vals.npy")),
                                  np.load(_saved(tmp_path / "jax", "mask_vals.npy")))
    assert _png_levels(_saved(tmp_path / "port", "pattern_SIM_psf.png"),
                       _saved(tmp_path / "jax", "pattern_SIM_psf.png")) <= 1
    for name in ("sim_psf_plot.png", "meas_psf_plot.png", "psf_overlay.png"):
        assert _saved(tmp_path / "port", name).is_file()
    lines = [ln for ln in jax_out.splitlines() if ln.startswith(("Controllable", "Total"))]
    assert lines and all(ln in port_out.splitlines() for ln in lines)


@pytest.mark.parametrize("shift", [(40, -30), (0, 17)])
def test_digicam_psf_app_shifts_the_mask(pattern, tmp_path, shift):
    """Shifts on the full-resolution grid, divided by the downsample."""
    args = [f"files.pattern={pattern}", "digicam.downsample=16", "save=false",
            f"digicam.vertical_shift={shift[0]}", f"digicam.horizontal_shift={shift[1]}"]
    port, jax_app, entry = APPS["sim.digicam_psf"]
    ref = _run(getattr(jax_app, entry), args, tmp_path / "jax")
    out = _run(getattr(port, entry), args, tmp_path / "port")
    assert _nerr(out, ref) <= TOL_SIM
    assert not list((tmp_path / "port").rglob("*.png"))


# --- dataset ------------------------------------------------------------------------------

@pytest.fixture
def psf_png(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "psf.png"
    cv2.imwrite(str(path), (rng.rand(64, 96, 3) * 200 + 20).astype(np.uint8))
    return path


@pytest.mark.parametrize("case", ["batch2", "batch8+noise"])
def test_sim_dataset_app_matches_jax(images, psf_png, tmp_path, capsys, jax_noise, made, case):
    """Five files through a 64 x 96 PSF, ADMM in calls of two or of all
    five, without noise and with the config's 40 dB: every pair, the
    averaged metrics and each saved reconstruction."""
    noisy = case.endswith("+noise")
    args = [f"files.dataset={images}", f"files.psf={psf_png}", "simulation.downsample=1",
            "admm.n_iter=3", f"admm.batch_size={case[5]}", *([] if noisy else CLEAN)]
    out, ref, port_out, jax_out = _both_printed(tmp_path, "sim.dataset", args, capsys)
    _same_made(made, TOL_NOISY if noisy else TOL_SIM)
    assert len(made["port"]) == 5
    _same_printed(port_out, jax_out)
    for i in range(5):
        assert _png_levels(_saved(out, f"reconstruction/im{i}.png"),
                           _saved(ref, f"reconstruction/im{i}.png")) <= 1


def test_sim_dataset_app_without_admm(images, psf_png, tmp_path, capsys, made):
    args = [f"files.dataset={images}", f"files.psf={psf_png}", "simulation.downsample=1",
            *CLEAN, "admm.enable=False", "files.n_files=2"]
    out, ref, port_out, _ = _both_printed(tmp_path, "sim.dataset", args, capsys)
    _same_made(made)
    assert len(made["port"]) == 2 and "Simulated dataset saved to" in port_out


# --- torch_dataset (the JAX jax_dataset.py) ----------------------------------------------

@pytest.fixture
def batches(monkeypatch):
    """Every batch each package's ``SimulatedFarFieldDataset.batches``
    yields, as numpy."""
    import lenslesspicam_tpu.data.datasets as jds
    import lenslesspicam_tpu_torch.data.datasets as tds

    got = {"jax": [], "port": []}
    for cls, side in ((jds.SimulatedFarFieldDataset, "jax"),
                      (tds.SimulatedFarFieldDataset, "port")):
        def recorded(self, *args, _inner=cls.batches, _side=side, **kwargs):
            for b in _inner(self, *args, **kwargs):
                got[_side].append({k: np.asarray(v) for k, v in b.items()})
                yield b

        monkeypatch.setattr(cls, "batches", recorded)
    return got


@pytest.mark.parametrize("psf", ["random", "file"])
def test_torch_dataset_app_matches_jax(images, psf_png, tmp_path, capsys, made, batches, psf):
    """Five files in shuffled batches of two: the count, the printed
    shapes, every pair and every batch (the quantized measurements within
    one level); the seeded random PSF or a PSF file."""
    args = [f"files.dataset={images}", "files.batch_size=2", *CLEAN]
    if psf == "file":
        args += [f"files.psf={psf_png}", "simulation.downsample=1"]
    out, ref, port_out, jax_out = _both_printed(tmp_path, "sim.torch_dataset", args, capsys)
    assert out == ref == 3
    shapes = [ln for ln in jax_out.splitlines() if "shape" in ln]
    assert len(shapes) == 2 and shapes == [ln for ln in port_out.splitlines() if "shape" in ln]
    _same_made(made)
    assert len(made["port"]) == 5
    assert len(batches["port"]) == len(batches["jax"]) == 3
    for p, j in zip(batches["port"], batches["jax"]):
        assert sorted(p) == sorted(j) == ["lensed", "lensless"]
        assert _nerr(p["lensed"], j["lensed"]) <= TOL_SIM
        assert np.abs(p["lensless"] - j["lensless"]).max() <= 1


def test_torch_dataset_app_with_noise_matches_jax(images, tmp_path, capsys, jax_noise, made,
                                                  batches):
    """The defaults' 40 dB of shot noise, drawn as JAX draws it."""
    args = [f"files.dataset={images}", "files.batch_size=4"]
    out, ref, _, _ = _both_printed(tmp_path, "sim.torch_dataset", args, capsys)
    assert out == ref == 2
    _same_made(made, TOL_NOISY)


# --- the gates of chip_smoke.py's phase cli2 --------------------------------------------

def test_cli2_gates_hold_what_they_claim():
    """``_cli2_same_metrics``: a PSNR 0.02 dB off fails, an inversion exact to
    round-off on both sides (PSNR above 100 dB) passes; ``_Cli2Records``:
    a quantized simulated plane is recorded with its unquantized twin, an
    ADMM solve with its PSF, and everything is put back after."""
    import chip_smoke as cs
    from lenslesspicam_tpu_torch.recon import admm

    ok = {"MSE": 0.01, "PSNR": 20.0, "SSIM": 0.5}
    assert cs._cli2_same_metrics("x", dict(ok), ok)["gaps"]["PSNR"] == 0.0
    with pytest.raises(AssertionError, match="PSNR"):
        cs._cli2_same_metrics("x", {**ok, "PSNR": 20.02}, ok)
    exact = {"MSE": 1e-13, "PSNR": 130.0, "SSIM": 1.0}
    assert cs._cli2_same_metrics("x", {**exact, "PSNR": 129.0}, exact)["exact"]
    with pytest.raises(AssertionError):
        cs._cli2_same_metrics("x", {**exact, "PSNR": 90.0}, exact)

    rng = np.random.RandomState(0)
    psf = rng.rand(1, 16, 24, 3).astype(np.float32)
    sim = tsim.FarFieldSimulator(object_height=0.3, scene2mask=0.4, mask2sensor=0.002,
                                 sensor="rpi_hq", psf=psf, device="cpu")
    saved = (tsim.FarFieldSimulator.propagate_image, admm.run_jit)
    with cs._Cli2Records() as r:
        q, _ = sim.propagate_image(rng.rand(16, 24, 3).astype(np.float32),
                                   return_object_plane=True)
        admm.run_jit(admm.make_convolver(psf, device="cpu"), as_host(q)[None, None], n_iter=2)
    assert (tsim.FarFieldSimulator.propagate_image, admm.run_jit) == saved
    (quantized, (clean, obj)), = r.sims
    np.testing.assert_array_equal(quantized, as_host(q))
    assert clean.max() < quantized.max() == 255 and obj.shape == (16, 24, 3)
    (psf_rec, data, n, out), = r.solves
    np.testing.assert_array_equal(psf_rec, psf)
    assert n == 2 and data.shape == (1, 1, 16, 24, 3) and out.shape == (1, 1, 16, 24, 3)
    assert cs._cli2_same_records("x", r, r)["admm_same_inputs"] == 0.0
