"""The port's hub-model apps (``lenslesspicam_tpu_torch/scripts/recon``:
``diffusercam_mirflickr``, ``multilens_ambient``,
``digicam_mirflickr_psf_err``) against the JAX package's scripts of the
same paths, in-process on the CPU (``LPT_PLATFORM=cpu``), on stand-in
``datasets`` / ``huggingface_hub`` modules put in ``sys.modules`` by
``monkeypatch`` (nothing reaches the network; ``tests/test_torch_scripts_models.py``'s
way): seeded 32 x 48 rows, a seeded unrolled ADMM of 3 iterations as the zoo
checkpoint, 3-5 iterations.  The helpers and tolerances are
``tests/test_torch_scripts.py``'s: ADMM within TOL_ADMM of the max, a
learned model within TOL_LEARNED, each metric within TOL_METRIC relative,
a simulated PSF within TOL_SIM, a saved 8-bit PNG within one level.

``digicam_mirflickr_psf_err`` sweeps all six ``percent_pixels_wrong``
values over two rows of a ``digicam_mirflickr_multi``-like split (two mask
labels, 19 x 26 patterns, rows at the RPi HQ sensor's 1/16 grid): the
perturbed patterns are recorded where each package simulates their PSF and
must be equal, as must ``psf_err`` within TOL_METRIC.
"""

import json
import sys
import types

import cv2
import numpy as np
import pytest
import torch
import yaml

from lenslesspicam_tpu_torch import convert

from test_torch_scripts import (APPS, REPO, TOL_ADMM, TOL_LEARNED, TOL_METRIC, TOL_SIM, _Rows,
                                _nerr, _png_levels, _run, _saved, one_thread)  # noqa: F401

sys.path.insert(0, str(REPO / "scripts" / "recon"))     # the JAX apps' `_pretrained`

CPU = "cpu"
NC = [4, 8, 16, 16]                  # tests/test_torch_zoo_load.py's widths
UNROLLED = {"method": "unrolled_admm", "unrolled_admm": {"n_iter": 3},
            "pre_process": {"network": None}, "post_process": {"network": None}}
MASK_SHAPE = (19, 26)
MULTI_GRID = (190, 253)              # the RPi HQ sensor at 1/16
MULTI_ALIGN = {"top_left": [40, 60], "height": 96, "width": 128}
PERCENTS = "[0,0.5,1,2,5,10]"


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")






@pytest.fixture
def hub(monkeypatch, tmp_path):
    """Stand-in ``datasets`` and ``huggingface_hub``: every split is
    ``hub.rows`` (four seeded 32 x 48 rows unless a test sets others), a
    file is the one of that name under ``hub.dir``, a snapshot the folder
    ``hub.snapshots[repo_id]``."""
    rng = np.random.RandomState(5)
    folder = tmp_path / "hub"
    (folder / "masks").mkdir(parents=True)
    state = types.SimpleNamespace(dir=folder, snapshots={}, rows=_Rows([
        {"lensless": (rng.rand(32, 48, 3) * 255).astype(np.uint8),
         "lensed": (rng.rand(32, 48, 3) * 255).astype(np.uint8)} for _ in range(4)]))
    cv2.imwrite(str(folder / "psf.png"), (rng.rand(32, 48, 3) * 200 + 20).astype(np.uint8))
    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=lambda repo, split=None, cache_dir=None, **_: state.rows))
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        hf_hub_download=lambda repo_id, filename, **_: str(folder / filename),
        snapshot_download=lambda repo_id, **_: state.snapshots[repo_id]))
    return state


def _checkpoint(folder, config, model=None, seed=3):
    """A reference checkpoint folder (``zoo.load_model``'s layout: the Hydra
    config, the unrolled schedules at the state dict's top level) of a
    seeded ``model``, by default an unrolled ADMM of 3 iterations."""
    from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM

    if model is None:
        model = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=3, device=CPU), device=CPU)
    sd = convert.state_dict(model, convert.random_variables(model, seed))
    sd = {k.replace("camera_inversion._", "_"): v for k, v in sd.items()}
    (folder / ".hydra").mkdir(parents=True)
    with open(folder / ".hydra" / "config.yaml", "w") as f:
        yaml.safe_dump(config, f)
    torch.save(sd, folder / "recon_epochBEST")
    return str(folder)


def _both(tmp_path, name, args):
    port, jax_app, entry = APPS[name]
    ref = _run(getattr(jax_app, entry), args, tmp_path / "jax")
    out = _run(getattr(port, entry), args, tmp_path / "port")
    return out, ref


# --- diffusercam_mirflickr ----------------------------------------------------------------

@pytest.fixture
def diffusercam(tmp_path):
    """A local DiffuserCam-MirFlickr folder: five 64 x 96 x 3 .npy pairs
    (BGR, downsampled by 2 to 32 x 48) and a 128 x 192 PSF (by 4)."""
    rng = np.random.RandomState(6)
    root = tmp_path / "DiffuserCam"
    for sub in ("diffuser_images", "ground_truth_lensed"):
        (root / sub).mkdir(parents=True)
        for i in range(5):
            np.save(root / sub / f"im{i}.npy", rng.rand(64, 96, 3).astype(np.float32))
    cv2.imwrite(str(root / "psf.tiff"), (rng.rand(128, 192, 3) * 200 + 20).astype(np.uint8))
    return root


@pytest.mark.parametrize("model", ["admm", "zoo"])
def test_diffusercam_mirflickr_app_matches_jax(diffusercam, tmp_path, model):
    """``files.dataset`` a local folder; ADMM, or a zoo model from a local
    checkpoint folder (``model_path=``)."""
    args = [f"files.dataset={diffusercam}", f"files.psf={diffusercam / 'psf.tiff'}", "idx=1",
            "n_iter=5", "n_trials=1"]
    if model == "zoo":
        path = _checkpoint(tmp_path / "ckpt", {"reconstruction": UNROLLED})
        args += ["model_name=U5+Unet8M", f"model_path={path}"]
    (out, ms), (ref, _) = _both(tmp_path, "recon.diffusercam_mirflickr", args)
    assert isinstance(out, np.ndarray) and out.shape == np.shape(ref) == (1, 1, 32, 48, 3)
    assert ms > 0
    assert _nerr(out, np.asarray(ref)) <= (TOL_ADMM if model == "admm" else TOL_LEARNED)
    name = "admm_idx1.png" if model == "admm" else "U5+Unet8M_idx1.png"
    for png in (name, "original_idx1.png", "lensless_idx1.png"):
        assert _png_levels(_saved(tmp_path / "port", png), _saved(tmp_path / "jax", png)) <= 1


# --- multilens_ambient --------------------------------------------------------------------

def _multilens(hub, tmp_path, model):
    """A multilens checkpoint folder (ADMM's dataset config, or a seeded
    unrolled ADMM with a learned background-subtraction UNetRes) whose
    config names the stand-in hub's dataset and PSF; a raw measurement
    and background as local PNGs on the PSF's 32 x 48 grid (the JAX app
    fails on a file it must resize)."""
    from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
    from lenslesspicam_tpu_torch.models.unet import UNetRes
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM

    config = {"files": {"dataset": "owner/multilens", "huggingface_psf": "psf.png",
                        "downsample": 1}, "reconstruction": dict(UNROLLED)}
    net = None
    if model == "learned_sub":
        config["reconstruction"]["learned_background_subtraction"] = NC
        net = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=3, device=CPU),
                             background_network=UNetRes(in_nc=4, out_nc=3, nc=tuple(NC),
                                                        nb=len(NC), device=CPU), device=CPU)
    path = _checkpoint(tmp_path / "ckpt", config, net, seed=7)
    rng = np.random.RandomState(8)
    for name, scale in (("raw.png", 255), ("bg.png", 60)):
        cv2.imwrite(str(tmp_path / name), (rng.rand(32, 48, 3) * scale).astype(np.uint8))
    return path


MULTILENS = {"sample": [], "files": ["fn={raw}", "background_fn={bg}"],
             "files_rotated": ["fn={raw}", "background_fn={bg}", "rotate=True"],
             "files_no_sub": ["fn={raw}", "background_fn={bg}", "background_sub=False"]}


@pytest.mark.parametrize("model,case", [
    (m, c) for m in ("admm", "learned_sub") for c in MULTILENS
    if (m, c) != ("learned_sub", "files_no_sub")])
def test_multilens_ambient_app_matches_jax(hub, tmp_path, model, case):
    """A test-set sample (no measured background: zeros) or local ``fn=`` /
    ``background_fn=`` files resized to the PSF grid, normalized by one
    factor, the background passed to the model (ADMM subtracts it)."""
    path = _multilens(hub, tmp_path, model)
    args = [f"model_path={path}", f"model={'admm' if model == 'admm' else 'U5+Unet8M'}",
            "n_iter=5", "n_trials=1",
            *(a.format(raw=tmp_path / "raw.png", bg=tmp_path / "bg.png")
              for a in MULTILENS[case])]
    (out, ms), (ref, _) = _both(tmp_path, "recon.multilens_ambient", args)
    assert isinstance(out, np.ndarray) and out.shape == np.shape(ref) == (1, 1, 32, 48, 3)
    assert _nerr(out, np.asarray(ref)) <= (TOL_ADMM if model == "admm" else TOL_LEARNED)
    stem = "0" if case == "sample" else "raw"
    tag = "admm" if model == "admm" else "U5+Unet8M"
    for png in (f"{tag}_idx{stem}.png", f"lensless_idx{stem}.png", "psf.png"):
        assert _png_levels(_saved(tmp_path / "port", png), _saved(tmp_path / "jax", png)) <= 1


def test_multilens_ambient_app_needs_the_background_of_a_subtracting_model(hub, tmp_path):
    """``background_sub=false`` on a model that subtracts a learned
    background: the port's model raises, as the JAX model asserts."""
    path = _multilens(hub, tmp_path, "learned_sub")
    port, _, entry = APPS["recon.multilens_ambient"]
    with pytest.raises(ValueError, match="pass background="):
        _run(getattr(port, entry), [f"model_path={path}", "model=U5+Unet8M", "n_trials=1",
                                    f"fn={tmp_path / 'raw.png'}", "background_sub=False"],
             tmp_path / "port")


def test_multilens_ambient_reads_a_local_file_without_the_hub(tmp_path, monkeypatch):
    """``_load_raw`` reads a local file before it asks the hub: with no
    ``huggingface_hub`` installed (``None`` in ``sys.modules``) it still
    loads it, and resizes a file off the PSF grid as the JAX package's
    ``resize`` does the ``(D, H, W, C)`` stack; a file not on the disk
    needs the hub."""
    from lenslesspicam_tpu.data.image import resize as jresize
    from lenslesspicam_tpu.data.io import load_image as jload

    from lenslesspicam_tpu_torch.scripts.recon.multilens_ambient import _load_raw

    fp = str(tmp_path / "raw.png")
    cv2.imwrite(fp, (np.random.RandomState(9).rand(64, 96, 3) * 255).astype(np.uint8))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    img = _load_raw("owner/multilens", fp, (1, 32, 48, 3))
    ref = jresize(jload(fp, return_float=True, as_4d=True, normalize=False),
                  shape=(32, 48, 3))
    assert img.shape == ref.shape == (1, 32, 48, 3) and img.max() > 1
    assert _nerr(img, ref) <= TOL_SIM
    with pytest.raises(ImportError):
        _load_raw("owner/multilens", "not_local.png", (1, 32, 48, 3))


# --- digicam_mirflickr_psf_err ------------------------------------------------------------

@pytest.fixture
def multimask(hub, tmp_path):
    """Two rows of a ``digicam_mirflickr_multi``-like split (mask labels 0
    and 1, 190 x 253 measurements, 19 x 26 patterns in ``masks/``) and the
    sibling checkpoint that ``model=admm`` reads its dataset config from."""
    from lenslesspicam_tpu_torch.zoo.model_dict import model_dict

    rng = np.random.RandomState(10)
    hub.rows = _Rows([{"lensless": (rng.rand(*MULTI_GRID, 3) * 255).astype(np.uint8),
                       "lensed": (rng.rand(120, 160, 3) * 255).astype(np.uint8),
                       "mask_label": i} for i in range(2)])
    for lab in range(2):
        np.save(hub.dir / "masks" / f"mask_{lab}.npy", rng.rand(*MASK_SHAPE).astype(np.float32))
    entries = model_dict["digicam"]["mirflickr_multi_25k"]
    config = {"files": {"dataset": "owner/digicam_multi", "downsample": 1, "rotate": True},
              "alignment": MULTI_ALIGN, "reconstruction": UNROLLED}
    hub.snapshots[entries[next(iter(entries))]] = _checkpoint(tmp_path / "ckpt", config)
    return hub


@pytest.fixture
def perturbed(monkeypatch):
    """The mask values each package simulates a PSF of, in order."""
    import lenslesspicam_tpu.data.datasets as jds
    import lenslesspicam_tpu_torch.data.datasets as tds

    got = {"jax": [], "port": []}
    for cls, side in ((jds.HFDataset, "jax"), (tds.HFDataset, "port")):
        def recorded(self, mask_vals, _inner=cls.simulate_psf, _side=side):
            got[_side].append(np.array(mask_vals))
            return _inner(self, mask_vals)

        monkeypatch.setattr(cls, "simulate_psf", recorded)
    return got


@pytest.mark.parametrize("flip", [True, False])
def test_psf_err_app_matches_jax(multimask, tmp_path, perturbed, flip):
    """All six shares of wrong pixels over two rows (flipped, or drawn
    anew): the same perturbed patterns, ``psf_err`` and each metric, the
    ``metrics.json`` written and the figures drawn."""
    args = ["model=admm", "n_iter=3", f"percent_pixels_wrong={PERCENTS}", f"flip={flip}",
            "save_idx=[1]"]
    out, ref = _both(tmp_path, "recon.digicam_mirflickr_psf_err", args)
    n = len(perturbed["jax"])
    assert n == len(perturbed["port"]) == 2 + 2 * 6       # the labels' PSFs, then the sweep
    for a, b in zip(perturbed["port"], perturbed["jax"]):
        np.testing.assert_array_equal(a, b)
    n_pixels = int(np.prod(MASK_SHAPE))
    for i, vals in enumerate(perturbed["port"][2:]):
        row, p = divmod(i, 6)
        wrong = int(n_pixels * [0, 0.5, 1, 2, 5, 10][p] / 100)
        assert int((vals != perturbed["port"][row]).sum()) == wrong
    assert sorted(out) == sorted(ref) == ["LPIPS_Vgg", "PSNR", "SSIM", "psf_err"]
    for k in ("PSNR", "SSIM", "psf_err"):
        o, r = np.asarray(out[k]), np.asarray(ref[k])
        assert o.shape == r.shape == (6, 2)
        np.testing.assert_array_equal(o[0] == 0, r[0] == 0)
        for x, y in zip(o.ravel(), r.ravel()):
            assert abs(x - y) <= TOL_METRIC * max(abs(y), 1e-12) or (k == "psf_err" and y == 0)
    assert np.isnan(out["LPIPS_Vgg"]).all() and np.isnan(ref["LPIPS_Vgg"]).all()
    saved = json.load(open(_saved(tmp_path / "port", "metrics.json")))
    assert saved["PSNR"] == out["PSNR"]
    assert {p.name for p in (tmp_path / "port").rglob("*_vs_psf_err.png")} == {
        f"{k}_vs_psf_err.png" for k in ref}
    assert _png_levels(_saved(tmp_path / "port", "recon_err0.0.png"),
                       _saved(tmp_path / "jax", "recon_err0.0.png")) <= 1


def test_psf_err_sweep_psfs_match_jax(multimask, tmp_path, perturbed):
    """Each perturbed pattern's PSF, simulated by the port's and the JAX
    package's ``AdafruitLCD``, within TOL_SIM of its max."""
    import lenslesspicam_tpu.data.datasets as jds
    import lenslesspicam_tpu_torch.data.datasets as tds

    kw = dict(huggingface_repo="owner/digicam_multi", split=multimask.rows, rotate=True)
    j, t = jds.HFDataset(**kw), tds.HFDataset(device=CPU, **kw)
    vals = t.get_mask_vals(1)
    flat = vals.reshape(-1).copy()
    flat[np.random.RandomState(0).choice(flat.size, 24, replace=False)] *= -1
    for v in (vals, flat.reshape(vals.shape) + 1):
        assert _nerr(t.simulate_psf(v), np.asarray(j.simulate_psf(v))) <= TOL_SIM


def test_psf_err_app_replots_stored_metrics(tmp_path, capsys):
    """``metrics_fp=``: no sweep, the figures of the stored metrics."""
    metrics = {"PSNR": [[20.0, 21.0]] * 6, "SSIM": [[0.5, 0.6]] * 6,
               "LPIPS_Vgg": [[float("nan")] * 2] * 6, "psf_err": [[0.0, 0.0]] + [[0.1, 0.2]] * 5}
    (tmp_path / "m.json").write_text(json.dumps(metrics))
    out, ref = _both(tmp_path, "recon.digicam_mirflickr_psf_err",
                     [f"metrics_fp={tmp_path / 'm.json'}"])
    assert json.dumps(out) == json.dumps(ref) == json.dumps(metrics)
    assert len(list((tmp_path / "port").rglob("*_vs_psf_err.png"))) == 4
    assert capsys.readouterr().out.count("plots saved to") == 2


def test_key_to_ratio_correct_matches_jax():
    from scripts.recon.digicam_mirflickr_psf_err import key_to_ratio_correct as jkey

    from lenslesspicam_tpu_torch.scripts.recon.digicam_mirflickr_psf_err import \
        key_to_ratio_correct as tkey

    for args in ((494 * 0.05, 2, 494), (100, 8, 1482), (np.arange(6.0), 2, 50)):
        np.testing.assert_array_equal(tkey(*args), jkey(*args))
