"""The port's ``scripts/data`` apps (``rename_mirflickr25k``,
``prepare_mirflickr_subset``, ``convert_3d``, ``plot_psf``,
``upload_dataset_hf``), the end-to-end ``demo`` (``scripts/demo.py``) and
the ViT classifier (``classify/train_celeba_vit``) against the JAX
package's scripts of the same paths, in-process on the CPU
(``LPT_PLATFORM=cpu``) on the same seeded inputs; the helpers and
tolerances of ``tests/test_torch_scripts.py``.

Text outputs are compared byte for byte: the renamed and the copied file
lists, ``convert_3d``'s OBJ text.  Arrays: a stored or copied array bit for
bit, an 8-bit image within one level, an ``AdafruitLCD`` PSF within
TOL_SIM.  The demo reaches the Raspberry Pi through each package's
``hardware/remote.py`` under ``tests/test_torch_scripts_capture.py``'s
``StandInPi``; its reconstruction is held within TOL_ADMM (ADMM) or TOL_GD
(FISTA) of the JAX app's.  The hub's modules (``huggingface_hub``,
``datasets``) are stand-ins in ``sys.modules``: nothing reaches the
network.

The ViT: a seeded tiny ``FlaxViTForImageClassification`` (2 layers, width
32, 224 x 224, patch 16, a 2-label head) saved for the JAX app, the same
weights written as a PyTorch checkpoint by transformers' own flax loading
(in this test only) for the port; both apps train one epoch of 2 batches,
their losses agree within TOL_VIT relative, and the change the steps make
to each parameter agrees within TOL_VIT_STEP (the JAX app's trained tree
mapped by the same loader), which holds AdamW to optax's weight decay.
"""

import re
import sys
import time
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from test_torch_scripts import (APPS, TOL_ADMM, TOL_GD, TOL_SIM, _nerr, _png_levels, _run,
                                _saved, one_thread)  # noqa: F401
from test_torch_scripts_capture import PI, StandInPi, _files, _same

pytestmark = pytest.mark.usefixtures("one_thread")

TOL_VIT = 1e-4              # the losses, relative
# Each parameter's change over the steps, the worst leaf's error in norm
# relative to the JAX change's norm: 1.7e-3 at optax's decay of 1e-4 (an
# attention output weight) and 1.7e-2 at PyTorch's default of 1e-2 (the
# LayerNorm weights), on this test's inputs.  The attention's key biases are left out: softmax is invariant
# to them, so their gradient is 0 up to rounding, which Adam's first steps
# scale to a change of +-lr.
TOL_VIT_STEP = 5e-3


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")
    monkeypatch.setattr(time, "sleep", lambda s: None)


def _both_lines(tmp_path, name, args_of, capsys):
    """Each app's result and printed lines (run roots and timestamps made
    equal), each in a run directory of its own."""
    port, jax_app, entry = APPS[name]
    out = {}
    for side, mod in (("jax", jax_app), ("port", port)):
        res = _run(getattr(mod, entry), args_of(side), tmp_path / side)
        out[side] = (res, _same(capsys.readouterr().out, tmp_path).splitlines())
    return out


# --- data: rename_mirflickr25k, prepare_mirflickr_subset ---------------------------------

def test_rename_mirflickr25k_app_matches_jax(tmp_path, capsys):
    """``im{k}.jpg`` -> ``{k - 1}.jpg``: the same names, contents moved with
    them, the same count."""
    for side in ("jax", "port"):
        d = tmp_path / "data" / side
        d.mkdir(parents=True)
        for k in (1, 2, 10, 11, 25):
            (d / f"im{k}.jpg").write_bytes(f"image {k}".encode())
        (d / "notes.txt").write_text("kept")
    out = _both_lines(tmp_path, "data.rename_mirflickr25k",
                      lambda side: [f"dir_path={tmp_path / 'data' / side}"], capsys)
    assert out["port"][0] == out["jax"][0] == 5
    assert out["port"][1] == out["jax"][1] == ["Number of files: 5", "Done"]
    names = {s: sorted(p.name for p in (tmp_path / "data" / s).iterdir()) for s in out}
    assert names["port"] == names["jax"] == ["0.jpg", "1.jpg", "10.jpg", "24.jpg", "9.jpg",
                                             "notes.txt"]
    assert (tmp_path / "data" / "port" / "24.jpg").read_bytes() == b"image 25"


def _diffusercam_folder(root, n=6, shape=(80, 120, 3)):
    rng = np.random.RandomState(14)
    for sub in ("diffuser_images", "ground_truth_lensed"):
        (root / "dataset" / sub).mkdir(parents=True)
    for k in range(n):
        for sub in ("diffuser_images", "ground_truth_lensed"):
            np.save(root / "dataset" / sub / f"im{k}.npy", rng.rand(*shape).astype(np.float32))
    cv2.imwrite(str(root / "psf.tiff"), (rng.rand(*shape) * 255).astype(np.uint8))
    return root


def test_prepare_mirflickr_subset_app_matches_jax(tmp_path, capsys):
    """The seeded shuffle picks the same files; the copies are the files,
    the ``.tif`` views the same pixels."""
    from PIL import Image

    data = _diffusercam_folder(tmp_path / "mirflickr")
    out = _both_lines(tmp_path, "data.prepare_mirflickr_subset",
                      lambda side: [f"data={data}", "n_files=3", "seed=11"], capsys)
    strip = lambda s: re.sub(r"_\d{8}_\d\dh\d\d_", "_<stamp>_", s)  # noqa: E731
    assert [strip(ln) for ln in out["port"][1]] == [strip(ln) for ln in out["jax"][1]]
    roots = {s: Path(out[s][0]) for s in out}
    files = {s: [strip(f) for f in _files(roots[s])] for s in out}
    assert files["port"] == files["jax"]
    assert len([f for f in files["port"] if f.startswith("diffuser/")]) == 6
    for f in _files(roots["port"]):
        a, b = roots["port"] / f, roots["jax"] / f
        if f.endswith(".tif"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        else:
            assert a.read_bytes() == b.read_bytes(), f


# --- data: convert_3d -------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["npy", "npz", "tiff", "obj", "mat_obj"])
def test_convert_3d_app_matches_jax(tmp_path, capsys, fmt):
    """Each format's files from a seeded volume; the OBJ mesh's text byte
    for byte (its own threshold, and the default one from a ``.mat``)."""
    rng = np.random.RandomState(15)
    vol = rng.rand(4, 6, 5, 3).astype(np.float32) * (rng.rand(4, 6, 5, 1) > 0.6)
    if fmt == "mat_obj":
        from scipy.io import savemat

        savemat(tmp_path / "vol.mat", {"volume": vol.sum(-1)})
        args = [f"fp={tmp_path / 'vol.mat'}", "format=obj"]
    else:
        np.save(tmp_path / "vol.npy", vol)
        args = [f"fp={tmp_path / 'vol.npy'}", f"format={fmt}"]
        if fmt == "obj":
            args.append("threshold=0.3")
    out = _both_lines(tmp_path, "data.convert_3d", lambda side: args, capsys)
    assert out["port"][1] == out["jax"][1]
    run = {s: _saved(tmp_path / s, "config.yaml").parent for s in out}
    files = {s: [f for f in _files(run[s]) if f != "config.yaml"] for s in out}
    assert files["port"] == files["jax"] and files["port"]
    for f in files["port"]:
        a, b = run["port"] / f, run["jax"] / f
        if f.endswith(".tiff"):
            np.testing.assert_array_equal(cv2.imread(str(a), cv2.IMREAD_UNCHANGED),
                                          cv2.imread(str(b), cv2.IMREAD_UNCHANGED))
        elif f.endswith(".npz"):
            np.testing.assert_array_equal(np.load(a)["arr_0"], np.load(b)["arr_0"])
        else:
            assert a.read_bytes() == b.read_bytes(), f
    if "obj" in fmt:
        assert out["port"][1][1].startswith("wrote ")


def test_volume_to_obj_matches_jax(tmp_path):
    """``volume_to_obj`` on a 3-D and a 4-D volume, default and given
    thresholds: the same text."""
    rng = np.random.RandomState(16)
    port, jax_app, _ = APPS["data.convert_3d"]
    for vol, thr in ((rng.rand(3, 4, 5), None), (rng.rand(2, 3, 3, 2), 0.5)):
        a = port.volume_to_obj(vol, str(tmp_path / "a.obj"), threshold=thr)
        b = jax_app.volume_to_obj(vol, str(tmp_path / "b.obj"), threshold=thr)
        assert Path(a).read_text() == Path(b).read_text()


# --- data: plot_psf ---------------------------------------------------------------------

def test_plot_psf_app_mask_matches_jax(tmp_path, capsys):
    """A stored mask pattern (``.npy``) through each package's
    ``AdafruitLCD`` (``downsample=16``): the PSF within TOL_SIM of its max
    (read from the saved PNG's value before quantization, as the app
    computes it) and the gamma-corrected PNG within one level."""
    from lenslesspicam_tpu.hardware.trainable_mask import AdafruitLCD as JLCD
    from lenslesspicam_tpu_torch.hardware.trainable_mask import AdafruitLCD as TLCD

    vals = np.random.RandomState(17).uniform(0, 1, (18, 26)).astype(np.float32)
    np.save(tmp_path / "mask.npy", vals)
    out = _both_lines(tmp_path, "data.plot_psf",
                      lambda side: [f"psf={tmp_path / 'mask.npy'}", "downsample=16"], capsys)
    assert [Path(out[s][0]).name for s in out] == ["mask_psf.png"] * 2
    assert out["port"][1] == out["jax"][1]
    assert _png_levels(out["port"][0], out["jax"][0]) <= 1
    kw = dict(sensor="rpi_hq", downsample=16, flipud=False, scene2mask=0.3, mask2sensor=0.002,
              deadspace=True)
    j, t = JLCD(initial_vals=vals, **kw), TLCD(initial_vals=vals, device="cpu", **kw)
    with torch.no_grad():
        assert _nerr(t.get_psf(t.params).numpy(), np.asarray(j.get_psf(j.params))) <= TOL_SIM


@pytest.mark.parametrize("hub", [False, True])
def test_plot_psf_app_file_matches_jax(tmp_path, capsys, monkeypatch, hub):
    """A PSF image, downsampled and flipped, from a local path or from a
    stand-in ``huggingface_hub``."""
    psf = (np.random.RandomState(18).rand(64, 96, 3) * 200 + 20).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "psf.png"), psf)
    args = [f"psf={tmp_path / 'psf.png'}", "downsample=2", "flip_ud=True", "gamma=2.2"]
    if hub:
        asked = []
        monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
            hf_hub_download=lambda **kw: asked.append(kw) or str(tmp_path / kw["filename"])))
        args = ["repo_id=owner/psfs", "psf=psf.png", *args[1:]]
    out = _both_lines(tmp_path, "data.plot_psf", lambda side: args, capsys)
    assert out["port"][1] == out["jax"][1]
    assert Path(out["port"][0]).name == ("psfs_psf.png" if hub else "psf_psf.png")
    assert _png_levels(out["port"][0], out["jax"][0]) <= 1
    if hub:
        assert asked == [{"repo_id": "owner/psfs", "filename": "psf.png",
                          "repo_type": "dataset"}] * 2


# --- data: upload_dataset_hf ------------------------------------------------------------

def test_upload_dataset_hf_app_matches_jax(tmp_path, capsys, monkeypatch):
    """On stand-in ``datasets`` / ``huggingface_hub``: the same columns,
    casts, split and uploads."""
    for sub in ("lensless", "lensed", "ambient"):
        (tmp_path / sub).mkdir()
        for k in range(7):
            (tmp_path / sub / f"{k}.png").write_bytes(b"x")
    calls = []

    class Dataset:
        def __init__(self, data, rows):
            self.data, self.rows = data, rows

        @classmethod
        def from_dict(cls, data):
            calls.append(("from_dict", {k: [Path(v).name for v in vs] for k, vs in data.items()}))
            return cls(data, list(range(len(next(iter(data.values()))))))

        def __len__(self):
            return len(self.rows)

        def cast_column(self, col, feature):
            calls.append(("cast_column", col, type(feature).__name__))
            return self

        def select(self, idx):
            return Dataset(self.data, [self.rows[i] for i in idx])

    class DatasetDict(dict):
        def push_to_hub(self, repo):
            calls.append(("push_to_hub", repo, {k: v.rows for k, v in self.items()}))

    class HfApi:
        def upload_file(self, **kw):
            calls.append(("upload_file", Path(kw["path_or_fileobj"]).name,
                          kw["path_in_repo"], kw["repo_id"], kw["repo_type"]))

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        Dataset=Dataset, DatasetDict=DatasetDict, Image=type("Image", (), {})))
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(HfApi=HfApi))
    args = ["repo_id=owner/ds", f"lensless_dir={tmp_path / 'lensless'}",
            f"lensed_dir={tmp_path / 'lensed'}", f"ambient_dir={tmp_path / 'ambient'}",
            f"psf={tmp_path / 'lensless' / '0.png'}", "test_size=0.3"]
    out = _both_lines(tmp_path, "data.upload_dataset_hf", lambda side: args, capsys)
    half = len(calls) // 2
    assert calls[:half] == calls[half:]
    assert ("push_to_hub", "owner/ds", {"train": [2, 3, 4, 5, 6], "test": [0, 1]}) in calls
    assert out["port"][1] == out["jax"][1] == ["uploaded 7 pairs to owner/ds"]


# --- demo -------------------------------------------------------------------------------

DEMO = [*PI, "plot=False", "capture.delay=0", "display.wait=0"]


def _demo_psf(tmp_path):
    psf = (np.random.RandomState(19).rand(64, 96, 3) * 200 + 20).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "psf.png"), psf)
    img = tmp_path / "tree.png"
    cv2.imwrite(str(img), (np.random.RandomState(20).rand(24, 32, 3) * 255).astype(np.uint8))
    return [f"fp={img}", f"camera.psf={tmp_path / 'psf.png'}", "recon.downsample=2"]


def _demo_results(tmp_path, args, monkeypatch, capsys):
    """Each package's demo under its own StandInPi, its ``reconstructed``
    image recorded as ``save_image`` was given it."""
    from lenslesspicam_tpu.data import io as jio
    from lenslesspicam_tpu_torch.data import io as tio

    port, jax_app, entry = APPS["demo"]
    out = {}
    for side, mod, io in (("jax", jax_app, jio), ("port", port, tio)):
        saved = {}
        save = io.save_image

        def record(img, fp, *a, _save=save, _saved=saved, **kw):
            _saved[Path(fp).name] = np.asarray(img)
            return _save(img, fp, *a, **kw)

        monkeypatch.setattr(io, "save_image", record)
        rpi = StandInPi(monkeypatch)
        res = _run(getattr(mod, entry), args, tmp_path / side)
        rpi.calls = [tuple(_same(str(x), tmp_path) for x in c) for c in rpi.calls]
        out[side] = (res, rpi, _same(capsys.readouterr().out, tmp_path).splitlines(), saved)
    return out


@pytest.mark.parametrize("case", ["admm", "fista", "admm_flip_crop", "mask"])
def test_demo_app_matches_jax(tmp_path, monkeypatch, capsys, case):
    """Display, (mask,) capture, solve in chunks of ``disp_iter``, crop,
    save: the same commands, lines and files; the raw capture removed; the
    run directory returned."""
    args = [*DEMO, "recon.admm.n_iter=5", "recon.admm.disp_iter=2", "recon.fista.n_iter=5",
            "recon.fista.disp_iter=3"]
    if case == "mask":
        img = tmp_path / "tree.png"
        cv2.imwrite(str(img), np.zeros((8, 8, 3), np.uint8))
        args += [f"fp={img}", "recon.downsample=16",
                 "camera.mask={seed: 5, mask_shape: [18, 26], mask_center: [57, 77]}"]
    else:
        args += _demo_psf(tmp_path)
    if case == "fista":
        args.append("recon.algo=fista")
    if case == "admm_flip_crop":
        args += ["recon.flipud=True", "postproc.crop_hor=[0.1,0.9]", "postproc.crop_vert=[0,0.5]"]
    out = _demo_results(tmp_path, args, monkeypatch, capsys)
    assert out["port"][1].calls == out["jax"][1].calls
    if case == "mask":
        np.testing.assert_array_equal(out["port"][1].patterns[0], out["jax"][1].patterns[0])
    num = lambda lines: [re.sub(r"\d+\.\d+ s", "# s", ln) for ln in lines]  # noqa: E731
    assert num(out["port"][2]) == num(out["jax"][2])
    assert _same(out["port"][0], tmp_path) == _same(out["jax"][0], tmp_path)
    for side in out:
        names = _files(out[side][0])
        assert "reconstructed.png" in names and "raw_data.png" not in names
        assert {"raw.png", "histogram.png", "psf.png"} <= set(names)
    res, ref = (out[s][3]["reconstructed.png"] for s in ("port", "jax"))
    assert _nerr(res, ref) <= (TOL_GD if case == "fista" else TOL_ADMM)
    if case == "admm_flip_crop":
        assert res.shape == (16, 39, 3)     # rows [0, 16), columns [4, 43) of 32 x 48
    assert _png_levels(Path(out["port"][0]) / "reconstructed.png",
                       Path(out["jax"][0]) / "reconstructed.png") <= 1


def test_demo_app_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib (as on the card's machine) the plots are skipped,
    said so, and the reconstruction is still saved; a fault in the
    plotting itself still raises."""
    import matplotlib.pyplot as plt

    port, _, entry = APPS["demo"]
    args = [*DEMO, "recon.admm.n_iter=3", *_demo_psf(tmp_path)]
    StandInPi(monkeypatch)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        run = _run(getattr(port, entry), args, tmp_path / "without")
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert _files(run) == ["config.yaml", "reconstructed.png"]

    def broken(*a, **kw):
        raise RuntimeError("a plotting fault")

    monkeypatch.setattr(plt, "savefig", broken)
    with pytest.raises(RuntimeError, match="a plotting fault"):
        _run(getattr(port, entry), args, tmp_path / "faulty")


# --- classify: train_celeba_vit ---------------------------------------------------------

VIT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           image_size=224, patch_size=16, num_labels=2)


@pytest.fixture(scope="module")
def vit_checkpoints(tmp_path_factory):
    """A seeded tiny flax ViT with its 2-label head, and the same weights
    as a PyTorch checkpoint (transformers' flax loading)."""
    from transformers import FlaxViTForImageClassification, ViTConfig, ViTForImageClassification
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    root = tmp_path_factory.mktemp("vit")
    flax = FlaxViTForImageClassification(ViTConfig(**VIT), seed=0)
    flax.save_pretrained(root / "flax")
    # ``from_pretrained(from_flax=True)`` leaves meta tensors in this version of transformers
    load_flax_weights_in_pytorch_model(ViTForImageClassification(ViTConfig(**VIT)),
                                       flax.params).save_pretrained(root / "torch")
    return root


class _MeanSpy(types.ModuleType):
    """numpy, with the lists that ``np.mean`` is given recorded (each
    epoch's per-step losses)."""

    def __init__(self):
        super().__init__("numpy_spy")
        self.means = []

    def __getattr__(self, name):
        return getattr(np, name)

    def mean(self, x, *a, **kw):
        self.means.append(list(x))
        return np.mean(x, *a, **kw)


def _vit_step_gap(trained, reference, start):
    """The worst parameter's ``|(trained - start) - (reference - start)| /
    |reference - start|`` over the state dicts' entries, key biases left
    out (see TOL_VIT_STEP)."""
    gaps = [np.linalg.norm((trained[k] - start[k]) - (reference[k] - start[k]))
            / np.linalg.norm(reference[k] - start[k])
            for k in start if not k.endswith("attention.key.bias")]
    return max(gaps)


def test_train_celeba_vit_app_matches_jax(tmp_path, monkeypatch, capsys, vit_checkpoints):
    """One epoch of 2 batches of 2 224 x 224 images: the per-step losses
    (the second after one AdamW step) and the printed epoch loss agree
    within TOL_VIT relative, and each parameter's change within
    TOL_VIT_STEP; PyTorch's default weight decay would miss it."""
    from transformers import ViTConfig, ViTForImageClassification
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    rng = np.random.RandomState(21)
    data = tmp_path / "celeba"
    data.mkdir()
    for k in range(4):
        cv2.imwrite(str(data / f"{k:03d}.png"), (rng.rand(224, 224, 3) * 255).astype(np.uint8))
    np.save(data / "labels.npy", np.array([0, 1, 1, 0]))
    port, jax_app, entry = APPS["classify.train_celeba_vit"]
    args = lambda ckpt: [f"data_dir={data}", f"model_name={vit_checkpoints / ckpt}",  # noqa: E731
                         "epochs=1", "batch_size=2", "lr=1e-3"]
    losses, printed, trained = {}, {}, {}
    for side, mod, ckpt in (("jax", jax_app, "flax"), ("port", port, "torch")):
        spy = _MeanSpy()
        monkeypatch.setattr(mod, "np", spy)
        trained[side] = _run(getattr(mod, entry), args(ckpt), tmp_path / side)
        losses[side], printed[side] = spy.means, capsys.readouterr().out
    assert [len(x) for x in losses["port"]] == [len(x) for x in losses["jax"]] == [2]
    for a, b in zip(losses["port"][0], losses["jax"][0]):
        assert abs(a - b) <= TOL_VIT * abs(b), (losses["port"], losses["jax"])
    (p,), (j,) = (re.findall(r"^epoch 0: loss (\S+)$", printed[s], re.M) for s in ("port", "jax"))
    assert abs(float(p) - float(j)) <= TOL_VIT * abs(float(j)) + 0.5e-4
    assert abs(np.mean(losses["port"][0]) - np.mean(losses["jax"][0])) <= TOL_VIT * abs(
        np.mean(losses["jax"][0]))

    start = {k: v.numpy() for k, v in ViTForImageClassification.from_pretrained(
        vit_checkpoints / "torch").state_dict().items()}
    reference = {k: v.numpy() for k, v in load_flax_weights_in_pytorch_model(
        ViTForImageClassification(ViTConfig(**VIT)), trained["jax"]).state_dict().items()}
    assert set(trained["port"]) == set(start)
    assert _vit_step_gap(trained["port"], reference, start) <= TOL_VIT_STEP
    monkeypatch.setitem(port.ADAMW, "weight_decay", 1e-2)
    torch_default = _run(getattr(port, entry), args("torch"), tmp_path / "decay_1e-2")
    assert _vit_step_gap(torch_default, reference, start) > TOL_VIT_STEP


def test_train_celeba_vit_app_returns_numpy_weights(tmp_path, monkeypatch, vit_checkpoints):
    """The trained weights as numpy arrays under the model's state-dict
    names, changed by the steps."""
    from transformers import ViTForImageClassification

    data = tmp_path / "celeba"
    data.mkdir()
    cv2.imwrite(str(data / "a.png"), np.full((224, 224, 3), 90, np.uint8))
    np.save(data / "labels.npy", np.array([1]))
    port, _, entry = APPS["classify.train_celeba_vit"]
    out = _run(getattr(port, entry), [f"data_dir={data}",
                                      f"model_name={vit_checkpoints / 'torch'}", "epochs=1"],
               tmp_path / "run")
    start = ViTForImageClassification.from_pretrained(vit_checkpoints / "torch").state_dict()
    assert set(out) == set(start)
    assert all(isinstance(v, np.ndarray) for v in out.values())
    assert not np.array_equal(out["classifier.weight"], start["classifier.weight"].numpy())
