"""The port's data layer against the JAX package on the CPU: the rest of
``data.image`` (the numpy demosaic against OpenCV's
``COLOR_BayerRG2RGB``, the Raspberry Pi HQ ISP chain ``bayer2rgb_cc``, the
Bayer round trip, ``autocorr2d``, ``rotate_HWC``, ``shift_with_pad``,
``get_max_val``, ``gamma_correction``, ``print_image_info``), ``data.io``
(``load_image``, ``load_psf``, ``load_data``, ``save_image`` and its PNG
encoder) on the same files, ``VirtualSensor.capture(scene=<path>)`` and
``benchmark(save_idx=, save_dir=)``, and the path from files (raw .npy
mosaics, a PNG out, a checkpoint folder) with neither OpenCV nor Pillow
importable.

Inputs come from numpy with a fixed seed, files are written once for both
packages.  Tolerances:

- bit-equal where only numpy runs (the demosaic against OpenCV too);
- after a resize (``downsample``, ``shape``), max |port - JAX| / max |JAX|
  within 1e-5 for a float image, the tolerance ``tests/test_torch_eval.py``
  holds ``data.image.resize`` to, and one level for an integer image
  (OpenCV resizes 8- and 16-bit images in fixed point, the port in float64
  and rounds);
- ``rotate_HWC``: 1e-4 (OpenCV's warp in the JAX package, bilinear in
  float64 in the port; ``tests/test_torch_eval.py``'s TOL_ROTATE);
- ``capture`` from a file: bit-equal to the capture of the array
  ``load_image`` reads; against JAX one level of the integer scene after
  normalization to the sensor's depth, plus one (see the test);
  ``benchmark``'s metrics 1e-4.
"""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import cv2
import numpy as np
import pytest
import torch

from lenslesspicam_tpu.data import image as jimage
from lenslesspicam_tpu.data import io as jio
from lenslesspicam_tpu.eval import benchmark as jbench
from lenslesspicam_tpu.hardware import constants as jconst
from lenslesspicam_tpu.hardware import sensor as jsensor

from lenslesspicam_tpu_torch.data import image as timage
from lenslesspicam_tpu_torch.data import io as tio
from lenslesspicam_tpu_torch.eval import benchmark as tbench
from lenslesspicam_tpu_torch.hardware import constants as tconst
from lenslesspicam_tpu_torch.hardware import sensor as tsensor

CPU = "cpu"
TOL_RESIZE = 1e-5
TOL_ROTATE = 1e-4
TOL_METRICS = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _equal(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape, (out.dtype, ref.dtype)
    np.testing.assert_array_equal(out, ref)


def _levels(out, ref):
    """Max difference in levels of two integer images."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    return int(np.abs(out.astype(np.int64) - ref.astype(np.int64)).max())


# --- data.image --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,top", [(np.uint8, 256), (np.uint16, 4096), (np.uint16, 65536)])
@pytest.mark.parametrize("shape", [(8, 10), (7, 9), (6, 11), (33, 47), (3, 3), (4, 5), (2, 6),
                                   (5, 1)])
def test_demosaic_is_opencv_bit_for_bit(dtype, top, shape):
    raw = np.random.RandomState(shape[0] * 100 + shape[1]).randint(0, top, shape).astype(dtype)
    _equal(timage.demosaic(raw), cv2.cvtColor(raw, cv2.COLOR_BayerRG2RGB))


@pytest.mark.parametrize("kw", [{}, dict(red_gain=1.9, blue_gain=1.3),
                                dict(black_level=64, nbits_out=8, red_gain=2.0),
                                dict(ccm=np.eye(3) * 0.9, nbits_out=16)])
@pytest.mark.parametrize("shape", [(31, 45), (32, 48)])
def test_bayer2rgb_cc_matches_jax(kw, shape):
    raw = np.random.RandomState(1).randint(0, 4096, shape).astype(np.uint16)
    _equal(timage.bayer2rgb_cc(raw, 12, **kw), jimage.bayer2rgb_cc(raw, 12, **kw))
    down = dict(kw, down=2)
    assert _levels(timage.bayer2rgb_cc(raw, 12, **down), jimage.bayer2rgb_cc(raw, 12, **down)) <= 1
    np.testing.assert_array_equal(tconst.RPI_HQ_CAMERA_CCM_MATRIX, jconst.RPI_HQ_CAMERA_CCM_MATRIX)
    assert tconst.RPI_HQ_CAMERA_BLACK_LEVEL == jconst.RPI_HQ_CAMERA_BLACK_LEVEL


def test_image_helpers_match_jax():
    rng = np.random.RandomState(2)
    img = rng.rand(2, 30, 41, 3).astype(np.float32)
    for angle in (7.5, -30.0, 90.0):
        assert _rel(timage.rotate_HWC(img, angle), jimage.rotate_HWC(img, angle)) <= TOL_ROTATE
    u8 = (img[0] * 255).astype(np.uint8)
    assert _levels(timage.rotate_HWC(u8, 12.0), jimage.rotate_HWC(u8, 12.0)) <= 1
    _equal(timage.autocorr2d(img[0, ..., 0]), jimage.autocorr2d(img[0, ..., 0]))
    for pattern in ("RGGB", "bggr", "GRBG"):
        _equal(timage.rgb2bayer(img[0], pattern), jimage.rgb2bayer(img[0], pattern))
        _equal(timage.bayer2rgb(timage.rgb2bayer(img[0], pattern), pattern),
               jimage.bayer2rgb(jimage.rgb2bayer(img[0], pattern), pattern))
    rgb = timage.bayer2rgb(timage.rgb2bayer(img[0]))
    np.testing.assert_allclose(rgb, img[0, 0:30:2, 0:40:2], rtol=0, atol=1.0)
    for shift, axis in (((3, -2), (0, 1)), ((-1,), (2,)), ((0, 4), (0, 1))):
        _equal(timage.shift_with_pad(img[0], shift, axis=axis),
               jimage.shift_with_pad(img[0], shift, axis=axis))
    u16 = (img * 3000).astype(np.uint16)
    for nbits in (None, 10, 11, 14):
        assert timage.get_max_val(u16, nbits) == jimage.get_max_val(u16, nbits)
    with pytest.raises(ValueError):
        timage.get_max_val(img)
    _equal(timage.gamma_correction(img, 2.2), jimage.gamma_correction(img, 2.2))
    assert np.array_equal(timage.FLOAT_DTYPES, jimage.FLOAT_DTYPES)
    np.testing.assert_array_equal(timage.SUPPORTED_BIT_DEPTH, jimage.SUPPORTED_BIT_DEPTH)
    outs = []
    for mod in (timage, jimage):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.print_image_info(u16)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


# --- data.io --------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """8- and 16-bit PNGs (RGB and gray), a float .npy, a raw 12-bit mosaic
    and a 3-D PSF stack as .npy and .npz."""
    d = tmp_path_factory.mktemp("io")
    rng = np.random.RandomState(3)
    paths = {}
    for name, img in (("rgb8.png", (rng.rand(40, 52, 3) * 255).astype(np.uint8)),
                      ("rgb16.png", (rng.rand(40, 52, 3) * 65535).astype(np.uint16)),
                      ("gray8.png", (rng.rand(40, 52) * 255).astype(np.uint8)),
                      ("gray16.png", (rng.rand(40, 52) * 4095).astype(np.uint16))):
        cv2.imwrite(str(d / name), img)
        paths[name] = str(d / name)
    for name, arr in (("rgb.npy", rng.rand(40, 52, 3).astype(np.float32)),
                      ("raw.npy", rng.randint(200, 4096, (40, 52)).astype(np.uint16)),
                      ("raw2.npy", rng.randint(200, 3000, (40, 52)).astype(np.uint16)),
                      ("stack.npy", rng.rand(3, 40, 52).astype(np.float32))):
        np.save(d / name, arr)
        paths[name] = str(d / name)
    np.savez(d / "stack.npz", psf=rng.rand(2, 40, 52, 3).astype(np.float32))
    paths["stack.npz"] = str(d / "stack.npz")
    return paths


LOAD_IMAGE = [{}, dict(flip=True), dict(flip_ud=True, as_4d=True), dict(flip_lr=True),
              dict(return_float=True), dict(return_float=True, normalize=False,
                                            dtype=np.float64),
              dict(bg=np.array([0.1, 0.2, 0.05]), return_float=True), dict(bgr_input=False),
              dict(downsample=2), dict(downsample=2, return_float=True),
              dict(shape=(1, 30, 20, 3), return_float=True, as_4d=True)]


@pytest.mark.parametrize("name", ["rgb8.png", "rgb16.png", "gray8.png", "gray16.png", "rgb.npy"])
@pytest.mark.parametrize("kw", LOAD_IMAGE)
def test_load_image_matches_jax(files, name, kw):
    if "gray" in name:      # one channel: a scalar background, a one-channel shape
        kw = {k: (v[:1] if k == "bg" else (1, 30, 20, 1) if k == "shape" else v)
              for k, v in kw.items()}
    out, ref = tio.load_image(files[name], **kw), jio.load_image(files[name], **kw)
    if "downsample" not in kw and "shape" not in kw:
        _equal(out, ref)
    elif np.issubdtype(ref.dtype, np.integer):
        assert _levels(out, ref) <= 1
    else:
        assert out.dtype == ref.dtype
        # a resized integer image is one level off at most, then divided by its peak
        peak = (tio.load_image(files[name], **{**kw, "return_float": False}).max()
                if name.endswith(".png") else np.inf)
        assert np.abs(out - ref).max() <= TOL_RESIZE * np.abs(ref).max() + 1.0 / peak


@pytest.mark.parametrize("kw", [dict(bayer=True), dict(bayer=True, red_gain=1.9, blue_gain=1.2),
                                dict(bayer=True, nbits_out=8, return_float=True)])
def test_load_image_bayer_matches_jax(files, kw):
    _equal(tio.load_image(files["raw.npy"], **kw), jio.load_image(files["raw.npy"], **kw))


PSF_CASES = [("gray16.png", {}), ("rgb16.png", dict(bg_pix=(0, 10), return_bg=True)),
             ("rgb8.png", dict(single_psf=True)), ("rgb8.png", dict(bg_pix=None)),
             ("gray8.png", dict(force_rgb=True, return_float=False)),
             ("raw.npy", dict(bayer=True, red_gain=1.9, blue_gain=1.2, return_bg=True)),
             ("stack.npy", dict(use_3d=True)), ("stack.npz", dict(use_3d=True, return_bg=True)),
             ("rgb16.png", dict(downsample=2)), ("rgb8.png", dict(shape=(1, 20, 26, 3))),
             ("gray16.png", dict(flip=True, verbose=False))]


@pytest.mark.parametrize("name,kw", PSF_CASES)
def test_load_psf_matches_jax(files, name, kw):
    out, ref = tio.load_psf(files[name], **kw), jio.load_psf(files[name], **kw)
    pairs = zip(out, ref) if kw.get("return_bg") else [(out, ref)]
    for a, b in pairs:
        if "downsample" in kw or "shape" in kw:
            assert _rel(a, b) <= TOL_RESIZE
        else:
            _equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kw", [dict(downsample=1, gray=True), dict(downsample=2),
                                dict(downsample=1, bayer=True, red_gain=1.9, blue_gain=1.2,
                                     gray=True),
                                dict(shape=(1, 20, 26, 3), normalize=True)])
def test_load_data_matches_jax(files, kw):
    names = ("raw.npy", "raw2.npy") if kw.get("bayer") else ("rgb16.png", "rgb8.png")
    out = tio.load_data(files[names[0]], files[names[1]], **kw)
    ref = jio.load_data(files[names[0]], files[names[1]], **kw)
    for a, b in zip(out, ref):
        if kw.get("downsample", 1) != 1 or "shape" in kw:
            assert a.dtype == b.dtype and _rel(a, b) <= TOL_RESIZE
        else:
            _equal(a, b)
    if kw.get("gray"):
        assert out[0].shape[-1] == out[1].shape[-1] == 1


SAVE_SHAPES = [(20, 30, 3), (21, 31), (20, 30, 1), (2, 1, 20, 30, 3)]


@pytest.mark.parametrize("shape,ext", [(s, "png") for s in SAVE_SHAPES + [(5, 7, 4)]]
                         + [(s, "jpg") for s in SAVE_SHAPES])
def test_save_image_matches_jax(tmp_path, shape, ext):
    """The port's file decodes to the JAX package's pixels (its PNG by the
    port's encoder, RGBA included, any other format by OpenCV as in the
    JAX package)."""
    img = np.random.RandomState(4).rand(*shape).astype(np.float32) * 3 - 1
    for kw in ({}, dict(normalize=False, max_val=200)):
        assert tio.save_image(img, str(tmp_path / f"t.{ext}"), **kw) == str(tmp_path / f"t.{ext}")
        jio.save_image(img, str(tmp_path / f"j.{ext}"), **kw)
        out = cv2.imread(str(tmp_path / f"t.{ext}"), cv2.IMREAD_UNCHANGED)
        _equal(out, cv2.imread(str(tmp_path / f"j.{ext}"), cv2.IMREAD_UNCHANGED))
        tio.save_image(torch.from_numpy(img), str(tmp_path / f"tensor.{ext}"), **kw)
        _equal(cv2.imread(str(tmp_path / f"tensor.{ext}"), cv2.IMREAD_UNCHANGED), out)


def test_encode_png_refuses_what_it_cannot_write():
    with pytest.raises(ValueError):
        tio.encode_png(np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError):
        tio.encode_png(np.zeros((4, 4, 2), np.uint8))


def test_io_without_opencv(files, tmp_path, monkeypatch):
    """Without cv2 a PNG is still written and a .npy / .npz still read; a
    PNG or a JPG read and a JPG written raise an ImportError naming the
    format."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"\.png"):
        tio.load_image(files["rgb8.png"])
    with pytest.raises(ImportError, match=r"\.jpg"):
        tio.save_image(np.ones((4, 4, 3)), str(tmp_path / "x.jpg"))
    tio.save_image(np.ones((4, 4, 3)), str(tmp_path / "x.png"))
    assert tio.load_psf(files["stack.npz"], use_3d=True).shape == (2, 40, 52, 3)
    assert tio.load_data(files["raw.npy"], files["raw2.npy"], downsample=1, bayer=True,
                         gray=True)[1].shape == (1, 40, 52, 1)


def test_path_from_files_imports_no_codec(tmp_path):
    """In a fresh interpreter where cv2 and PIL cannot be imported, the
    port's package, its data layer and zoo import, load_data reads raw
    .npy mosaics, save_image writes a PNG and load_model reads a
    checkpoint folder."""
    import yaml

    from lenslesspicam_tpu_torch import convert
    from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM

    model = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=2, device=CPU), device=CPU)
    torch.save(convert.state_dict(model, convert.random_variables(model, 0)),
               tmp_path / "recon_epochBEST")
    os.makedirs(tmp_path / ".hydra")
    with open(tmp_path / ".hydra" / "config.yaml", "w") as f:
        yaml.safe_dump({"reconstruction": {"method": "unrolled_admm",
                                           "unrolled_admm": {"n_iter": 2}}}, f)
    rng = np.random.RandomState(5)
    for name in ("psf", "data"):
        np.save(tmp_path / f"{name}.npy", rng.randint(200, 4096, (24, 32)).astype(np.uint16))
    code = f"""
import sys
for name in ("cv2", "PIL"):
    sys.modules[name] = None
import lenslesspicam_tpu_torch, lenslesspicam_tpu_torch.data.datasets
import lenslesspicam_tpu_torch.data.simulation, lenslesspicam_tpu_torch.ops.propagation
from lenslesspicam_tpu_torch.data.io import load_data, save_image
from lenslesspicam_tpu_torch.zoo.model_dict import load_model
d = {str(tmp_path)!r}
psf, data = load_data(d + "/psf.npy", d + "/data.npy", downsample=1, bayer=True, gray=True)
save_image(data[0], d + "/out.png")
model, config = load_model(d, device="cpu")
out = model(data[None].repeat(3, -1), psf.repeat(3, -1))
print("OK", tuple(out.shape), config["reconstruction"]["unrolled_admm"]["n_iter"])
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["OK", "(1,", "1,", "24,", "32,", "3)", "2"]
    assert cv2.imread(str(tmp_path / "out.png"), cv2.IMREAD_UNCHANGED).shape == (24, 32)


# --- the sensor and the benchmark ----------------------------------------------------------------

@pytest.mark.parametrize("name,downsample,bit_depth", [("rpi_hq", 40, None),
                                                       ("basler_287", 6, 12)])
def test_sensor_capture_from_a_file(files, name, downsample, bit_depth):
    """The file's capture is the capture of the array ``load_image`` reads,
    bit for bit; against the JAX package it is within one level of the
    scene (OpenCV resizes an integer scene in fixed point, the port in
    float64 and rounds) carried through the normalization to the
    sensor's depth, plus the truncation's level."""
    t = tsensor.VirtualSensor.from_name(name, downsample=downsample)
    j = jsensor.VirtualSensor.from_name(name, downsample=downsample)
    for scene in ("rgb8.png", "gray16.png"):
        out = t.capture(files[scene], bit_depth=bit_depth)
        _equal(out, t.capture(tio.load_image(files[scene]), bit_depth=bit_depth))
        ref = j.capture(files[scene], bit_depth=bit_depth)
        top = 2 ** (bit_depth or 8) - 1
        assert _levels(out, ref) <= 1 + top / tio.load_image(files[scene]).max()


def test_benchmark_saves_the_chosen_reconstructions(tmp_path):
    """``save_idx`` counts samples over all batches: the port writes the
    same files as the JAX package, with the same pixels, and its metrics
    match."""
    rng = np.random.RandomState(6)
    batches = [{"lensless": rng.rand(2, 1, 16, 20, 3).astype(np.float32),
                "lensed": rng.rand(2, 1, 16, 20, 3).astype(np.float32)} for _ in range(2)]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    out = tbench.benchmark(lambda x: x * 0.5, batches, save_idx=[0, 3], save_dir=str(tmp_path / "t"),
                           device=CPU)
    ref = jbench.benchmark(lambda x: x * 0.5, batches, save_idx=[0, 3], save_dir=str(tmp_path / "j"))
    assert out.keys() == ref.keys()
    for k in ref:
        assert abs(out[k] - float(ref[k])) <= TOL_METRICS * abs(float(ref[k]))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["recon_0.png", "recon_3.png"]
    for f in os.listdir(tmp_path / "j"):
        _equal(cv2.imread(str(tmp_path / "t" / f), cv2.IMREAD_UNCHANGED),
               cv2.imread(str(tmp_path / "j" / f), cv2.IMREAD_UNCHANGED))
