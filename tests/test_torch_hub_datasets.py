"""The port's hub-format and hardware-in-the-loop datasets against the JAX
package's on the CPU: ``HFDataset`` (multimask PSFs simulated through
``AdafruitLCD``, random flips and epochs, simulated and measured
backgrounds, the downloaded PSF with ``psf_snr``, the alignment, crop,
display, rotate and flip geometry, the alignment's simulator),
``HFSimulated`` (the convolution, the alignment paste, shot noise),
``get_dataset``, ``HITLDatasetTrainableMask`` (simulated, and the SSH
path's calls to ``hardware/remote.py``), one multimask training step, and
the two hub calls of ``zoo.model_dict.download_model`` and
``data.datasets.simulate_dataset``.

Rows are the duck-typed in-memory dataset of tests/test_datasets.py:113-137
(a list of dict rows with ``column_names``), made from numpy with a fixed
seed and fed to both packages.  Nothing reaches the network, and nothing
needs the ``datasets`` or ``huggingface_hub`` packages: the hub calls go
to stand-in modules put in ``sys.modules``, which return local files
written by the test, and the mask patterns of ``get_mask_vals`` are
seeded arrays (``_local`` below, as tests/test_datasets.py:140-149 does).
Where noise is drawn, the port's draw (``ops.noise._normal``) is patched to
the ``jax.random`` draw the JAX package makes from the same seed of the
dataset's ``RandomState`` stream.

Tolerances, max |port - JAX| / max |JAX|:

- simulated PSFs: 1e-5, tests/test_torch_masks.py's ``AdafruitLCD`` PSF;
- samples and extra fields: 1e-5 where a resize, a convolution or the
  noise runs (tests/test_torch_optics.py's datasets), else equal;
- ``HFSimulated`` and the simulated HITL measurements: 1e-5;
- the shot noise at ``snr_db=40`` with the port's own draws: 40 +- 1 dB;
- the training step's loss: 1e-5 relative, tests/test_torch_train.py's.
"""

import sys
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lenslesspicam_tpu.data import datasets as jds
from lenslesspicam_tpu.data import io as jio
from lenslesspicam_tpu.hardware import remote as jremote
from lenslesspicam_tpu.hardware import trainable_mask as jtm
from lenslesspicam_tpu.models.trainable_recon import TrainableRecon as JRecon
from lenslesspicam_tpu.models.unrolled import UnrolledADMM as JADMM
from lenslesspicam_tpu.train import trainer as jt
from lenslesspicam_tpu.zoo import model_dict as jzoo

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.data import datasets as tds
from lenslesspicam_tpu_torch.data import io as tio
from lenslesspicam_tpu_torch.hardware import remote as tremote
from lenslesspicam_tpu_torch.hardware import trainable_mask as ttm
from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon as TRecon
from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM as TADMM
from lenslesspicam_tpu_torch.ops import noise as tnoise
from lenslesspicam_tpu_torch.train import trainer as tt
from lenslesspicam_tpu_torch.zoo import model_dict as tzoo

CPU = "cpu"
TOL_PSF = 1e-5
TOL = 1e-5
TOL_SNR_DB = 1.0
TOL_LOSS = 1e-5
O0 = {"xla_backend_optimization_level": 0}


def _rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    if ref.dtype.kind in "biu":        # flags and labels: equal
        return 0.0 if np.array_equal(out, ref) else np.inf
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


class _Hub:
    """Duck-type of a loaded ``datasets.Dataset``: dict rows and
    ``column_names``."""

    def __init__(self, rows):
        self.rows = rows
        self.column_names = list(rows[0].keys())

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        return self.rows[int(idx)]


def _hub(n=4, h=16, w=24, multimask=True, ambient=False, seed=0, labels=2):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        row = {"lensless": (rng.rand(h, w, 3) * 255).astype(np.uint8),
               "lensed": (rng.rand(h, w, 3) * 255).astype(np.uint8)}
        if multimask:
            row["mask_label"] = i % labels
        if ambient:
            row["ambient"] = (rng.rand(h, w, 3) * 50).astype(np.uint8)
        rows.append(row)
    return _Hub(rows)


def _local(cls):
    """``cls`` with its mask patterns seeded instead of downloaded."""

    class Local(cls):
        def get_mask_vals(self, label):
            return np.random.RandomState(100 + int(label)).rand(3, 4).astype(np.float32)

    return Local


def _pair(name, *args, **kw):
    """The JAX package's and the port's ``name`` (seeded mask patterns),
    built from the same arguments, the port's on the CPU."""
    return (_local(getattr(jds, name))(*args, **kw),
            _local(getattr(tds, name))(*args, device=CPU, **kw))


def _same_batches(t, j, batch_size=4, tol=TOL):
    tb, jb = list(t.batches(batch_size)), list(j.batches(batch_size))
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        assert sorted(a) == sorted(b)
        for key in b:
            assert _rel(a[key], b[key]) <= tol, key


@pytest.fixture
def seeded_normal(monkeypatch):
    """The port's normal draw for a generator seeded with s is
    ``jax.random.normal(PRNGKey(s))``, the JAX dataset's draw for the same
    seed of its RandomState stream."""
    monkeypatch.setattr(tnoise, "_normal", lambda x, g: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(g.initial_seed()), tuple(x.shape), jnp.float32))))


@pytest.fixture
def hub_files(monkeypatch, tmp_path):
    """A stand-in ``huggingface_hub`` whose ``hf_hub_download`` returns the
    file of that name under ``tmp_path`` and records its arguments; a
    ``write(name, array)`` helper writes the files (.npy, or .png through
    cv2)."""
    calls = []

    def hf_hub_download(**kw):
        calls.append(kw)
        return str(tmp_path / kw["filename"])

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        hf_hub_download=hf_hub_download, snapshot_download=None))

    def write(name, arr):
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        if name.endswith(".npy"):
            np.save(path, arr)
        else:
            cv2.imwrite(str(path), arr)
        return str(path)

    return types.SimpleNamespace(calls=calls, write=write, dir=tmp_path)


# --- HFDataset -------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", [dict(), dict(rotate=True), dict(h=32, w=48, downsample=2),
                                      dict(flipud=True, labels=3, n=6)])
def test_multimask_psfs_match_jax(geometry):
    """One PSF per mask label through ``AdafruitLCD`` (the port's on the
    CPU), resized to the lensless grid; the samples and each sample's
    PSF."""
    kw = dict(geometry)
    hub = _hub(**{k: kw.pop(k) for k in ("h", "w", "labels", "n") if k in kw})
    j, t = _pair("HFDataset", "local", split=hub, **kw)
    assert t.multimask and t.mask_labels == j.mask_labels
    for lab in j.mask_labels:
        assert isinstance(t.psf[lab], np.ndarray)
        assert _rel(t.psf[lab], j.psf[lab]) <= TOL_PSF
    _same_batches(t, j)
    jl, tl = _pair("HFDataset", "local", split=hub, return_mask_label=True, **kw)
    for idx in range(len(hub)):
        assert tl.extra_fields(idx) == {"mask_label": jl.extra_fields(idx)["mask_label"]}


@pytest.mark.parametrize("background", ["simulated", "measured", None])
@pytest.mark.parametrize("epoch", [0, 1])
def test_flips_epochs_and_backgrounds_match_jax(hub_files, background, epoch):
    """Random flips drawn per (seed, epoch, idx), the flipped PSFs and flip
    flags, a background file added at an SNR drawn from ``bg_snr_range``
    or the measured ``ambient`` column; each sample equals the flipped raw
    measurement plus the background its extra fields return."""
    hub = _hub(n=6, ambient=background == "measured")
    kw = dict(random_flip=True, seed=3)
    if background == "simulated":
        bg = (np.random.RandomState(7).rand(16, 24, 3) * 255).astype(np.uint8)
        kw.update(bg_fp=hub_files.write("bg.png", bg), bg_snr_range=(0, 10))
    j, t = _pair("HFDataset", "local", split=hub, **kw)
    j.set_epoch(epoch)
    t.set_epoch(epoch)
    flips = []
    for idx in range(len(hub)):
        assert t._augment_draws(idx) == j._augment_draws(idx)
        flips.append(t._augment_draws(idx)[:2])
        te, je = t.extra_fields(idx), j.extra_fields(idx)
        assert sorted(te) == sorted(je)
        for key in je:
            assert _rel(te[key], je[key]) <= TOL, key
        if background is not None:
            flip_lr, flip_ud, _ = t._augment_draws(idx)
            raw = t._raw_lensless(idx)
            raw = raw[:, ::-1] if flip_lr else raw
            raw = raw[::-1] if flip_ud else raw
            if background == "simulated":
                np.testing.assert_allclose(t[idx][0][0], raw + te["background"][0], atol=1e-5)
            else:
                assert te["background"].shape == (1, 16, 24, 3)
    assert any(a or b for a, b in flips)
    _same_batches(t, j, batch_size=3)
    t.set_epoch(epoch + 1)
    assert [t._augment_draws(i)[:2] for i in range(len(hub))] != flips


@pytest.mark.parametrize("psf_snr", [None, 10])
@pytest.mark.parametrize("single_channel_psf", [False, True])
def test_downloaded_psf_and_psf_snr_match_jax(hub_files, psf_snr, single_channel_psf):
    """The PSF file through a stand-in ``hf_hub_download`` (the same call in
    both packages), loaded with ``flip=rotate``, the lensless shape and
    ``bg_pix=(0, 15)``, with Gaussian noise at ``psf_snr`` dB from
    ``RandomState(seed)``, which reads ``psf_snr`` within 2 dB."""
    rng = np.random.RandomState(11)
    hub_files.write("psf.png", (rng.rand(20, 30, 3) * 255).astype(np.uint8))
    hub = _hub(multimask=False, ambient=True)
    kw = dict(psf="psf.png", psf_snr=psf_snr, single_channel_psf=single_channel_psf,
              rotate=True, seed=4)
    j = jds.HFDataset("owner/repo", split=hub, **kw)
    t = tds.HFDataset("owner/repo", split=hub, device=CPU, **kw)
    assert hub_files.calls == [dict(repo_id="owner/repo", filename="psf.png",
                                    repo_type="dataset")] * 2
    assert t.psf.shape == j.psf.shape == (1, 16, 24, 3)
    assert _rel(t.psf, j.psf) <= TOL
    assert t.measured_bg and j.measured_bg
    _same_batches(t, j)
    if psf_snr is not None:
        clean = tds.HFDataset("owner/repo", split=hub, device=CPU, **dict(kw, psf_snr=None))
        noise = t.psf - clean.psf
        snr_db = 10 * np.log10(clean.psf.var() / noise.var())
        assert abs(snr_db - psf_snr) <= 2 * TOL_SNR_DB


GEOMETRIES = {
    "alignment_display": dict(alignment={"top_left": [2, 3], "height": 8}, display_res=[9, 12]),
    "alignment_width": dict(alignment={"top_left": [4, 2], "height": 10, "width": 14}),
    "alignment_downsample": dict(alignment={"top_left": [4, 6], "height": 16},
                                 display_res=[9, 12], downsample=2),
    "crop": dict(alignment={"crop": {"vertical": [2, 14], "horizontal": [3, 20]}},
                 downsample=2),
    "display": dict(display_res=[10, 14]),
    "downsample_lensed": dict(downsample_lensed=2),
    "rotate_flip_lensed": dict(rotate=True, flip_lensed=True),
    "flipud_flip_lensed": dict(flipud=True, flip_lensed=True, force_rgb=True),
}


@pytest.mark.parametrize("name", GEOMETRIES)
def test_geometry_matches_jax(name):
    """Alignment (with the display's aspect or its own width), crop,
    display resolution, ``downsample`` and ``downsample_lensed``, rotate,
    flipud and ``flip_lensed``: the scaled geometry, the samples and
    ``extract_roi`` of a seeded reconstruction."""
    hub = _hub(h=32, w=40)
    j, t = _pair("HFDataset", "local", split=hub, **GEOMETRIES[name])
    assert t.alignment == j.alignment and t.crop == j.crop
    _same_batches(t, j)
    recon = np.random.RandomState(5).rand(2, 1, *t[0][0].shape[1:]).astype(np.float32)
    flags = np.array([True, False])
    for kw in (dict(), dict(flip_lr=flags, flip_ud=flags[::-1])):
        out, ref = t.extract_roi(recon, **kw), j.extract_roi(recon, **kw)
        assert np.array_equal(out, ref)


@pytest.mark.parametrize("simulate_lensless", [False, True])
def test_alignment_simulator_matches_jax(simulate_lensless):
    """``alignment["simulation"]`` builds a ``FarFieldSimulator`` (the
    port's on the CPU) with shifts scaled by ``downsample``: the lensed
    image projected to the object plane and, with ``simulate_lensless``,
    the measurement simulated through the first PSF."""
    sim = dict(scene2mask=0.25, mask2sensor=0.002, object_height=0.33, sensor="rpi_hq",
               snr_db=None, downsample=None, random_vflip=False, random_hflip=False,
               quantize=False, vertical_shift=-6, horizontal_shift=-4)
    kw = dict(alignment={"top_left": [4, 6], "height": 16, "simulation": sim},
              display_res=[9, 12], downsample=2, rotate=True,
              simulate_lensless=simulate_lensless)
    j, t = _pair("HFDataset", "local", split=_hub(h=32, w=48), **kw)
    assert (t.simulator.conv is None) == (j.simulator.conv is None) == (not simulate_lensless)
    assert t.simulator.vertical_shift == j.simulator.vertical_shift == -3
    _same_batches(t, j)


def test_string_split_needs_the_datasets_package(monkeypatch):
    """A split name needs ``datasets``: both packages raise ImportError
    with the same message without it (no load is tried)."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    for mod in (jds, tds):
        with pytest.raises(ImportError, match="HFDataset requires the `datasets` package"):
            mod.get_dataset("digicam_mirflickr_multi_mini", split="test")
        with pytest.raises(ImportError):
            mod.HFSimulated("owner/repo", split="test")
        with pytest.raises(ValueError, match="not available"):
            mod.get_dataset("nowhere", split=_hub())


# --- get_dataset -----------------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("digicam_mirflickr_multi", dict(downsample=4)),
    ("digicam_mirflickr_multi_mini", dict(downsample=4, random_flip=True, seed=2)),
    ("digicam_mirflickr", dict(downsample=4)),
    ("tapecam_mirflickr", dict(downsample=4, display_res=[450, 600])),
])
def test_get_dataset_matches_jax(hub_files, name, kwargs):
    """A registry entry's geometry updated by the kwargs: the same files
    asked of the hub (the multimask entries' ``masks/mask_{label}.npy``,
    the single-mask ``mask_pattern.npy``, a downloaded PSF), the same
    geometry, PSFs and samples."""
    rng = np.random.RandomState(9)
    for lab in range(3):
        hub_files.write(f"masks/mask_{lab}.npy", rng.rand(5, 7).astype(np.float32))
    hub_files.write("mask_pattern.npy", rng.rand(5, 7).astype(np.float32))
    hub_files.write("psf.png", (rng.rand(80, 120, 3) * 255).astype(np.uint8))
    hub = _hub(n=3, h=320, w=480, multimask=name.endswith(("multi", "mini")), labels=3)
    j = jds.get_dataset(name, split=hub, **kwargs)
    n_calls = len(hub_files.calls)
    t = tds.get_dataset(name, split=hub, device=CPU, **kwargs)
    assert type(t) is tds.HFDataset
    assert hub_files.calls[n_calls:] == hub_files.calls[:n_calls]
    repo = jds.available_datasets[name]["huggingface_repo"]
    assert {c["repo_id"] for c in hub_files.calls} == {repo}
    assert (t.alignment, t.crop, t.rotate, t.display_res) == (j.alignment, j.crop, j.rotate,
                                                              j.display_res)
    for lab, psf in (j.psf.items() if isinstance(j.psf, dict) else [(None, j.psf)]):
        assert _rel(t.psf[lab] if lab is not None else t.psf, psf) <= TOL_PSF
    _same_batches(t, j, batch_size=3)


# --- HFSimulated -----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(),
                                dict(alignment={"top_left": [2, 3], "height": 8},
                                     display_res=[9, 12]),
                                dict(flipud=True, downsample=2),
                                dict(psf="psf.png", single_channel_psf=True)])
def test_hf_simulated_matches_jax(hub_files, kw):
    """``snr_db=None``: the lensed image (resized, or pasted at the
    alignment onto a lensless-shaped canvas) convolved with the sample's
    PSF on the CPU, divided by its maximum above 1, within 1e-5; the
    per-sample PSFs of the multimask rows."""
    hub_files.write("psf.png", (np.random.RandomState(3).rand(16, 24, 3) * 255
                                ).astype(np.uint8))
    hub = _hub(h=32, w=48) if kw.get("downsample") else _hub(multimask="psf" not in kw)
    j, t = _pair("HFSimulated", "local", split=hub, snr_db=None, **kw)
    _same_batches(t, j)
    assert t.cropped_lensed_shape == j.cropped_lensed_shape
    assert len(t._convolvers) == len(j._convolvers)


def test_hf_simulated_shot_noise(seeded_normal):
    """``snr_db=40``: with the port's draw fed the JAX draw of the same
    seed, the samples match and the ``RandomState`` streams stay in step
    after each sample."""
    hub = _hub(n=4)
    j, t = _pair("HFSimulated", "local", split=hub, snr_db=40, seed=6)
    for idx in range(len(hub)):
        for a, b in zip(t[idx], j[idx]):
            assert _rel(a, b) <= TOL
        ts, js = t._rng.get_state(), j._rng.get_state()
        assert np.array_equal(ts[1], js[1]) and ts[2:] == js[2:]


def test_hf_simulated_noise_reads_its_snr():
    """The port's own draws at ``snr_db=40``: the noise, against the
    noiseless sample of the same row scaled to it, reads 40 +- 1 dB."""
    hub = _hub(n=3, h=48, w=64)
    noisy = _local(tds.HFSimulated)("local", split=hub, snr_db=40, device=CPU)
    clean = _local(tds.HFSimulated)("local", split=hub, snr_db=None, device=CPU)
    for idx in range(len(hub)):
        y, x = noisy[idx][0].astype(np.float64), clean[idx][0].astype(np.float64)
        scale = (y * x).sum() / (y * y).sum()
        snr = 10 * np.log10((x ** 2).sum() / ((scale * y - x) ** 2).sum())
        assert abs(snr - 40) <= TOL_SNR_DB, snr


# --- HITLDatasetTrainableMask ----------------------------------------------------------

MASK_KW = dict(sensor="rpi_hq", downsample=32, scene2mask=0.3, mask2sensor=0.002)


def test_hitl_simulated_matches_jax():
    """``simulate=True``: each lensed image pasted onto the PSF's grid and
    convolved with the mask's current PSF, within 1e-5 of JAX's; after new
    mask values, the new PSF's."""
    rng = np.random.RandomState(12)
    vals = rng.rand(10, 12).astype(np.float32)
    jm, tm = jtm.AdafruitLCD(vals, **MASK_KW), ttm.AdafruitLCD(vals, device=CPU, **MASK_KW)
    base = [rng.rand(60, 70, 3).astype(np.float32), rng.rand(120, 160).astype(np.float32)]
    j = jds.HITLDatasetTrainableMask(jm, base, simulate=True)
    t = tds.HITLDatasetTrainableMask(tm, base, simulate=True, device=CPU)
    assert len(t) == len(j) == 2

    def same():
        for idx in range(len(base)):
            for a, b in zip(t[idx], j[idx]):
                assert _rel(a, b) <= TOL
    same()
    new = rng.rand(10, 12).astype(np.float32)
    jm.params = {"vals": jnp.asarray(new)}
    with torch.no_grad():
        tm.params["vals"].copy_(torch.from_numpy(new))
    same()


def _record_hitl(monkeypatch, remote, io, image):
    """Replace ``remote``'s calls and ``io``'s file access by recorders;
    the capture returns ``image``."""
    calls = []

    def rec(name, result=None):
        def fn(*args, **kw):
            calls.append((name, [np.asarray(a).tolist() if isinstance(a, (np.ndarray, jax.Array))
                                 else a for a in args],
                          {k: np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
                           for k, v in kw.items()}))
            return result
        return fn

    monkeypatch.setattr(remote, "display", rec("display"))
    monkeypatch.setattr(remote, "set_programmable_mask", rec("set_programmable_mask"))
    monkeypatch.setattr(remote, "capture", rec("capture", ("/tmp/capture.png", None)))
    monkeypatch.setattr(io, "save_image", rec("save_image"))
    monkeypatch.setattr(io, "load_image", lambda fp, **kw: calls.append(
        ("load_image", [fp], kw)) or image)
    return calls


def test_hitl_hardware_path_matches_jax(monkeypatch):
    """The SSH path: the same display, mask and capture calls to
    ``hardware/remote.py`` (recorded in place of the SSH), the image
    saved for display and the captured file loaded; scratch files under
    the temporary directory, ``/tmp`` here as in the JAX package."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    rng = np.random.RandomState(13)
    vals = rng.rand(10, 12).astype(np.float32)
    base = [rng.rand(20, 30, 3).astype(np.float32)]
    captured = rng.rand(24, 32, 3).astype(np.float32)
    kw = dict(rpi_username="pi", rpi_hostname="rpi.local", display_kwargs={"wait": 0},
              capture_kwargs={"exp": 0.05})
    jcalls = _record_hitl(monkeypatch, jremote, jio, captured)
    j = jds.HITLDatasetTrainableMask(jtm.AdafruitLCD(vals, **MASK_KW), base, **kw)
    jl, jd = j[0]
    tcalls = _record_hitl(monkeypatch, tremote, tio, captured)
    t = tds.HITLDatasetTrainableMask(ttm.AdafruitLCD(vals, device=CPU, **MASK_KW), base, **kw)
    tl, td = t[0]
    assert [c[0] for c in tcalls] == ["save_image", "display", "set_programmable_mask",
                                      "capture", "load_image"]
    assert tcalls == jcalls
    assert np.array_equal(tl, jl) and np.array_equal(td, jd)


# --- one multimask training step -------------------------------------------------------

def test_multimask_training_step_matches_jax(monkeypatch):
    """tests/test_datasets.py:322-338: batches of a multimask dataset with
    random flips and measured backgrounds (per-sample PSFs and
    backgrounds) train a 2-iteration unrolled ADMM: the port's first
    step's loss against the JAX trainer's first epoch of one batch, from
    carried weights."""
    torch.set_num_threads(1)
    hub = _hub(n=4, ambient=True)
    j, t = _pair("HFDataset", "local", split=hub, random_flip=True, seed=5)
    jb, tb = list(j.batches(batch_size=2)), list(t.batches(batch_size=2))
    assert all("psfs" in b and "background" in b for b in tb)
    tm = TRecon(camera_inversion=TADMM(n_iter=2, device=CPU), device=CPU)
    variables = convert.random_variables(tm, 7)
    tm.load_state_dict(convert.state_dict(tm, variables))
    jm = JRecon(camera_inversion=JADMM(n_iter=2))
    monkeypatch.setattr(type(jm), "init", lambda self, *a, **k: jax.tree_util.tree_map(
        jnp.asarray, variables))

    def compiled(step):
        cache = {}

        def call(*args):
            if "fn" not in cache:
                cache["fn"] = jax.jit(step).lower(*args).compile(compiler_options=O0)
            return cache["fn"](*args)
        return call

    monkeypatch.setattr(jt.Trainer, "_rebuild_step", lambda self: setattr(
        self, "_train_step", compiled(self._build_train_step(
            self._skip_pre, self._skip_post, self._frozen))))
    cfg = dict(epochs=1, lr=1e-3)
    jloss = jt.Trainer(jm, j.psf[0], lambda: iter(jb[:1]), jb[:1],
                       jt.TrainerConfig(**cfg)).train_epoch()
    ttr = tt.Trainer(tm, t.psf[0], lambda: iter(tb[:1]), tb[:1], tt.TrainerConfig(**cfg),
                     device=CPU)
    loss, _, _ = ttr.loss_and_grads(tb[0])
    assert np.isfinite(jloss) and abs(float(loss) - jloss) / abs(jloss) <= TOL_LOSS


# --- the hub calls of download_model and simulate_dataset ------------------------------

def test_download_model_calls_the_hub(monkeypatch):
    """Both packages call ``huggingface_hub.snapshot_download`` with the
    registry's repo and the cache folder, and return its path (a stand-in
    module records the call)."""
    calls = []
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        snapshot_download=lambda **kw: calls.append(kw) or f"/cache/{kw['repo_id']}"))
    for zoo in (jzoo, tzoo):
        path = zoo.download_model("diffusercam", "mirflickr", "U20", local_model_dir="models")
        assert path == "/cache/bezzam/diffusercam-mirflickr-unrolled-admm20"
    assert calls == [dict(repo_id="bezzam/diffusercam-mirflickr-unrolled-admm20",
                          cache_dir="models")] * 2
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for zoo in (jzoo, tzoo):
        with pytest.raises(ImportError):
            zoo.download_model("diffusercam", "mirflickr", "U20")


class _HFImages:
    """Stand-in ``datasets.Dataset`` of seeded uint8 images in column
    ``key``, recording ``select``."""

    def __init__(self, key, calls, n=6):
        self.column_names = [key, "label"]
        self.key, self.calls = key, calls
        rng = np.random.RandomState(21)
        shape = (32, 32, 3) if key == "img" else (28, 28)
        self.images = [(rng.rand(*shape) * 255).astype(np.uint8) for _ in range(n)]

    def select(self, indices):
        self.calls.append(("select", list(indices)))
        out = _HFImages(self.key, self.calls)
        out.images = [self.images[i] for i in indices]
        return out

    def __getitem__(self, key):
        assert key == self.key
        return self.images


@pytest.mark.parametrize("name,key", [("mnist", "image"), ("fashion_mnist", "image"),
                                      ("cifar10", "img")])
def test_simulate_dataset_loads_from_the_hub(monkeypatch, name, key):
    """The three hub names call ``datasets.load_dataset(name,
    split="train").select(range(n_files))`` in both packages (a stand-in
    module records it); the images, scaled to [0, 1], go through each
    package's simulator, with the noise drawn as the JAX simulator draws
    it without a key."""
    calls = []

    def load_dataset(*args, **kw):
        calls.append(("load_dataset", args, kw))
        return _HFImages(key, calls)

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=load_dataset))
    monkeypatch.setattr(tnoise, "_normal", lambda x, g: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), tuple(x.shape), jnp.float32))))
    psf = np.random.RandomState(4).rand(1, 32, 48, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    cfg = {"dataset": name, "n_files": 3}
    j = jds.simulate_dataset(cfg, psf=psf)
    t = tds.simulate_dataset(cfg, psf=psf, device=CPU)
    assert calls == [("load_dataset", (name,), {"split": "train"}),
                     ("select", [0, 1, 2])] * 2
    assert len(t) == len(j) == 3
    for idx in range(3):
        for a, b in zip(t[idx], j[idx]):
            assert _rel(a, b) <= TOL
