"""Datasets: paired (lensless, lensed) data for training and evaluation
(port of lenslesspicam_tpu/data/datasets.py).

Datasets are python iterables yielding numpy dict batches ``{"lensless",
"lensed", [extra fields]}`` in the canonical (B, D, H, W, C) layout, as in
the JAX package:

* ``available_datasets``, the registry of the hosted datasets and their
  geometry, and ``get_dataset``, which builds one of them as an
  ``HFDataset``;
* ``DualDataset``, the base pipeline: downsample -> 4D promotion ->
  background subtraction -> shot noise at ``input_snr`` -> flips ->
  transforms; ``batches`` and ``extract_roi``;
* ``SimulatedFarFieldDataset``, an image dataset propagated through
  ``data.simulation.FarFieldSimulator``;
* ``MeasuredDataset``, a folder of (lensless, lensed) file pairs, and its
  DiffuserCam forms ``DiffuserCamMirflickr`` and ``DiffuserCamTestDataset``;
* ``HFDataset``, a measured dataset in the Hugging Face hub's format: its
  PSF downloaded or simulated from the stored mask patterns (one PSF per
  ``mask_label`` for the multimask datasets), alignment and crop geometry,
  measured or simulated backgrounds, random flips;
* ``HFSimulated``, the same rows with the lensless image simulated from the
  lensed one by convolution with the dataset's PSF;
* ``DigiCamCelebA``, measured DigiCam images paired with CelebA originals
  projected to the lensed plane;
* ``simulate_dataset``, the config-driven simulated dataset from MNIST,
  Fashion-MNIST or CIFAR-10 (through ``datasets.load_dataset``), arrays or
  seeded random images;
* ``SimulatedDatasetTrainableMask``, a simulated dataset whose PSF comes
  from a trainable mask (hardware/trainable_mask.py), and
  ``HITLDatasetTrainableMask``, whose measurements are captured through the
  mask on the camera over SSH (hardware/remote.py) or simulated.

The noise is drawn by a ``torch.Generator`` seeded from the dataset's
``np.random.RandomState(seed)`` stream, one seed per sample, as the JAX
package seeds its ``jax.random`` key (``ops.noise`` holds the arithmetic
after the draw).  Samples stay numpy on the host; the PSF simulation and
the convolutions run on ``device`` (None: the CUDA card) and hand the
result back.

The hub is reached only where the JAX package reaches it: a string
``split`` needs the ``datasets`` package and a PSF or mask file
``huggingface_hub.hf_hub_download``, both imported at the call.  A loaded
dataset object (rows with ``column_names``, indexable) passes through.
"""

from __future__ import annotations

import glob
import os
import re
import tempfile
from typing import Iterator

import numpy as np
import torch

from .._device import as_host
from .image import INTER_NEAREST as _INTER_NEAREST
from .image import resize as _resize

available_datasets = {
    "diffusercam_mirflickr": {
        "size (GB)": 7.58,
        "huggingface_repo": "bezzam/DiffuserCam-Lensless-Mirflickr-Dataset-NORM",
        "psf": "psf.tiff",
        "single_channel_psf": True,
        "flipud": True,
        "flip_lensed": True,
        "downsample": 2,
        "downsample_lensed": 2,
    },
    "tapecam_mirflickr": {
        "size (GB)": 10.5,
        "huggingface_repo": "bezzam/TapeCam-Mirflickr-25K",
        "psf": "psf.png",
        "display_res": [900, 1200],
        "alignment": {"top_left": [45, 95], "height": 250},
    },
    "digicam_celeba": {
        "size (GB)": 33.9,
        "huggingface_repo": "bezzam/DigiCam-CelebA-26K",
        "psf": "psf_simulated.png",
        "rotate": True,
        "split_seed": 0,
        "downsample": 2,
        "alignment": {"crop": {"vertical": [0, 525], "horizontal": [265, 695]}},
        "simulation": {
            "scene2mask": 0.25,
            "mask2sensor": 0.002,
            "object_height": 0.33,
            "sensor": "rpi_hq",
            "snr_db": None,
            "downsample": None,
            "random_vflip": False,
            "random_hflip": False,
            "quantize": False,
            "vertical_shift": -117,
            "horizontal_shift": -25,
        },
    },
    "digicam_mirflickr": {
        "size (GB)": 11.9,
        "huggingface_repo": "bezzam/DigiCam-Mirflickr-SingleMask-25K",
        "display_res": [900, 1200],
        "rotate": True,
        "alignment": {"top_left": [80, 100], "height": 200},
    },
    "digicam_mirflickr_mini": {
        "size (GB)": 0.472,
        "huggingface_repo": "bezzam/DigiCam-Mirflickr-SingleMask-1K",
        "display_res": [900, 1200],
        "rotate": True,
        "alignment": {"top_left": [80, 100], "height": 200},
    },
    "digicam_mirflickr_multi": {
        "size (GB)": 12,
        "huggingface_repo": "bezzam/DigiCam-Mirflickr-MultiMask-25K",
        "display_res": [900, 1200],
        "rotate": True,
        "alignment": {"top_left": [80, 100], "height": 200},
    },
    "digicam_mirflickr_multi_mini": {
        "size (GB)": 0.477,
        "huggingface_repo": "bezzam/DigiCam-Mirflickr-MultiMask-1K",
        "display_res": [900, 1200],
        "rotate": True,
        "alignment": {"top_left": [80, 100], "height": 200},
    },
    "multilens_mirflickr_ambient": {
        "size (GB)": 16.7,
        "huggingface_repo": "Lensless/MultiLens-Mirflickr-Ambient",
        "psf": "psf.png",
        "display_res": [600, 600],
        "alignment": {"top_left": [118, 220], "height": 123},
    },
    "multilens_mirflickr_ambient_mini": {
        "size (GB)": 0.0677,
        "huggingface_repo": "Lensless/MultiLens-Mirflickr-Ambient-100",
        "psf": "psf.png",
        "display_res": [600, 600],
        "alignment": {"top_left": [118, 220], "height": 123},
    },
    "multilens_mirflickr_mini": {
        "size (GB)": 0.427,
        "huggingface_repo": "Lensless/mirflickr_voronoi_1k",
        "psf": "psf_measured.png",
        "display_res": [900, 1200],
    },
    "mls_mirflickr_1k": {
        "size (GB)": 0.467,
        "huggingface_repo": "Lensless/mirflickr_CA_fine_1k",
        "psf": "psf_measured.png",
        "display_res": [900, 1200],
    },
    "fza_mirflickr_1k": {
        "size (GB)": 0.454,
        "huggingface_repo": "Lensless/Mirflickr_FZA_fine_1k",
        "psf": "psf_measured.png",
        "display_res": [900, 1200],
    },
}


def print_available_datasets():
    print("Available datasets:")
    for name, cfg in available_datasets.items():
        print(f"  {name} ({cfg['size (GB)']} GB) : {cfg['huggingface_repo']}")


def get_dataset(name: str, split: str = "test", **kwargs):
    """The registered dataset ``name`` as an :class:`HFDataset`, its
    registry entry's geometry updated by ``kwargs``; ``split`` is a split
    name (through ``datasets.load_dataset``) or a loaded dataset object."""
    if name not in available_datasets:
        raise ValueError(
            f"Dataset {name} not available. Choose from {list(available_datasets)}")
    cfg = dict(available_datasets[name])
    cfg.pop("size (GB)", None)
    repo = cfg.pop("huggingface_repo")
    cfg.update(kwargs)
    return HFDataset(huggingface_repo=repo, split=split, **cfg)


def natural_sort(paths):
    """Natural-order sort of file paths (``im2`` before ``im10``)."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


class DualDataset:
    """Base paired dataset.

    Subclasses implement ``__len__`` and ``_get_images_pair(idx)``
    returning (lensless, lensed) HWC or DHWC float arrays.
    """

    def __init__(self, downsample=1, background=None, input_snr=None, flip=False,
                 flip_ud=False, flip_lr=False, transform_lensless=None, transform_lensed=None,
                 seed=0, **kwargs):
        self.downsample = downsample
        self.background = background
        self.input_snr = input_snr
        self.flip = flip
        self.flip_ud = flip_ud
        self.flip_lr = flip_lr
        self.transform_lensless = transform_lensless
        self.transform_lensed = transform_lensed
        self._rng = np.random.RandomState(seed)
        self.psf = None
        self.alignment = None
        self.crop = None
        self.multimask = False
        self.random_flip = False
        self.measured_bg = False

    def __len__(self):
        raise NotImplementedError

    def _get_images_pair(self, idx):
        raise NotImplementedError

    def __getitem__(self, idx):
        lensless, lensed = self._get_images_pair(idx)
        lensless = np.asarray(lensless, np.float32)
        lensed = np.asarray(lensed, np.float32)

        if self.downsample != 1:
            lensless = _resize(lensless[None] if lensless.ndim == 3 else lensless,
                               factor=1 / self.downsample)
            lensed = _resize(lensed[None] if lensed.ndim == 3 else lensed,
                             factor=1 / self.downsample)
        # promote to (D, H, W, C)
        if lensless.ndim == 3:
            lensless = lensless[None]
        if lensed.ndim == 3:
            lensed = lensed[None]

        if self.background is not None:
            lensless = np.clip(lensless - self.background, 0, None)

        if self.input_snr is not None:
            from ..ops.noise import add_shot_noise

            generator = torch.Generator().manual_seed(int(self._rng.randint(0, 2**31)))
            lensless = add_shot_noise(torch.from_numpy(lensless), self.input_snr,
                                      generator).numpy()

        if self.flip:
            lensless = lensless[:, ::-1, ::-1, :].copy()
            lensed = lensed[:, ::-1, ::-1, :].copy()
        if self.flip_ud:
            lensless = lensless[:, ::-1, :, :].copy()
            lensed = lensed[:, ::-1, :, :].copy()
        if self.flip_lr:
            lensless = lensless[:, :, ::-1, :].copy()
            lensed = lensed[:, :, ::-1, :].copy()

        if self.transform_lensless:
            lensless = self.transform_lensless(lensless)
        if self.transform_lensed:
            lensed = self.transform_lensed(lensed)
        return lensless, lensed

    def batches(self, batch_size=4, shuffle=False, seed=0) -> Iterator[dict]:
        """Yield numpy dict batches for a trainer or ``eval.benchmark``."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            items = [self[i] for i in idxs]
            batch = {"lensless": np.stack([it[0] for it in items]),
                     "lensed": np.stack([it[1] for it in items])}
            extras = [self.extra_fields(i) for i in idxs]
            for key in (extras[0] or {}):
                batch[key] = np.stack([e[key] for e in extras])
            yield batch

    def extra_fields(self, idx) -> dict:
        """Per-sample extra arrays (psfs, background, ...)."""
        return {}

    def extract_roi(self, reconstruction, lensed=None, axis=(-3, -2), flip_lr=None,
                    flip_ud=None):
        """The alignment or crop region of ``reconstruction`` (..., H, W,
        C; a tensor comes back as a float32 host array), with the
        per-sample flips ``flip_lr`` / ``flip_ud`` undone around the
        crop."""
        recon = (as_host(reconstruction) if isinstance(reconstruction, torch.Tensor)
                 else np.asarray(reconstruction))

        def flip_axis(arr, mask_flags, ax):
            arr = arr.copy()
            flags = np.asarray(mask_flags).reshape(-1).astype(bool)
            arr[flags] = np.flip(arr[flags], axis=ax)
            return arr

        if flip_lr is not None:
            recon = flip_axis(recon, flip_lr, axis[1])
            if lensed is not None:
                lensed = flip_axis(np.asarray(lensed), flip_lr, axis[1])
        if flip_ud is not None:
            recon = flip_axis(recon, flip_ud, axis[0])
            if lensed is not None:
                lensed = flip_axis(np.asarray(lensed), flip_ud, axis[0])

        if self.alignment is not None:
            top_left = self.alignment["top_left"]
            height = self.alignment["height"]
            width = self.alignment["width"]
            index = [slice(None)] * recon.ndim
            index[axis[0]] = slice(top_left[0], top_left[0] + height)
            index[axis[1]] = slice(top_left[1], top_left[1] + width)
            recon = recon[tuple(index)]
        elif self.crop is not None:
            index = [slice(None)] * recon.ndim
            index[axis[0]] = slice(*self.crop["vertical"])
            index[axis[1]] = slice(*self.crop["horizontal"])
            recon = recon[tuple(index)]
            if lensed is not None:
                lensed = lensed[tuple(index)]

        if flip_lr is not None:
            recon = flip_axis(recon, flip_lr, axis[1])
        if flip_ud is not None:
            recon = flip_axis(recon, flip_ud, axis[0])

        if self.alignment is None and lensed is not None:
            return recon, lensed
        return recon


class SimulatedFarFieldDataset(DualDataset):
    """An image dataset propagated through a ``FarFieldSimulator`` that
    has a PSF."""

    def __init__(self, dataset, simulator, dataset_is_CHW=False, **kwargs):
        super().__init__(**kwargs)
        self.dataset = dataset
        self.sim = simulator
        self.dataset_is_CHW = dataset_is_CHW
        if simulator.conv is None:
            raise ValueError("the simulator must have a PSF")
        self.psf = as_host(simulator.get_psf())

    def __len__(self):
        return len(self.dataset)

    def _get_images_pair(self, idx):
        obj = np.asarray(self.dataset[idx], np.float32)
        if self.dataset_is_CHW:
            obj = np.moveaxis(obj, 0, -1)
        if obj.ndim == 2:
            obj = obj[:, :, None]
        lensless, lensed = self.sim.propagate_image(obj, return_object_plane=True)
        return as_host(lensless), np.asarray(lensed)


class MeasuredDataset(DualDataset):
    """Folder-of-files dataset: matching (lensless, lensed) pairs."""

    def __init__(self, root_dir, lensless_dir="diffuser", lensed_dir="lensed", image_ext="npy",
                 psf_path=None, **kwargs):
        super().__init__(**kwargs)
        self.lensless_files = natural_sort(
            glob.glob(os.path.join(root_dir, lensless_dir, f"*.{image_ext}")))
        self.lensed_files = natural_sort(
            glob.glob(os.path.join(root_dir, lensed_dir, f"*.{image_ext}")))
        if len(self.lensless_files) != len(self.lensed_files):
            raise ValueError("lensless and lensed file counts differ")
        for a, b in zip(self.lensless_files, self.lensed_files):
            if os.path.basename(a) != os.path.basename(b):
                raise ValueError(f"file name mismatch: {a} against {b}")
        if psf_path is not None:
            from .io import load_psf

            self.psf = load_psf(psf_path)

    def __len__(self):
        return len(self.lensless_files)

    def _load(self, fp):
        if fp.endswith(".npy"):
            return np.load(fp)
        from .io import load_image

        return load_image(fp, return_float=True)

    def _get_images_pair(self, idx):
        return self._load(self.lensless_files[idx]), self._load(self.lensed_files[idx])


def _hf_split(split, repo, n_files, cache_dir, cls_name):
    """The rows of ``split``: a loaded dataset object as it is, a split
    name through ``datasets.load_dataset`` (imported here)."""
    if not isinstance(split, str):
        return split
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise ImportError(f"{cls_name} requires the `datasets` package") from e
    if n_files is not None:
        split = f"{split}[0:{n_files}]"
    return load_dataset(repo, split=split, cache_dir=cache_dir)


def _hf_file(repo, filename):
    """The local path of ``filename`` of the hub's dataset ``repo``
    (``huggingface_hub.hf_hub_download``, imported here)."""
    from huggingface_hub import hf_hub_download

    return hf_hub_download(repo_id=repo, filename=filename, repo_type="dataset")


class HFDataset(DualDataset):
    """A measured dataset in the Hugging Face hub's format (the reference's
    dataset.py:1423-2065).

    ``split`` is a split name (needs the ``datasets`` package and the hub
    or its cache) or a loaded dataset object.  Features:

    * PSF download (``psf=``) with ``flip=rotate``, ``shape`` matched to
      the downsampled lensless sample and ``bg_pix=(0, 15)``, or the PSF
      simulated from stored mask patterns through ``AdafruitLCD`` on
      ``device`` (None: the CUDA card): single-mask (``mask_pattern.npy``)
      or one PSF per ``mask_label`` of a multimask dataset;
    * PSF noise at ``psf_snr`` dB, drawn from ``RandomState(seed)``;
    * alignment / crop geometry scaled by ``downsample``, and a
      ``FarFieldSimulator`` on ``device`` built from
      ``alignment["simulation"]``;
    * measured backgrounds (the ``ambient`` column) and simulated
      backgrounds added at an SNR drawn from ``bg_snr_range``;
    * random flips returning the flip flags and the flipped PSF, drawn per
      (seed, epoch, idx) so that ``extra_fields`` sees the draw
      ``__getitem__`` made.

    The PSFs and samples are numpy arrays on the host.
    """

    def __init__(self, huggingface_repo, split="test", n_files=None, psf=None,
                 display_res=None, alignment=None, rotate=False, flipud=False,
                 flip_lensed=False, downsample=1, downsample_lensed=1,
                 single_channel_psf=False, psf_snr=None, sensor="rpi_hq", slm="adafruit",
                 return_mask_label=False, save_psf=False, simulation=None,
                 simulate_lensless=False, force_rgb=False, cache_dir=None, random_flip=False,
                 bg_snr_range=None, bg_fp=None, device=None, **kwargs):
        super().__init__(**kwargs)
        self.ds = _hf_split(split, huggingface_repo, n_files, cache_dir, "HFDataset")
        self.repo = huggingface_repo
        self.device = device
        self.rotate = rotate
        self.flipud = flipud
        self.flip_lensed = flip_lensed
        self.downsample_lensless = downsample
        self.downsample_lensed = downsample_lensed
        self.display_res = display_res
        self.simulation_config = simulation or {}
        self.sensor = sensor
        self.slm = slm
        self.force_rgb = force_rgb
        self.return_mask_label = return_mask_label
        self.random_flip = random_flip
        self._flip_seed = kwargs.get("seed", 0)
        self._epoch = 0

        # the first sample's grid
        lensless0 = np.asarray(self.ds[0]["lensless"])
        if self.downsample_lensless != 1:
            lensless0 = _resize(lensless0[None].astype(np.float32),
                                factor=1 / self.downsample_lensless)[0]
        self._lensless_shape = lensless0.shape[:2]

        # alignment geometry, scaled by downsample
        if alignment is not None:
            top_left = alignment.get("top_left", alignment.get("topright"))
            if top_left is not None:
                self.alignment = dict(alignment)
                self.alignment["top_left"] = (int(top_left[0] / downsample),
                                              int(top_left[1] / downsample))
                self.alignment["height"] = int(alignment["height"] / downsample)
                if "width" in alignment:
                    self.alignment["width"] = int(alignment["width"] / downsample)
                else:
                    assert display_res is not None
                    self.alignment["width"] = int(
                        self.alignment["height"] * display_res[1] / display_res[0])
            elif alignment.get("crop") is not None:
                self.crop = {k: [int(v[0] / downsample), int(v[1] / downsample)]
                             for k, v in alignment["crop"].items()}

        # PSF: downloaded from the repo, or simulated from the mask pattern(s)
        self.multimask = False
        if psf is not None:
            from .io import load_psf

            # flip=rotate, the (downsampled) lensless sample's shape,
            # bg_pix=(0, 15) (dataset.py:1580-1589)
            self.psf = load_psf(_hf_file(huggingface_repo, psf),
                                shape=tuple(self._lensless_shape) + (3,), return_float=True,
                                flip=self.rotate, flip_ud=flipud, bg_pix=(0, 15),
                                force_rgb=force_rgb, single_psf=single_channel_psf)
            if single_channel_psf:
                self.psf = np.repeat(self.psf, 3, axis=-1)
            if psf_snr is not None:
                # Gaussian noise at the target SNR (dataset.py:1596-1607)
                rng = np.random.RandomState(self._flip_seed)
                noise = rng.randn(*self.psf.shape).astype(np.float32)
                noise *= np.sqrt(self.psf.var() / noise.var()) / 10 ** (psf_snr / 20)
                self.psf = self.psf + noise
        elif "mask_label" in self.ds.column_names:
            # multimask: one PSF per mask label (dataset.py:1613-1634)
            self.multimask = True
            labels = sorted({self.ds[i]["mask_label"] for i in range(len(self.ds))})
            self.mask_labels = labels
            self.psf = {lab: self.simulate_psf(self.get_mask_vals(lab)) for lab in labels}
        else:
            # one mask pattern (dataset.py:1640-1650)
            self.psf = self.simulate_psf(np.load(_hf_file(huggingface_repo,
                                                          "mask_pattern.npy")))
        if save_psf and not isinstance(self.psf, dict):
            from .io import save_image

            save_image(np.asarray(self.psf).squeeze(), f"{split}_psf.png")

        # the simulator of alignment["simulation"] (dataset.py:1654-1675)
        self.simulate_lensless = simulate_lensless
        self.simulator = None
        if alignment is not None and "simulation" in alignment:
            from .simulation import FarFieldSimulator

            sim_cfg = dict(alignment["simulation"])
            ref_psf = (next(iter(self.psf.values())) if isinstance(self.psf, dict)
                       else self.psf)
            sim_cfg["output_dim"] = tuple(np.asarray(ref_psf).shape[-3:-1])
            for key in ("vertical_shift", "horizontal_shift"):
                if sim_cfg.get(key) is not None:
                    sim_cfg[key] = int(sim_cfg[key] / downsample)
            sim_cfg.pop("random_vflip", None)
            sim_cfg.pop("random_hflip", None)
            self.simulator = FarFieldSimulator(psf=ref_psf if simulate_lensless else None,
                                               device=device, **sim_cfg)

        # a background added at a random SNR (dataset.py:1677-1694)
        self.bg_sim = None
        self.bg_snr_range = bg_snr_range
        if bg_fp is not None:
            assert bg_snr_range is not None, "bg_snr_range must accompany a background file"
            from .io import load_image

            bg = load_image(bg_fp, shape=tuple(self._lensless_shape) + (3,),
                            return_float=True, flip=rotate)
            self.bg_sim = np.asarray(bg, np.float32)
            self.background_var = float(self.bg_sim.var())

        self.measured_bg = "ambient" in self.ds.column_names

    def __len__(self):
        return len(self.ds)

    def set_epoch(self, epoch: int):
        """Re-seed the per-index augmentation draws (a new epoch)."""
        self._epoch = int(epoch)

    def get_mask_vals(self, label):
        """The mask pattern of ``label`` (``masks/mask_{label}.npy`` of the
        repo)."""
        return np.load(_hf_file(self.repo, f"masks/mask_{label}.npy"))

    def simulate_psf(self, mask_vals):
        """The PSF of the mask pattern ``mask_vals`` through ``AdafruitLCD``
        on ``device``, as a (1, H, W, 3) host array on the lensless grid."""
        from ..hardware.sensor import VirtualSensor
        from ..hardware.trainable_mask import AdafruitLCD

        sensor_res = VirtualSensor.from_name(self.sensor).resolution
        downsample_fact = float(min(np.asarray(sensor_res) / np.asarray(self._lensless_shape)))
        mask = AdafruitLCD(
            initial_vals=np.asarray(mask_vals, np.float32),
            sensor=self.sensor,
            downsample=downsample_fact,
            flipud=self.rotate or self.flipud,
            scene2mask=self.simulation_config.get("scene2mask", 0.55) or 0.55,
            mask2sensor=self.simulation_config.get("mask2sensor", 0.004) or 0.004,
            deadspace=self.simulation_config.get("deadspace", True),
            device=self.device,
        )
        with torch.no_grad():
            psf = as_host(mask.get_psf(mask.params))
        # the real datasets divide the sensor grid evenly, so this is a
        # no-op; at other geometries the PSF is resized to the measurement
        # grid (the reference asserts equality, dataset.py:1390-1392)
        if tuple(psf.shape[-3:-1]) != tuple(self._lensless_shape):
            psf = _resize(psf, shape=tuple(self._lensless_shape) + (psf.shape[-1],))
        return psf

    def _augment_draws(self, idx):
        """(flip_lr, flip_ud, bg_target_snr) of this (seed, epoch, idx),
        shared by ``__getitem__`` and ``extra_fields`` so that both see
        the same augmentation."""
        rng = np.random.RandomState([self._flip_seed, self._epoch, int(idx)])
        flip_lr = bool(rng.rand() > 0.5) if self.random_flip else False
        flip_ud = bool(rng.rand() > 0.5) if self.random_flip else False
        target_snr = None
        if self.bg_sim is not None:
            target_snr = float(rng.uniform(self.bg_snr_range[0], self.bg_snr_range[1]))
        return flip_lr, flip_ud, target_snr

    def _to_array(self, pil_or_arr):
        arr = np.asarray(pil_or_arr)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        elif arr.dtype in (np.uint16, np.int32, np.int64):
            arr = arr.astype(np.float32) / 65535.0
        else:
            arr = arr.astype(np.float32)
        if self.force_rgb and arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=2)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    def _scaled_background(self, lensless, flip_lr, flip_ud, target_snr):
        """The simulated background scaled to ``target_snr`` dB against
        ``lensless`` and flipped with it (dataset.py:1894-1907)."""
        alpha = np.sqrt(float(lensless.var()) / self.background_var / (10 ** (target_snr / 10)))
        scaled_bg = alpha * self.bg_sim
        if flip_lr:
            scaled_bg = scaled_bg[:, ::-1]
        if flip_ud:
            scaled_bg = scaled_bg[::-1]
        return scaled_bg

    def _get_images_pair(self, idx):
        item = self.ds[int(idx)]
        lensless = self._to_array(item["lensless"])
        lensed = self._to_array(item["lensed"])
        if self.downsample_lensless != 1:
            lensless = _resize(lensless[None], factor=1 / self.downsample_lensless,
                               interpolation=_INTER_NEAREST)[0]

        if self.simulator is not None:
            # the original image projected to the lensed (object) plane;
            # with simulate_lensless the measurement simulated too
            if self.simulate_lensless:
                lensless_s, lensed = self.simulator.propagate_image(lensed,
                                                                    return_object_plane=True)
                lensless = as_host(lensless_s)
            else:
                lensed = np.asarray(self.simulator.propagate_image(
                    lensed, return_object_plane=True)[1])
        elif self.alignment is not None:
            lensed = _resize(lensed[None], shape=(self.alignment["height"],
                                                  self.alignment["width"], 3),
                             interpolation=_INTER_NEAREST)[0]
        elif self.display_res is not None:
            lensed = _resize(lensed[None], shape=tuple(self.display_res) + (3,),
                             interpolation=_INTER_NEAREST)[0]
        elif self.downsample_lensed != 1:
            lensed = _resize(lensed[None], factor=1 / self.downsample_lensed,
                             interpolation=_INTER_NEAREST)[0]

        if not self.simulate_lensless:
            if self.rotate:
                lensless = np.rot90(lensless, 2).copy()
            if self.flipud:
                lensless = lensless[::-1].copy()
        if self.flip_lensed:
            if self.rotate:
                lensed = np.rot90(lensed, 2).copy()
            if self.flipud:
                lensed = lensed[::-1].copy()

        flip_lr, flip_ud, target_snr = self._augment_draws(idx)
        if flip_lr:
            lensless = lensless[:, ::-1].copy()
            lensed = lensed[:, ::-1].copy()
        if flip_ud:
            lensless = lensless[::-1].copy()
            lensed = lensed[::-1].copy()

        if self.bg_sim is not None:
            lensless = lensless + self._scaled_background(lensless, flip_lr, flip_ud,
                                                          target_snr)
        return lensless, lensed

    def extra_fields(self, idx):
        out = {}
        flip_lr, flip_ud, target_snr = self._augment_draws(idx)

        psf = None
        if self.multimask:
            label = self.ds[int(idx)]["mask_label"]
            if self.return_mask_label:
                out["mask_label"] = np.asarray(label)
            else:
                psf = np.asarray(self.psf[label])
        elif self.random_flip:
            psf = np.asarray(self.psf)
        if psf is not None:
            if flip_lr:
                psf = psf[:, :, ::-1].copy()
            if flip_ud:
                psf = psf[:, ::-1].copy()
            out["psfs"] = psf
        if self.random_flip:
            out["flip_lr"] = np.asarray(flip_lr)
            out["flip_ud"] = np.asarray(flip_ud)

        if self.bg_sim is not None:
            # the scaled background that __getitem__ added, its scale from
            # the measurement before the background
            out["background"] = self._scaled_background(self._raw_lensless(idx), flip_lr,
                                                        flip_ud, target_snr)[None]
        elif self.measured_bg:
            bg = self._to_array(self.ds[int(idx)]["ambient"])
            if self.downsample_lensless != 1:
                bg = _resize(bg[None], factor=1 / self.downsample_lensless,
                             interpolation=_INTER_NEAREST)[0]
            out["background"] = bg[None]
        return out

    def _raw_lensless(self, idx):
        """The measurement before the background is added."""
        lensless = self._to_array(self.ds[int(idx)]["lensless"])
        if self.downsample_lensless != 1:
            lensless = _resize(lensless[None], factor=1 / self.downsample_lensless,
                               interpolation=_INTER_NEAREST)[0]
        if not self.simulate_lensless:
            if self.rotate:
                lensless = np.rot90(lensless, 2).copy()
            if self.flipud:
                lensless = lensless[::-1].copy()
        return lensless


class HFSimulated(DualDataset):
    """A hub-format dataset whose lensless image is simulated from the
    lensed one by convolution with the (downloaded or mask-simulated) PSF
    (the reference's dataset.py:1180-1420), to compare simulated
    measurements with real ones.

    A single downloaded PSF or one simulated PSF per ``mask_label``; the
    alignment paste (the lensed image resized to the alignment crop and
    pasted onto a lensless-shaped canvas); one ``FFTConvolver`` per PSF on
    ``device`` (None: the CUDA card), cached; shot noise at ``snr_db`` from
    a generator seeded from the dataset's ``RandomState`` stream; the
    result divided by its maximum where that exceeds 1.
    """

    def __init__(self, huggingface_repo, split, n_files=None, psf=None, downsample=1,
                 cache_dir=None, single_channel_psf=False, flipud=False, display_res=None,
                 alignment=None, sensor="rpi_hq", slm="adafruit", simulation_config=None,
                 snr_db=40, device=None, **kwargs):
        super().__init__(**kwargs)
        self.ds = _hf_split(split, huggingface_repo, n_files, cache_dir, "HFSimulated")
        self.repo = huggingface_repo
        self.device = device
        self.flipud = flipud
        self.rotate = False
        self.snr_db = snr_db
        self.sensor = sensor
        self.slm = slm
        self.simulation_config = simulation_config or {}

        lensless0 = np.asarray(self.ds[0]["lensless"])
        self.lensless_shape = tuple(np.array(lensless0.shape[:2]) // downsample)

        # PSF: downloaded, or simulated per mask label (dataset.py:1219-1334)
        self.multimask = False
        if psf is not None:
            from .io import load_psf

            self.psf = load_psf(_hf_file(huggingface_repo, psf),
                                shape=tuple(self.lensless_shape) + (3,), return_float=True,
                                flip_ud=flipud, bg_pix=(0, 15), single_psf=single_channel_psf)
            if single_channel_psf:
                self.psf = np.repeat(self.psf, 3, axis=-1)
        elif "mask_label" in self.ds.column_names:
            self.multimask = True
            labels = sorted({self.ds[i]["mask_label"] for i in range(len(self.ds))})
            self.mask_labels = labels
            self.psf = {lab: self.simulate_psf(self.get_mask_vals(lab)) for lab in labels}
        else:
            raise ValueError("provide a psf filename or a multimask dataset")

        self._convolvers = {}

        # alignment geometry (dataset.py:1344-1360)
        self.display_res = display_res
        self.cropped_lensed_shape = None
        if alignment is not None:
            self.alignment = dict(alignment)
            self.alignment["top_left"] = (int(alignment["top_left"][0] / downsample),
                                          int(alignment["top_left"][1] / downsample))
            self.alignment["height"] = int(alignment["height"] / downsample)
            self.alignment["width"] = int(
                self.alignment["height"] * display_res[1] / display_res[0])
            self.cropped_lensed_shape = (self.alignment["height"], self.alignment["width"], 3)

    def __len__(self):
        return len(self.ds)

    get_mask_vals = HFDataset.get_mask_vals
    simulate_psf = HFDataset.simulate_psf

    @property
    def _lensless_shape(self):  # read by simulate_psf
        return self.lensless_shape

    def _convolver_for(self, psf):
        from ..ops.fft_conv import FFTConvolver

        key = id(psf)
        if key not in self._convolvers:
            self._convolvers[key] = FFTConvolver.from_psf(np.asarray(psf), pad=True,
                                                          norm="backward", device=self.device)
        return self._convolvers[key]

    def _get_images_pair(self, idx):
        item = self.ds[int(idx)]
        lensed = np.asarray(item["lensed"])
        if self.flipud:
            lensed = np.flipud(lensed)
        if lensed.dtype == np.uint8:
            lensed = lensed.astype(np.float32) / 255.0
        else:
            lensed = lensed.astype(np.float32) / 65535.0
        if lensed.ndim == 2:
            lensed = lensed[:, :, None]

        cropped = None
        if self.cropped_lensed_shape is not None:
            cropped = _resize(lensed[None], shape=self.cropped_lensed_shape,
                              interpolation=_INTER_NEAREST)[0]
            canvas = np.zeros(tuple(self.lensless_shape) + (3,), np.float32)
            ty, tx = self.alignment["top_left"]
            canvas[ty:ty + self.alignment["height"], tx:tx + self.alignment["width"]] = cropped
            lensed = canvas
        elif tuple(lensed.shape[:2]) != tuple(self.lensless_shape):
            lensed = _resize(lensed[None], shape=tuple(self.lensless_shape) + (3,),
                             interpolation=_INTER_NEAREST)[0]

        psf = self.psf[item["mask_label"]] if self.multimask else self.psf
        conv = self._convolver_for(psf)
        lensless = conv.convolve(torch.from_numpy(np.ascontiguousarray(lensed[None])).to(
            conv.H.device))[0]

        if self.snr_db is not None:
            from ..ops.noise import add_shot_noise

            generator = torch.Generator(device=lensless.device).manual_seed(
                int(self._rng.randint(0, 2**31)))
            lensless = add_shot_noise(lensless, self.snr_db, generator)
        lensless = as_host(lensless)
        if lensless.max() > 1:
            lensless = lensless / lensless.max()

        return lensless, (cropped if cropped is not None else lensed)

    def extra_fields(self, idx):
        if self.multimask:
            return {"psfs": np.asarray(self.psf[self.ds[int(idx)]["mask_label"]])}
        return {}


class DigiCamCelebA(DualDataset):
    """Measured DigiCam lensless images paired with CelebA originals
    projected to the lensed plane by simulation.

    ``measured_dir`` holds png measurements named like the CelebA jpgs;
    defaults (flip, shifts, crop, downsample scaling) follow the
    ``celeba_adafruit_random_2mm_20230720_10K`` recipe.
    """

    def __init__(self, celeba_root, measured_dir, psf_path, downsample=1, flip=True,
                 vertical_shift=None, horizontal_shift=None, crop=None,
                 simulation_config=None, device=None, **kwargs):
        super().__init__(**kwargs)
        from .io import load_psf

        if vertical_shift is None:
            vertical_shift = -85
            horizontal_shift = -5
        if crop is None:
            crop = {"vertical": [30, 560], "horizontal": [285, 720]}
        self.crop = {k: [int(v[0] // downsample), int(v[1] // downsample)]
                     for k, v in crop.items()}
        self.vertical_shift = int(vertical_shift // downsample)
        self.horizontal_shift = int(horizontal_shift // downsample)
        self.flip_measurement = flip
        self.pre_downsample = downsample

        # the PSF is stored at 4x the measurement's resolution
        self.psf, self.background = load_psf(psf_path, downsample=downsample * 4,
                                              return_float=True, return_bg=True, flip=flip,
                                              bg_pix=(0, 15))

        from .simulation import FarFieldSimulator

        sim_cfg = dict(simulation_config or {})
        sim_cfg["output_dim"] = tuple(np.asarray(self.psf).shape[-3:-1])
        sim_cfg.setdefault("sensor", "rpi_hq")
        self.sim = FarFieldSimulator(psf=None, device=device, **sim_cfg)

        self.measured_dir = measured_dir
        self.original_dir = os.path.join(celeba_root, "celeba", "img_align_celeba")
        self.files = natural_sort(
            [os.path.basename(f) for f in glob.glob(os.path.join(measured_dir, "*.png"))])

    def __len__(self):
        return len(self.files)

    def _get_images_pair(self, idx):
        from .io import load_image

        lensless_fp = os.path.join(self.measured_dir, self.files[idx])
        original_fp = os.path.join(self.original_dir, self.files[idx][:-3] + "jpg")
        lensless = load_image(lensless_fp, downsample=self.pre_downsample,
                              flip=self.flip_measurement, return_float=True)
        original = load_image(original_fp, return_float=True)

        # the original projected to the lensed plane, then the alignment rolls
        lensed = np.asarray(self.sim.propagate_image(original, return_object_plane=True)[1])
        if self.vertical_shift:
            lensed = np.roll(lensed, self.vertical_shift, axis=-3)
        if self.horizontal_shift:
            lensed = np.roll(lensed, self.horizontal_shift, axis=-2)
        return lensless, lensed


class SimulatedDatasetTrainableMask(SimulatedFarFieldDataset):
    """Simulated dataset whose PSF is regenerated from a trainable mask
    (dataset.py:980-1032): ``set_psf`` refreshes the simulator with the
    mask's current PSF (computed without gradients; None: from its
    current parameters)."""

    def __init__(self, mask, dataset, simulator, **kwargs):
        self._mask = mask
        if simulator.conv is None:
            with torch.no_grad():
                simulator.set_psf(mask.get_psf(mask.params))
        if simulator.quantize:
            raise ValueError("the simulator must not quantize (differentiability; "
                             "dataset.py:1014-1016)")
        super().__init__(dataset, simulator, **kwargs)

    def set_psf(self, psf=None):
        if psf is None:
            with torch.no_grad():
                psf = self._mask.get_psf(self._mask.params)
        self.sim.set_psf(psf)
        self.psf = as_host(self.sim.get_psf())


def simulate_dataset(config: dict, psf=None, device=None):
    """Config-driven simulated dataset.

    config: {"dataset": "mnist" | "fashion_mnist" | "cifar10" | <list of
    arrays> | "random", "n_files", "seed", "object_height", "scene2mask",
    "mask2sensor", "sensor", "snr_db", "quantize"}; the three names load
    the first ``n_files`` training images with ``datasets.load_dataset``
    (imported here; the hub or its cache), "random" (the default) makes
    ``n_files`` seeded 28 x 28 images.  The simulator convolves on
    ``device`` (None: the CUDA card).
    """
    from .simulation import FarFieldSimulator

    name = config.get("dataset", "random")
    n_files = config.get("n_files", 100)
    rng = np.random.RandomState(config.get("seed", 0))

    if isinstance(name, str) and name in ("mnist", "fashion_mnist", "cifar10"):
        from datasets import load_dataset

        hf = load_dataset(name, split="train").select(range(n_files))
        key = "image" if "image" in hf.column_names else "img"
        images = [np.asarray(im, np.float32) / 255.0 for im in hf[key]]
    elif isinstance(name, (list, np.ndarray)):
        images = [np.asarray(im, np.float32) for im in name]
    else:
        images = [rng.rand(28, 28).astype(np.float32) for _ in range(n_files)]

    sim = FarFieldSimulator(
        object_height=config.get("object_height", 0.3),
        scene2mask=config.get("scene2mask", 0.55),
        mask2sensor=config.get("mask2sensor", 0.004),
        sensor=config.get("sensor", "rpi_hq"),
        psf=psf,
        snr_db=config.get("snr_db", 40),
        quantize=config.get("quantize", False),
        device=device,
    )
    return SimulatedFarFieldDataset(images, sim)


class DiffuserCamMirflickr(MeasuredDataset):
    """Measured DiffuserCam-MirFlickr dataset from local folders: BGR ->
    RGB swap, PSF at 4x downsample, allowed indices 2..25000."""

    def __init__(self, dataset_dir, psf_path, downsample=2, **kwargs):
        super().__init__(dataset_dir, lensless_dir="diffuser_images",
                         lensed_dir="ground_truth_lensed", image_ext="npy",
                         downsample=downsample, **kwargs)
        from .io import load_psf

        self.psf = load_psf(psf_path, downsample=4)
        self.allowed_idx = np.arange(2, 25001)

    def _get_images_pair(self, idx):
        lensless, lensed = super()._get_images_pair(idx)
        return lensless[..., ::-1], lensed[..., ::-1]  # BGR -> RGB


class DiffuserCamTestDataset(MeasuredDataset):
    """The standard 200-file DiffuserCam benchmark subset, from a local
    folder (``diffuser/``, ``lensed/`` and ``psf.tiff``)."""

    def __init__(self, data_dir, downsample=2, **kwargs):
        psf_path = os.path.join(data_dir, "psf.tiff")
        super().__init__(data_dir, lensless_dir="diffuser", lensed_dir="lensed",
                         image_ext="npy", psf_path=psf_path if os.path.isfile(psf_path) else None,
                         downsample=downsample, **kwargs)


class HITLDatasetTrainableMask(DualDataset):
    """Hardware-in-the-loop dataset (the reference's dataset.py:1034-1121):
    each item programs the mask's current values on the camera's LCD,
    displays the lensed image and captures a measurement over SSH
    (hardware/remote.py, gated on paramiko).  With ``simulate=True`` the
    measurement is instead the lensed image, pasted onto the PSF's grid,
    convolved with the mask's current PSF on ``device`` (None: the CUDA
    card).  Local scratch files go to ``tempfile.gettempdir()``."""

    def __init__(self, mask, base_dataset, rpi_username=None, rpi_hostname=None,
                 celeba_root=None, simulate=False, display_kwargs=None, capture_kwargs=None,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.mask = mask
        self.base = base_dataset
        self.rpi_username = rpi_username
        self.rpi_hostname = rpi_hostname
        self.simulate = simulate
        self.display_kwargs = display_kwargs or {}
        self.capture_kwargs = capture_kwargs or {}
        self.device = device

    def __len__(self):
        return len(self.base)

    def _get_images_pair(self, idx):
        lensed = np.asarray(self.base[idx], np.float32)
        if lensed.ndim == 2:
            lensed = lensed[:, :, None]

        if self.simulate:
            from ..ops.fft_conv import FFTConvolver

            with torch.no_grad():
                psf = self.mask.get_psf(self.mask.params)
            conv = FFTConvolver.from_psf(psf, pad=True, norm="backward", device=self.device)
            canvas = np.zeros(tuple(psf.shape[1:]), np.float32)
            h = min(lensed.shape[0], canvas.shape[0])
            w = min(lensed.shape[1], canvas.shape[1])
            canvas[:h, :w, :] = lensed[:h, :w, :canvas.shape[-1]]
            lensless = conv.convolve(torch.from_numpy(canvas[None]).to(conv.H.device))[0]
            return as_host(lensless), canvas

        from ..hardware import remote
        from .io import load_image, save_image

        tmp = tempfile.gettempdir()
        tmp_fp = os.path.join(tmp, "hitl_display.png")
        save_image(lensed, tmp_fp)
        remote.display(tmp_fp, self.rpi_username, self.rpi_hostname, **self.display_kwargs)
        remote.set_programmable_mask(as_host(self.mask.params.get("vals")),
                                     rpi_username=self.rpi_username,
                                     rpi_hostname=self.rpi_hostname)
        fp, _ = remote.capture(self.rpi_username, self.rpi_hostname, output_path=tmp,
                               **self.capture_kwargs)
        lensless = load_image(fp, return_float=True)
        return lensless, lensed
