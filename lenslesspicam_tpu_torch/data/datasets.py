"""Datasets: paired (lensless, lensed) data for training and evaluation,
the offline part (port of lenslesspicam_tpu/data/datasets.py).

Datasets are python iterables yielding numpy dict batches ``{"lensless",
"lensed", [extra fields]}`` in the canonical (B, D, H, W, C) layout, as in
the JAX package:

* ``available_datasets``, the registry of the hosted datasets and their
  geometry;
* ``DualDataset``, the base pipeline: downsample -> 4D promotion ->
  background subtraction -> shot noise at ``input_snr`` -> flips ->
  transforms; ``batches`` and ``extract_roi``;
* ``SimulatedFarFieldDataset``, an image dataset propagated through
  ``data.simulation.FarFieldSimulator``;
* ``MeasuredDataset``, a folder of (lensless, lensed) file pairs, and its
  DiffuserCam forms ``DiffuserCamMirflickr`` and ``DiffuserCamTestDataset``;
* ``DigiCamCelebA``, measured DigiCam images paired with CelebA originals
  projected to the lensed plane;
* ``simulate_dataset``, the config-driven simulated dataset from arrays or
  seeded random images;
* ``SimulatedDatasetTrainableMask``, a simulated dataset whose PSF comes
  from a trainable mask (hardware/trainable_mask.py).

The input-SNR noise is drawn by a ``torch.Generator`` seeded from the
dataset's ``np.random.RandomState(seed)`` stream, one seed per sample, as
the JAX package seeds its ``jax.random`` key (``ops.noise`` holds the
arithmetic after the draw).  Samples stay on the host; the simulators
convolve on ``device`` (None: the CUDA card) and hand the result back.

The datasets that download from the Hugging Face hub or capture on a
Raspberry Pi over SSH (``HFDataset``, ``HFSimulated``, ``get_dataset``,
``HITLDatasetTrainableMask``) are not ported yet (ROADMAP Queue 1 item
19), nor is ``simulate_dataset``'s download of MNIST, Fashion-MNIST or
CIFAR-10.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterator

import numpy as np
import torch

from .._device import as_host
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

    config: {"dataset": <list of arrays> | "random", "n_files", "seed",
    "object_height", "scene2mask", "mask2sensor", "sensor", "snr_db",
    "quantize"}; "random" (the default) makes ``n_files`` seeded 28 x 28
    images.  The simulator convolves on ``device`` (None: the CUDA card).
    """
    from .simulation import FarFieldSimulator

    name = config.get("dataset", "random")
    n_files = config.get("n_files", 100)
    rng = np.random.RandomState(config.get("seed", 0))

    if isinstance(name, str) and name in ("mnist", "fashion_mnist", "cifar10"):
        raise NotImplementedError(
            f"the {name} dataset is downloaded from the Hugging Face hub, which the "
            "port does not reach yet (ROADMAP Queue 1 item 19); pass the images as arrays")
    if isinstance(name, (list, np.ndarray)):
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
