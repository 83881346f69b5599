"""Propagate a dataset through the simulator in batches (the port of
``scripts/sim/jax_dataset.py``, which names itself the analog of the
reference's ``torch_dataset.py`` / ``torch_custom_dataset.py``; the port
takes the reference's name).

Wrap a folder of images, or torchvision's ``mnist`` / ``fashion_mnist`` /
``cifar10`` (downloaded into ``data/`` unless they are there), in a
``SimulatedFarFieldDataset``, iterate its shuffled batches through the
simulator's convolution on the app's device, and report the time a batch.

    python -m lenslesspicam_tpu_torch.scripts.sim.torch_dataset files.dataset=images/
    python -m lenslesspicam_tpu_torch.scripts.sim.torch_dataset files.dataset=mnist

Reads the JAX app's ``_DEFAULTS`` (no YAML); without ``files.psf`` the PSF
is the same seeded random one, ``RandomState(0)``, ``(1, 32, 48, C)``.
Returns the number of batches.  Deliberate differences: none in what it
computes; the time a batch is the port's.
"""

import glob
import os
import time

import numpy as np

from .._common import app

_DEFAULTS = {
    "files": {"dataset": None, "psf": None, "n_files": 16,
              "batch_size": 4, "image_ext": "png"},
    "simulation": {
        "object_height": 0.3,
        "scene2mask": 0.25,
        "mask2sensor": 0.004,
        "sensor": "rpi_hq",
        "snr_db": 40,
        "downsample": 8,
        "grayscale": False,
        "max_val": 255,
    },
    "output_dir": "outputs",
}


class _DirImages:
    """A folder of images as an indexable dataset (the reference's
    torch_custom_dataset)."""

    def __init__(self, root, ext, n_files=None, grayscale=False):
        self.files = sorted(glob.glob(os.path.join(root, f"*.{ext}")))
        if n_files:
            self.files = self.files[: int(n_files)]
        self.grayscale = grayscale

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        from ...data.image import rgb2gray
        from ...data.io import load_image

        img = load_image(self.files[idx]).astype(np.float32) / 255.0
        if self.grayscale and img.ndim == 3:
            img = np.asarray(rgb2gray(img[None]))[0]
        return img


class _Torchvision:
    """The first ``n_files`` images of a torchvision dataset, (C, H, W)."""

    def __init__(self, tv, n_files):
        self.tv, self.n_files = tv, n_files

    def __len__(self):
        return min(len(self.tv), self.n_files) if self.n_files else len(self.tv)

    def __getitem__(self, idx):
        return np.asarray(self.tv[idx][0])


@app(None)
def simulate(config, device):
    from ...data.datasets import SimulatedFarFieldDataset
    from ...data.image import rgb2gray
    from ...data.io import load_psf
    from ...data.simulation import FarFieldSimulator
    from ...utils.config import apply_defaults

    apply_defaults(config, _DEFAULTS)
    files_cfg = config["files"]
    sim_cfg = config["simulation"]
    name = files_cfg["dataset"]
    assert name, "set files.dataset=<dir or mnist|fashion_mnist|cifar10>"
    n_files = files_cfg["n_files"]
    grayscale = bool(sim_cfg["grayscale"])

    dataset_is_CHW = False
    if os.path.isdir(name):
        ds = _DirImages(name, files_cfg["image_ext"], n_files, grayscale)
    else:
        # torchvision (needs the dataset on disk or the network)
        from torchvision import datasets, transforms

        tfs = [transforms.ToTensor()]
        if grayscale:
            tfs.append(transforms.Grayscale())
        cls = {"mnist": datasets.MNIST, "fashion_mnist": datasets.FashionMNIST,
               "cifar10": datasets.CIFAR10}[name]
        ds = _Torchvision(cls(root="data", train=True, download=True,
                              transform=transforms.Compose(tfs)), n_files)
        dataset_is_CHW = True

    # PSF: from a file, or a synthetic random-diffuser PSF
    if files_cfg["psf"]:
        psf = np.asarray(load_psf(files_cfg["psf"], downsample=sim_cfg["downsample"]),
                         np.float32)
        if grayscale and psf.shape[-1] == 3:
            psf = np.asarray(rgb2gray(psf))
    else:
        rng = np.random.RandomState(0)
        c = 1 if grayscale else 3
        psf = rng.rand(1, 32, 48, c).astype(np.float32)
        psf /= np.linalg.norm(psf)

    simulator = FarFieldSimulator(
        psf=psf,
        object_height=sim_cfg["object_height"],
        scene2mask=sim_cfg["scene2mask"],
        mask2sensor=sim_cfg["mask2sensor"],
        sensor=sim_cfg["sensor"],
        snr_db=sim_cfg["snr_db"],
        max_val=sim_cfg["max_val"],
        device=device,
    )
    ds_prop = SimulatedFarFieldDataset(ds, simulator, dataset_is_CHW=dataset_is_CHW)

    n_batches = 0
    t0 = time.time()
    for batch in ds_prop.batches(batch_size=int(files_cfg["batch_size"]), shuffle=True):
        x, target = batch["lensless"], batch["lensed"]
        if n_batches == 0:
            print("Batch shape  :", x.shape)
            print("Target shape :", target.shape)
        n_batches += 1
    dt = (time.time() - t0) / max(n_batches, 1)
    print(f"Time per batch : {dt:.4f} s")
    print(f"Went through {n_batches} batches.")
    return n_batches


if __name__ == "__main__":
    simulate()
