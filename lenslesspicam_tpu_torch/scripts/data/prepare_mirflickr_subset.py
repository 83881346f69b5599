"""Prepare a subset of the DiffuserCam-MirFlickr dataset (the port of
``scripts/data/prepare_mirflickr_subset.py``).

Shuffles the diffuser measurements with ``np.random.seed(seed)`` (the
global generator, as the JAX app draws them, so both draw the same
subset), then copies the first ``n_files`` (the raw ``.npy`` and a
viewable ``.tif`` of each, post-processed by ``recon.mirflickr.postprocess``
on the app's device) with their lensed ground truths and the PSF into a
timestamped folder.

    python -m lenslesspicam_tpu_torch.scripts.data.prepare_mirflickr_subset data=<dataset dir>

Reads the JAX app's ``_DEFAULTS``; returns the subset's folder, as the JAX
app does.
"""

import glob
import os
from datetime import datetime
from shutil import copyfile

import numpy as np

from .._common import app

_DEFAULTS = {"data": None, "n_files": 200, "seed": 11,
             "output_dir_path": None, "output_dir": "outputs"}


@app(None)
def subset_mirflickr(config, device):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    from PIL import Image

    from ..._device import as_host
    from ...recon.mirflickr import postprocess

    data = config["data"]
    assert data and os.path.isdir(data), "set data=<DiffuserCam dataset dir>"
    n_files = int(config["n_files"])
    seed = int(config["seed"])

    diffuser_dir = os.path.join(data, "dataset", "diffuser_images")
    lensed_dir = os.path.join(data, "dataset", "ground_truth_lensed")
    psf_path = os.path.join(data, "psf.tiff")

    timestamp = datetime.now().strftime("%d%m%Y_%Hh%M")
    output_dir_fn = f"DiffuserCam_Mirflickr_{n_files}_{timestamp}_seed{seed}"
    base = config["output_dir_path"] or config["run_dir"]
    output_dir = os.path.join(base, output_dir_fn)
    diffuser_out = os.path.join(output_dir, "diffuser")
    lensed_out = os.path.join(output_dir, "lensed")
    os.makedirs(diffuser_out)
    os.makedirs(lensed_out)
    print(f"Created output directory : {output_dir}")

    diffuser_files = glob.glob(os.path.join(diffuser_dir, "*.npy"))
    np.random.seed(seed)
    np.random.shuffle(diffuser_files)
    subset = diffuser_files[:n_files]

    def viewable(fp):
        return (as_host(postprocess(np.load(fp), device=device)) * 255).astype(np.uint8)

    if os.path.exists(psf_path):
        copyfile(psf_path, os.path.join(output_dir, os.path.basename(psf_path)))
    for fn in subset:
        bn = os.path.basename(fn)
        copyfile(fn, os.path.join(diffuser_out, bn))
        Image.fromarray(viewable(fn)).save(
            os.path.join(diffuser_out, bn.split(".")[0] + ".tif"))

        lensed_fp = os.path.join(lensed_dir, bn)
        copyfile(lensed_fp, os.path.join(lensed_out, bn))
        Image.fromarray(viewable(lensed_fp)).save(
            os.path.join(lensed_out, bn.split(".")[0] + ".tif"))
    print(f"copied {len(subset)} pairs")
    return output_dir


if __name__ == "__main__":
    subset_mirflickr()
