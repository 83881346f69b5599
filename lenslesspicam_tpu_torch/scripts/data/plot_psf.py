"""Render a dataset's PSF as a viewable gamma-corrected PNG (the port of
``scripts/data/plot_psf.py``).

The PSF is a local path, or a file of a Hugging Face dataset repo
(``repo_id``, fetched by ``huggingface_hub.hf_hub_download``, imported
only then).  A stored mask pattern (``.npy``) is first turned into a PSF
by ``AdafruitLCD`` on the app's device, with the ``sim`` geometry of the
config; any other file is read by ``data.io.load_psf``.

    python -m lenslesspicam_tpu_torch.scripts.data.plot_psf psf=<psf.png> gamma=1.8
    python -m lenslesspicam_tpu_torch.scripts.data.plot_psf repo_id=<hf repo> psf=mask_pattern.npy

Reads the JAX app's ``_DEFAULTS``; returns the PNG's path, as the JAX app
does.
"""

import os

import numpy as np

from .._common import app

_DEFAULTS = {
    "repo_id": None,        # HF dataset repo (else psf is a local path)
    "psf": None,            # filename (in repo) or local path
    "downsample": 8,
    "gamma": 1.8,
    "flip_ud": False,
    "sim": {"scene2mask": 0.3, "mask2sensor": 0.002, "deadspace": True},
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    for k, v in _DEFAULTS.items():
        if isinstance(v, dict):
            config.setdefault(k, {})
            for kk, vv in v.items():
                config[k].setdefault(kk, vv)
        else:
            config.setdefault(k, v)
    from ...data.image import gamma_correction
    from ...data.io import load_psf, save_image

    psf_name = config["psf"]
    assert psf_name, "set psf=<path or repo filename>"
    if config["repo_id"]:
        from huggingface_hub import hf_hub_download

        psf_fp = hf_hub_download(repo_id=config["repo_id"],
                                 filename=psf_name, repo_type="dataset")
        base = os.path.basename(config["repo_id"])
    else:
        psf_fp = psf_name
        base = os.path.basename(psf_name).split(".")[0]
    assert os.path.exists(psf_fp), f"{psf_fp} not found"

    if psf_fp.endswith(".npy"):
        import torch

        from ..._device import as_host
        from ...hardware.trainable_mask import AdafruitLCD

        mask_vals = np.load(psf_fp)
        mask = AdafruitLCD(
            initial_vals=mask_vals.astype(np.float32),
            sensor="rpi_hq",
            downsample=int(config["downsample"]),
            flipud=bool(config["flip_ud"]),
            scene2mask=float(config["sim"]["scene2mask"]),
            mask2sensor=float(config["sim"]["mask2sensor"]),
            deadspace=bool(config["sim"]["deadspace"]),
            device=device,
        )
        with torch.no_grad():
            psf = as_host(mask.get_psf(mask.params))
    else:
        psf = np.asarray(load_psf(psf_fp, downsample=int(config["downsample"]),
                                  flip_ud=bool(config["flip_ud"])))

    psf = psf / psf.max()
    if float(config["gamma"]) > 1:
        psf = gamma_correction(psf, gamma=float(config["gamma"]))

    fn = os.path.join(config["run_dir"], f"{base}_psf.png")
    save_image(np.squeeze(psf), fn)
    print(f"Saved PSF as {fn}")
    return fn


if __name__ == "__main__":
    main()
