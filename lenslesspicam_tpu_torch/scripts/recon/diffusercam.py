"""Pretrained-model (or ADMM) inference on the hub's DiffuserCam dataset,
with its average latency (the port of ``scripts/recon/diffusercam.py``).

    python -m lenslesspicam_tpu_torch.scripts.recon.diffusercam model=U10 idx=1 n_trials=10

The data come from the registry's hub dataset (``get_dataset``); the hub
or its cache is needed for the dataset and a checkpoint.  A zoo model
runs as the ``nn.Module`` that ``zoo.load_model`` returns, on the PSF the
checkpoint carries where it carries one (the JAX app calls the tuple that
its ``load_model`` returns, which fails).  Returns the last
reconstruction as a numpy array.
"""

import os
import time

from .._common import app

_DEFAULTS = {
    "model": "admm",         # zoo model name, or "admm"
    "idx": 0,
    "n_trials": 10,
    "n_iter": 100,           # for the admm fallback
    "save": True,
    "cache_dir": None,
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    from ...utils.config import apply_defaults

    apply_defaults(config, _DEFAULTS)
    import numpy as np
    import torch

    from ..._device import as_host
    from ...data.datasets import get_dataset
    from ...data.io import save_image

    dataset = get_dataset("diffusercam_mirflickr", split="test",
                          cache_dir=config["cache_dir"], device=device)
    psf = np.asarray(dataset.psf)
    print("Test set size:", len(dataset))
    lensless, lensed = dataset[config["idx"]][:2]
    print("Data shape:", np.asarray(lensless).shape)

    if config["model"] == "admm":
        from ... import ADMM

        recon = ADMM(psf, n_iter=config["n_iter"], device=device)
    else:
        from ...zoo.model_dict import download_model, load_model

        path = download_model(camera="diffusercam", dataset="mirflickr",
                              model=config["model"],
                              local_model_dir=config["cache_dir"])
        out = load_model(path, psf, device=device)
        model, psf_use = out[0], (out[2] if len(out) > 2 else psf)

        def recon(data):
            with torch.no_grad():
                return model(data, psf_use)

    t0 = time.time()
    for _ in range(config["n_trials"]):
        if hasattr(recon, "set_data"):
            recon.set_data(np.asarray(lensless)[None])
            res = as_host(recon.apply())
        else:
            res = as_host(recon(np.asarray(lensless)[None]))
    avg_ms = (time.time() - t0) / config["n_trials"] * 1000
    print(f"Avg inference [ms] : {avg_ms:.2f} ms")

    if config["save"]:
        out = config["run_dir"]
        save_image(res[0], os.path.join(out, f"{config['model']}_"
                                        f"{config['idx']}.png"))
        save_image(np.asarray(lensless),
                   os.path.join(out, f"lensless_{config['idx']}.png"))
        if lensed is not None:
            save_image(np.asarray(lensed),
                       os.path.join(out, f"original_{config['idx']}.png"))
        print(f"Saved images to {out}")
    return res


if __name__ == "__main__":
    main()
