"""Reconstruct samples of a registered dataset with a classical solver or
a zoo model (the port of ``scripts/recon/dataset_recon.py``).

    python -m lenslesspicam_tpu_torch.scripts.recon.dataset_recon \
        dataset=diffusercam_mirflickr algo=admm n_iter=100 n_files=4

``algo=hf:<camera>:<dataset>:<model>`` downloads a published checkpoint
(``zoo.download_model``) and runs the model ``zoo.load_model`` rebuilds
from it, on the PSF the checkpoint carries where it carries one.
Returns the per-sample metrics.
"""

import os
import time

import numpy as np

from .._common import app

_DEFAULTS = {
    "dataset": None,          # registered HF dataset name
    "split": "test",
    "downsample": 2,
    "algo": "admm",           # admm | fista | hf:<camera>:<dataset>:<model>
    "n_iter": 100,
    "n_files": 4,
    "save": True,
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    import torch

    from ... import ADMM, FISTA
    from ..._device import as_host
    from ...data.datasets import get_dataset
    from ...data.io import save_image
    from ...eval.metrics import compute_metrics

    assert config["dataset"], "set dataset=<registered name>"
    ds = get_dataset(config["dataset"], split=config["split"],
                     downsample=config["downsample"], device=device)
    psf = ds.psf

    algo = config["algo"]
    if algo.startswith("hf:"):
        from ...zoo.model_dict import download_model, load_model

        _, camera, dsname, model_name = algo.split(":")
        path = download_model(camera, dsname, model_name)
        out = load_model(path, psf, device=device)
        model, psf_use = out[0], (out[2] if len(out) > 2 else psf)

        def reconstruct(lensless):
            with torch.no_grad():
                return model(lensless, psf_use)
    else:
        solver = {"admm": ADMM, "fista": FISTA}[algo](psf, device=device)

        def reconstruct(lensless):
            return solver.batch_apply(lensless, n_iter=config["n_iter"])

    times, scores = [], []
    for i in range(min(config["n_files"], len(ds))):
        lensless, lensed = ds[i]
        t0 = time.time()
        rec_dev = reconstruct(lensless[None])
        rec = as_host(rec_dev)
        times.append(time.time() - t0)
        metrics = {k: float(v) for k, v in
                   compute_metrics(rec_dev, np.asarray(lensed)[None]).items()}
        scores.append(metrics)
        print(f"[{i}] {times[-1] * 1000:.1f} ms  {metrics}")
        if config["save"]:
            save_image(rec[0], os.path.join(config["run_dir"], f"recon_{i}.png"))
            save_image(lensed, os.path.join(config["run_dir"], f"lensed_{i}.png"))
    print(f"avg inference: {np.mean(times[1:]) * 1000:.1f} ms"
          if len(times) > 1 else "")
    return scores


if __name__ == "__main__":
    main()
