"""Pretrained DigiCam inference with timing and the alignment crop (the
port of ``scripts/recon/digicam.py``).

    python -m lenslesspicam_tpu_torch.scripts.recon.digicam model=U10 \
        dataset=mirflickr_single_25k idx=0 n_trials=10

``model=admm`` runs classical ADMM on a trained checkpoint's dataset
config.  ``fn=<file.png>`` reconstructs a raw measurement of the hub's
dataset repo instead of a test-set sample.  Reads
``configs/recon_pretrained.yaml``; returns (reconstruction tensor, average
ms).
"""

import os

from .._common import app, config_path

_CONFIG = config_path("recon_pretrained.yaml")


@app(_CONFIG)
def main(config, device):
    import numpy as np

    from ._pretrained import (build_recon, build_test_set, load_bundle,
                              save_outputs, timed_apply)

    model_name = config.model or "admm"
    dataset = config.dataset or "mirflickr_single_25k"
    model_path, model_config = load_bundle(
        "digicam", dataset, model_name, local_model_dir=config.cache_dir,
        model_path=config.get("model_path"))

    test_set = build_test_set(model_config, cache_dir=config.cache_dir, device=device)
    psf = test_set.psf
    print("Test set size: ", len(test_set))

    if config.get("fn"):
        # raw measurement straight from the dataset repo
        from huggingface_hub import hf_hub_download

        from ...data.io import load_image

        fp = hf_hub_download(repo_id=model_config["files"]["dataset"],
                             filename=config.fn, repo_type="dataset")
        lensless = load_image(fp, return_float=True, as_4d=True)
        if config.get("rotate"):
            lensless = np.rot90(lensless, k=2, axes=(-3, -2)).copy()
        lensed = None
        idx = os.path.basename(fp).split("_")[0]
    else:
        idx = config.idx
        lensless, lensed = test_set[idx][:2]
        lensless = np.asarray(lensless)

    print(f"Data shape :  {lensless.shape}")
    recon = build_recon(model_name, model_path, psf, n_iter=config.n_iter, device=device)
    res, avg_ms = timed_apply(recon, lensless[None], n_trials=config.n_trials)

    if config.save:
        save_outputs(config.run_dir, model_name, idx, res, lensless, lensed,
                     alignment=getattr(test_set, "alignment", None), psf=psf)
    return res, avg_ms


if __name__ == "__main__":
    main()
