"""Pretrained-model (or ADMM) inference on a local copy of
DiffuserCam-MirFlickr, with its average latency (the port of
``scripts/recon/diffusercam_mirflickr.py``).

    python -m lenslesspicam_tpu_torch.scripts.recon.diffusercam_mirflickr \
        model_name=U5+Unet8M files.dataset=DiffuserCam/ files.psf=psf.tiff idx=3 n_trials=10

``model_name=admm`` (or null) runs exact ADMM instead of a learned model;
a zoo model needs the hub or its cache for the checkpoint (or
``model_path=`` a local checkpoint folder).  The data come from the local
folder (``DiffuserCamMirflickr``: ``diffuser_images/`` and
``ground_truth_lensed/`` of ``.npy`` files), the first 1000 allowed files
being the test split.  Reads ``configs/recon_pretrained.yaml``; returns
(reconstruction as numpy ``(1, D, H, W, C)``, average ms).  Deliberate
differences: the timing loop runs the reconstruction once before it
starts the clock (``_pretrained.timed_apply``), and a zoo model runs as
the module that ``zoo.load_model`` returns, on the checkpoint's PSF where
it carries one.
"""

from .._common import app, config_path

_CONFIG = config_path("recon_pretrained.yaml")


@app(_CONFIG)
def main(config, device):
    import numpy as np

    from ..._device import as_host
    from ...data.datasets import DiffuserCamMirflickr
    from ._pretrained import build_recon, load_bundle, save_outputs, timed_apply

    model_name = config.model_name or "admm"
    model_path = None
    if model_name != "admm":
        model_path, _ = load_bundle(
            "diffusercam", "mirflickr", model_name,
            local_model_dir=config.cache_dir, model_path=config.get("model_path"))

    dataset = DiffuserCamMirflickr(
        dataset_dir=config.files.dataset,
        psf_path=config.files.psf,
        downsample=config.files.downsample,
    )
    # reference keeps the first 1000 allowed files as the test split
    test_idx = [i for i in dataset.allowed_idx if i <= 1000]
    print("Test set size:", len(test_idx))

    lensless, lensed = dataset[test_idx[config.idx]]
    psf = dataset.psf
    print(f"Data shape :  {np.asarray(lensless).shape}")

    recon = build_recon(model_name, model_path, psf, n_iter=config.n_iter, device=device)
    res, avg_ms = timed_apply(recon, np.asarray(lensless)[None], n_trials=config.n_trials)

    if config.save:
        save_outputs(config.run_dir, model_name, config.idx, res, lensless, lensed)
    return as_host(res), avg_ms


if __name__ == "__main__":
    main()
