"""Pretrained multi-lens inference under ambient light, with background
subtraction (the port of ``scripts/recon/multilens_ambient.py``).

    python -m lenslesspicam_tpu_torch.scripts.recon.multilens_ambient \
        model=U5+Unet8M idx=0 background_sub=true n_trials=10

``fn=`` and ``background_fn=`` reconstruct a raw measurement and its
background (local files, else files of the checkpoint's hub dataset),
each resized to the PSF grid; otherwise a test-set sample is used, with
its measured background where the sample carries one.  The measurement
and the background are normalized by the same factor, and the background
is passed to the model (``background=``; ADMM subtracts it).  Reads
``configs/recon_pretrained.yaml``; returns (reconstruction as numpy
``(1, D, H, W, C)``, average ms).  Deliberate differences: ``_load_raw``
imports ``huggingface_hub`` only for a file that is not on the disk (the
JAX app imports it first), and resizes the ``(D, H, W, C)`` stack in one
``data.image.resize`` call (the JAX app hands it each ``(H, W, C)`` depth,
which its ``resize`` rejects: a file off the PSF grid fails there); the
timing loop runs the reconstruction once before it starts the clock
(``_pretrained.timed_apply``).
"""

import os

from .._common import app, config_path

_CONFIG = config_path("recon_pretrained.yaml")


def _load_raw(repo, fn, psf_shape):
    """The raw (unnormalized) measurement ``fn``, a local file or one of the
    hub repo ``repo``, resized to the PSF grid."""
    from ...data.image import resize
    from ...data.io import load_image

    if os.path.exists(fn):
        fp = fn
    else:
        from huggingface_hub import hf_hub_download

        fp = hf_hub_download(repo_id=repo, filename=fn, repo_type="dataset")
    img = load_image(fp, return_float=True, as_4d=True, normalize=False)
    if img.shape[-3:-1] != tuple(psf_shape[-3:-1]):
        img = resize(img, shape=psf_shape[-3:])
    return img


@app(_CONFIG)
def main(config, device):
    import numpy as np

    from ..._device import as_host
    from ._pretrained import build_recon, build_test_set, load_bundle, save_outputs, timed_apply

    model_name = config.model or "admm"
    dataset = config.dataset or "mirflickr_ambient"
    model_path, model_config = load_bundle(
        "multilens", dataset, model_name, local_model_dir=config.cache_dir,
        model_path=config.get("model_path"))

    test_set = build_test_set(model_config, cache_dir=config.cache_dir, device=device)
    psf = np.asarray(test_set.psf)
    print("PSF shape: ", psf.shape)

    repo = model_config["files"]["dataset"]
    if config.get("fn"):
        lensless = _load_raw(repo, config.fn, psf.shape)
        if config.get("background_sub", True) and config.get("background_fn"):
            background = _load_raw(repo, config.background_fn, psf.shape)
        else:
            background = np.zeros_like(lensless)
        if config.get("rotate"):
            lensless = np.rot90(lensless, k=2, axes=(-3, -2)).copy()
            background = np.rot90(background, k=2, axes=(-3, -2)).copy()
        lensed = None
        idx = os.path.basename(config.fn).split(".")[0]
    else:
        idx = config.idx
        sample = test_set[idx]
        lensless, lensed = np.asarray(sample[0]), sample[1]
        background = np.asarray(sample[2]) if len(sample) > 2 else np.zeros_like(lensless)

    # normalize measurement and background by the same factor
    # (multilens_ambient.py:141-144)
    max_val = max(float(np.max(lensless)), 1e-9)
    lensless = lensless / max_val
    background = background / max_val

    print(f"Data shape :  {lensless.shape}")
    recon = build_recon(model_name, model_path, psf, n_iter=config.n_iter, device=device)
    use_bg = config.get("background_sub", True)
    res, avg_ms = timed_apply(recon, lensless[None], n_trials=config.n_trials,
                              background=background[None] if use_bg else None)

    if config.save:
        save_outputs(config.run_dir, model_name, idx, res, lensless, lensed,
                     alignment=getattr(test_set, "alignment", None), psf=psf,
                     background=background)
    return as_host(res), avg_ms


if __name__ == "__main__":
    main()
