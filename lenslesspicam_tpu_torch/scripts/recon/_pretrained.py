"""The flow that the pretrained-model apps share (the port of
``scripts/recon/_pretrained.py``).

The reference repeats one recipe in each of its per-camera scripts:
download a checkpoint, read its embedded Hydra config, rebuild the test
set from it, reconstruct one example with a timed n_trials loop, save the
aligned crops.  Here it is one module; the per-camera apps pass their
registry coordinates and extras (alignment crop, ambient background).

The timing loop runs the reconstruction once before it starts the clock
(the first call builds the card's kernels and plans) and synchronizes the
card after each trial; a learned model runs under ``torch.no_grad``.
"""

from __future__ import annotations

import os
import time

from .._common import app_device


def load_bundle(camera: str, dataset: str, model_name: str,
                local_model_dir=None, model_path: str | None = None):
    """(model_path, embedded config dict).  ``model_name == "admm"`` still
    downloads a sibling checkpoint for its dataset config (reference
    digicam.py:23-35)."""
    import yaml

    from ...zoo.model_dict import download_model, model_dict

    if model_path is None:
        name = model_name
        if model_name == "admm":  # any trained entry supplies the data config
            name = next(iter(model_dict[camera][dataset]))
        model_path = download_model(camera=camera, dataset=dataset, model=name,
                                    local_model_dir=local_model_dir)
    cfg_path = os.path.join(model_path, ".hydra", "config.yaml")
    with open(cfg_path) as f:
        model_config = yaml.safe_load(f)
    return model_path, model_config


def build_test_set(model_config: dict, cache_dir=None, n_files=None,
                   return_mask_label=False, hf_repo=None, device=None):
    """The ``HFDataset`` of a checkpoint's embedded config (the recurring
    construction of the reference scripts); its PSF work runs on
    ``device`` (None: the app's device)."""
    from ...data.datasets import HFDataset

    files = model_config.get("files", {}) or {}
    return HFDataset(
        huggingface_repo=hf_repo or files["dataset"],
        psf=files.get("huggingface_psf"),
        split="test",
        n_files=n_files,
        display_res=files.get("image_res"),
        rotate=files.get("rotate", False),
        flipud=files.get("flipud", False),
        flip_lensed=files.get("flip_lensed", False),
        downsample=files.get("downsample", 1),
        alignment=model_config.get("alignment"),
        simulation=model_config.get("simulation"),
        force_rgb=files.get("force_rgb", False),
        return_mask_label=return_mask_label,
        cache_dir=cache_dir,
        device=app_device(device),
    )


def build_recon(model_name: str, model_path: str, psf, n_iter: int = 100, device=None):
    """Callable ``recon(lensless[, background]) -> (B, D, H, W, C)`` tensor
    on ``device`` (None: the app's device): classical ADMM for
    ``model_name == "admm"``, otherwise the checkpoint's learned model."""
    import torch

    from ..._device import as_device

    device = app_device(device)
    if model_name == "admm":
        from ...recon import admm

        conv = admm.make_convolver(psf, device=device)

        def recon(lensless, background=None):
            data = as_device(lensless, torch.float32, device)
            if background is not None:
                data = torch.clamp(data - as_device(background, torch.float32, device), min=0.0)
            return admm.run_jit(conv, data, n_iter=n_iter)

        return recon

    from ...zoo.model_dict import load_model

    out = load_model(model_path, psf=psf, device=device)
    model = out[0]
    psf_use = as_device(out[2] if len(out) > 2 and out[2] is not None else psf,
                        torch.float32, device)

    def recon(lensless, background=None):
        kwargs = {}
        if background is not None:
            kwargs["background"] = as_device(background, torch.float32, device)
        with torch.no_grad():
            return model(as_device(lensless, torch.float32, device), psf_use, **kwargs)

    return recon


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_apply(recon, lensless, n_trials: int = 1, background=None):
    """(result, avg_ms): one call outside the clock, then ``n_trials``
    calls, the card synchronized after each (the reference's start/end
    loop, diffusercam_mirflickr.py:65-78)."""
    res = recon(lensless, background)
    _sync()
    t0 = time.time()
    for _ in range(n_trials):
        res = recon(lensless, background)
        _sync()
    avg_ms = (time.time() - t0) / max(n_trials, 1) * 1000
    print(f"Avg inference [ms] : {avg_ms:.3f} ms")
    return res, avg_ms


def alignment_crop(img2d, alignment: dict | None):
    """Crop a (H, W, C) reconstruction to the display alignment window."""
    if not alignment:
        return img2d
    top_left = alignment["top_left"]
    h = alignment.get("height")
    w = alignment.get("width")
    if h is None and "dim" in alignment:
        h, w = alignment["dim"]
    if w is None and h is not None:
        w = int(h * img2d.shape[1] / img2d.shape[0])
    return img2d[top_left[0]: top_left[0] + h, top_left[1]: top_left[1] + w]


def save_outputs(run_dir, model_name, idx, res, lensless, lensed=None,
                 alignment=None, psf=None, background=None):
    """Save the reconstruction (alignment-cropped), raw measurement and
    ground truth as the reference scripts do in the hydra run dir."""
    from ..._device import as_host
    from ...data.io import save_image

    img = as_host(res)
    while img.ndim > 3:
        img = img[0]
    out_fp = os.path.join(run_dir, f"{model_name}_idx{idx}.png")
    save_image(alignment_crop(img, alignment), out_fp)
    files = [out_fp]
    if lensed is not None:
        fp = os.path.join(run_dir, f"original_idx{idx}.png")
        save_image(as_host(lensed).squeeze(), fp)
        files.append(fp)
    raw = as_host(lensless)
    while raw.ndim > 3:
        raw = raw[0]
    fp = os.path.join(run_dir, f"lensless_idx{idx}.png")
    save_image(raw, fp)
    files.append(fp)
    if psf is not None:
        fp = os.path.join(run_dir, "psf.png")
        save_image(as_host(psf).squeeze(), fp)
        files.append(fp)
    if background is not None:
        bg = as_host(background)
        while bg.ndim > 3:
            bg = bg[0]
        fp = os.path.join(run_dir, f"background_idx{idx}.png")
        save_image(bg, fp)
        files.append(fp)
    print(f"saved: {', '.join(files)}")
    return files
