"""Simulate a mask, measure a folder of images through it, and reconstruct
(the port of ``scripts/sim/mask_dataset.py``).

1) Build the mask (MURA / MLS coded aperture, Fresnel zone aperture, or
   phase contour), as ``mask_single_file`` does.
2) Simulate every image of the folder: far-field PSF convolution, or the
   separable FlatCam model (``mask.simulate``).
3) Reconstruct with separable Tikhonov or exact ADMM and report the
   average MSE / PSNR / SSIM (and LPIPS when RGB and its weights are
   given).

ADMM runs batched: ``recon.batch_size`` files a call over ``(B, 1, H, W,
C)``.

    python -m lenslesspicam_tpu_torch.scripts.sim.mask_dataset files.dataset=images/ \
        mask.type=MLS simulation.flatcam=True recon.algo=tikhonov

Reads ``configs/sim_mask_dataset.yaml``; returns the folder it saved to
(None with ``save=false``), as the JAX app does.  Deliberate differences:
``build_mask`` is imported from ``mask_single_file`` (the JAX package keeps
two copies of it); the LPIPS catch is ``RuntimeError`` (no weights given)
only, where the JAX app passes over any exception.
"""

import glob
import os
import warnings

import numpy as np

from .._common import app, config_path
from .mask_single_file import build_mask

_CONFIG = config_path("sim_mask_dataset.yaml")


@app(_CONFIG)
def simulate(config, device):
    import cv2

    from ..._device import as_host
    from ...data.image import rgb2gray
    from ...data.io import load_image, save_image
    from ...data.simulation import FarFieldSimulator
    from ...eval import metric
    from ...recon import admm
    from ...recon.tikhonov import CodedApertureReconstruction

    np.random.seed(int(config.seed))
    dataset = config.files.dataset
    assert dataset and os.path.isdir(dataset), f"No dataset at {dataset}"
    sim_cfg = config.simulation
    grayscale = bool(sim_cfg.grayscale)

    # 1) simulate mask
    mask = build_mask(config, device)
    psf = as_host(mask.psf)
    psf = psf / np.linalg.norm(psf.ravel())
    if grayscale and psf.ndim == 3:
        psf = np.asarray(rgb2gray(psf))
    print(f"PSF shape {psf.shape}")

    flatcam_sim = bool(sim_cfg.flatcam)
    if flatcam_sim and config.mask.type.upper() not in ("MURA", "MLS"):
        warnings.warn("FlatCam simulation only supported for MURA/MLS; "
                      "using far-field PSF simulation.")
        flatcam_sim = False

    simulator = FarFieldSimulator(
        psf=psf[None] if psf.ndim == 3 else psf[None, :, :, None],
        object_height=sim_cfg.object_height,
        scene2mask=sim_cfg.scene2mask,
        mask2sensor=sim_cfg.mask2sensor,
        sensor=sim_cfg.sensor,
        snr_db=sim_cfg.snr_db,
        max_val=sim_cfg.max_val,
        device=device,
    )

    save_dir = None
    if config.save:
        suffix = "_flatcam_sim" if flatcam_sim else ""
        save_dir = os.path.join(
            config.run_dir,
            os.path.basename(os.path.normpath(dataset)) + "_" + str(config.mask.type) + suffix)
        for sub in ("sensor_plane", "object_plane", "reconstruction"):
            os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    # 2) simulate measurements
    files = sorted(glob.glob(os.path.join(dataset, f"*.{config.files.image_ext}")))
    if config.files.n_files is not None:
        files = files[: int(config.files.n_files)]
    assert files, f"no *.{config.files.image_ext} files in {dataset}"
    print(f"\nSimulating {len(files)} measurements...")

    names, lensless_all, lensed_all = [], [], []
    for fp in files:
        image = load_image(fp).astype(np.float32) / 255.0
        if grayscale and image.ndim == 3:
            image = np.asarray(rgb2gray(image[None]))[0]
        image_plane, object_plane = simulator.propagate_image(image, return_object_plane=True)
        image_plane = as_host(image_plane)
        object_plane = as_host(object_plane)
        if flatcam_sim:
            image_plane = as_host(mask.simulate(object_plane, snr_db=sim_cfg.snr_db))
        bn = os.path.basename(fp).split(".")[0] + ".png"
        names.append(bn)
        lensless_all.append(image_plane)
        lensed_all.append(object_plane)
        if config.save:
            save_image(object_plane, os.path.join(save_dir, "object_plane", bn))
            save_image(image_plane, os.path.join(save_dir, "sensor_plane", bn),
                       max_val=int(sim_cfg.max_val))

    if config.recon.algo is None:
        print(f"\nSimulated dataset saved to {save_dir}")
        return save_dir

    # 3) reconstruct
    algo = str(config.recon.algo).lower()
    print(f"\nReconstructing with {algo}...")
    recovered_all = []
    if algo == "tikhonov":
        recon = CodedApertureReconstruction(
            mask, lensed_all[0].shape, lmbd=float(config.recon.tikhonov.reg), device=device)
        for meas in lensless_all:
            recovered_all.append(as_host(recon.apply(meas / meas.max())))
    elif algo == "admm":
        psf5 = psf[None] if psf.ndim == 3 else psf[None, :, :, None]
        conv = admm.make_convolver(psf5.astype(np.float32), device=device)
        bs = max(int(config.recon.batch_size), 1)
        n_iter = int(config.recon.admm.n_iter)
        for i in range(0, len(lensless_all), bs):
            chunk = lensless_all[i: i + bs]
            stack = np.stack([m / m.max() for m in chunk])[:, None]
            if stack.ndim == 4:
                stack = stack[..., None]
            out = as_host(admm.run_jit(conv, stack, n_iter=n_iter))
            recovered_all.extend(out[:, 0])
    else:
        raise ValueError(f"unknown recon algo {algo!r}")

    # metrics
    mse_vals, psnr_vals, ssim_vals, lpips_vals = [], [], [], []
    for bn, truth, est in zip(names, lensed_all, recovered_all):
        est = np.squeeze(np.asarray(est, np.float32))
        truth = np.squeeze(truth)
        if est.shape[:2] != truth.shape[:2]:
            est = cv2.resize(est, (truth.shape[1], truth.shape[0]))
        if config.save:
            save_image(est, os.path.join(save_dir, "reconstruction", bn),
                       max_val=int(sim_cfg.max_val))
        channel_axis = 2 if truth.ndim == 3 else None
        mse_vals.append(float(metric.mse(truth, est)))
        psnr_vals.append(float(metric.psnr(truth, est)))
        ssim_vals.append(float(metric.ssim(truth, est, channel_axis=channel_axis,
                                           device=device)))
        if not grayscale and truth.ndim == 3:
            try:
                lpips_vals.append(float(metric.lpips(truth, est, device=device)))
            except RuntimeError:  # no LPIPS weights given
                pass

    print("\nMSE (avg)", np.mean(mse_vals))
    print("PSNR (avg)", np.mean(psnr_vals))
    print("SSIM (avg)", np.mean(ssim_vals))
    if lpips_vals:
        print("LPIPS (avg)", np.mean(lpips_vals))
    if config.save:
        print("Results saved to", save_dir)
    return save_dir


if __name__ == "__main__":
    simulate()
