"""Simulate a dataset from a PSF file and a folder of images, reconstruct
and evaluate (the port of ``scripts/sim/dataset.py``).

1) Load the PSF and simulate a measurement of every image of the folder
   (far-field convolution at the configured geometry, and noise).
2) Reconstruct the measurements with exact ADMM, batched:
   ``admm.batch_size`` files a call over ``(B, 1, H, W, C)``.
3) Report the average MSE / PSNR / SSIM (and LPIPS when RGB and its
   weights are given).

    python -m lenslesspicam_tpu_torch.scripts.sim.dataset files.dataset=images/ \
        files.psf=psf.png

Reads ``configs/sim_dataset.yaml``; returns the folder it saved to (None
with ``save=false``), as the JAX app does.  Deliberate difference: the
LPIPS catch is ``RuntimeError`` (no weights given) only, where the JAX app
passes over any exception.
"""

import glob
import os

import numpy as np

from .._common import app, config_path

_CONFIG = config_path("sim_dataset.yaml")


@app(_CONFIG)
def simulate(config, device):
    from ..._device import as_host
    from ...data.image import rgb2gray
    from ...data.io import load_image, load_psf, save_image
    from ...data.simulation import FarFieldSimulator
    from ...eval import metric
    from ...recon import admm

    np.random.seed(int(config.seed))
    dataset = config.files.dataset
    assert dataset and os.path.isdir(dataset), f"No dataset at {dataset}"
    psf_fp = config.files.psf
    assert psf_fp and os.path.exists(psf_fp), f"PSF {psf_fp} does not exist."
    sim_cfg = config.simulation
    grayscale = bool(sim_cfg.grayscale)

    print("\nPSF:")
    psf = np.asarray(load_psf(psf_fp, verbose=True, downsample=sim_cfg.downsample), np.float32)
    psf_sim = psf[0]
    if grayscale and psf_sim.ndim == 3:
        psf_sim = np.asarray(rgb2gray(psf_sim))
    if sim_cfg.downsample > 1:
        print(f"Downsampled to {psf_sim.shape}.")

    simulator = FarFieldSimulator(
        psf=psf_sim[None] if psf_sim.ndim == 3 else psf_sim[None, :, :, None],
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
        save_dir = os.path.join(config.run_dir, "dataset")
        for sub in ("sensor_plane", "object_plane", "reconstruction"):
            os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    files = sorted(glob.glob(os.path.join(dataset, f"*.{config.files.image_ext}")))
    if config.files.n_files is not None:
        files = files[: int(config.files.n_files)]
    assert files, f"no *.{config.files.image_ext} files in {dataset}"
    print(f"\nSimulating {len(files)} measurements...")

    names, lensless_all, lensed_all = [], [], []
    for fp in files:
        image = load_image(fp).astype(np.float32)
        if grayscale and image.ndim == 3:
            image = np.asarray(rgb2gray(image[None]))[0]
        image_plane, object_plane = simulator.propagate_image(image, return_object_plane=True)
        bn = os.path.basename(fp).split(".")[0] + ".png"
        names.append(bn)
        lensless_all.append(as_host(image_plane))
        lensed_all.append(as_host(object_plane))
        if config.save:
            save_image(lensed_all[-1], os.path.join(save_dir, "object_plane", bn))
            save_image(lensless_all[-1], os.path.join(save_dir, "sensor_plane", bn),
                       max_val=int(sim_cfg.max_val))

    if not config.admm.enable:
        print(f"\nSimulated dataset saved to {save_dir}")
        return save_dir

    print("\nReconstructing (batched jit ADMM)...")
    conv = admm.make_convolver(psf if psf.ndim == 4 else psf[None], device=device)
    bs = max(int(config.admm.batch_size), 1)
    recovered_all = []
    for i in range(0, len(lensless_all), bs):
        chunk = lensless_all[i: i + bs]
        stack = np.stack([m / m.max() for m in chunk])[:, None]
        if stack.ndim == 4:
            stack = stack[..., None]
        out = as_host(admm.run_jit(conv, stack, n_iter=int(config.admm.n_iter)))
        recovered_all.extend(out[:, 0])

    mse_vals, psnr_vals, ssim_vals, lpips_vals = [], [], [], []
    for bn, truth, est in zip(names, lensed_all, recovered_all):
        est = np.squeeze(np.asarray(est, np.float32))
        truth = np.squeeze(truth) / max(np.squeeze(truth).max(), 1e-12)
        est = est / max(est.max(), 1e-12)
        if config.save:
            save_image(est, os.path.join(save_dir, "reconstruction", bn),
                       max_val=int(sim_cfg.max_val))
        channel_axis = 2 if truth.ndim == 3 else None
        mse_vals.append(float(metric.mse(truth, est)))
        psnr_vals.append(float(metric.psnr(truth, est)))
        ssim_vals.append(float(metric.ssim(truth, est, channel_axis=channel_axis,
                                           device=device)))
        if not grayscale and truth.ndim == 3 and min(truth.shape[:2]) >= 32:
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
