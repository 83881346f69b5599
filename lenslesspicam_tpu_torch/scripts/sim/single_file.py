"""Simulate a lensless measurement of one image and reconstruct it (the
port of ``scripts/sim/single_file.py``).

1) Resize the image to the PSF grid at the configured object height.
2) Convolve with the PSF.
3) Add noise at the configured SNR.
4) Reconstruct with ADMM and report MSE / PSNR / SSIM (and LPIPS when RGB
   and its weights are available).

    python -m lenslesspicam_tpu_torch.scripts.sim.single_file \
        files.original=image.png files.psf=psf.png

Reads ``configs/sim_single_file.yaml``; returns the reconstruction as a
numpy array ``(H, W, C)``.
"""

import os

import numpy as np

from .._common import app, config_path

_CONFIG = config_path("sim_single_file.yaml")


@app(_CONFIG)
def simulate(config, device):
    from ..._device import as_host
    from ...data.image import rgb2gray
    from ...data.io import load_image, load_psf, save_image
    from ...data.simulation import FarFieldSimulator
    from ...eval import metric
    from ...recon import admm

    fp = config.files.original
    psf_fp = config.files.psf
    assert fp and os.path.exists(fp), f"File {fp} does not exist."
    assert psf_fp and os.path.exists(psf_fp), f"PSF {psf_fp} does not exist."

    sim_cfg = config.simulation
    image = load_image(fp, verbose=True).astype(np.float32)
    if sim_cfg.grayscale and image.ndim == 3:
        image = np.asarray(rgb2gray(image[None]))[0]

    psf = load_psf(psf_fp, verbose=True, downsample=sim_cfg.downsample)
    psf = np.asarray(psf, np.float32)
    if sim_cfg.grayscale and psf.shape[-1] == 3:
        psf = np.asarray(rgb2gray(psf))
    if sim_cfg.downsample > 1:
        print(f"Downsampled to {psf.shape}.")

    simulator = FarFieldSimulator(
        psf=psf,
        object_height=sim_cfg.object_height,
        scene2mask=sim_cfg.scene2mask,
        mask2sensor=sim_cfg.mask2sensor,
        sensor=sim_cfg.sensor,
        snr_db=sim_cfg.snr_db,
        max_val=sim_cfg.max_val,
        device=device,
    )
    image_plane, object_plane = simulator.propagate_image(
        image, return_object_plane=True)
    image_plane = as_host(image_plane)
    object_plane = as_host(object_plane)
    if config.save:
        save_image(object_plane, os.path.join(config.run_dir, "object_plane.png"))
        save_image(image_plane, os.path.join(config.run_dir, "image_plane.png"))

    conv = admm.make_convolver(psf, device=device)
    data = image_plane[None, None] if image_plane.ndim == 3 else \
        image_plane[None, None, :, :, None]
    recovered = as_host(admm.run_jit(conv, data, n_iter=config.admm.n_iter))[0, 0]
    if config.save:
        save_image(recovered, os.path.join(config.run_dir, "reconstruction.png"))

    print("\nEvaluation:")
    truth = object_plane if object_plane.ndim == 3 else object_plane[..., None]
    est = recovered
    print("MSE", float(metric.mse(truth, est)))
    print("PSNR", float(metric.psnr(truth, est)))
    if sim_cfg.grayscale:
        print("SSIM", float(metric.ssim(truth, est, channel_axis=None, device=device)))
    else:
        print("SSIM", float(metric.ssim(truth, est, device=device)))
        try:
            print("LPIPS", float(metric.lpips(truth, est, device=device)))
        except RuntimeError as e:  # no LPIPS weights given
            print(f"LPIPS unavailable ({e})")
    return recovered


if __name__ == "__main__":
    simulate()
