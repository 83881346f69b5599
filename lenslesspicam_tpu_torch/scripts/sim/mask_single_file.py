"""Simulate a mask, measure one image through it, and reconstruct (the port
of ``scripts/sim/mask_single_file.py``).

1) Build the mask (MURA / MLS coded aperture, Fresnel zone aperture, or
   phase contour) from the sensor geometry, its PSF on the device.
2) Simulate the measurement: far-field PSF convolution
   (``FarFieldSimulator``), or the separable FlatCam model of a coded
   aperture (``mask.simulate``).
3) Reconstruct with separable Tikhonov (FlatCam, arXiv:1509.00116 Eq 7) or
   exact ADMM, and report MSE / PSNR / SSIM.

    python -m lenslesspicam_tpu_torch.scripts.sim.mask_single_file mask.type=MLS \
        simulation.flatcam=True recon.algo=tikhonov files.original=image.png

Reads ``configs/sim_mask_single.yaml``; returns the estimate (numpy, the
object plane's shape) that the metrics score.  Deliberate differences:
none in what it computes; the mask, the simulator, the Tikhonov solver and
ADMM run on the app's device, and the host steps (grayscale, Bayer, the
``cv2.resize`` of a Tikhonov estimate at the mask's resolution) on numpy
as in the JAX app.
"""

import os
import warnings

import numpy as np

from .._common import app, config_path

_CONFIG = config_path("sim_mask_single.yaml")


def build_mask(config, device=None):
    """The mask of ``config.mask`` at ``config.simulation``'s sensor,
    downsample and mask-to-sensor distance, its PSF on ``device``."""
    from ...hardware.mask import CodedAperture, FresnelZoneAperture, PhaseContour

    mask_type = config.mask.type
    sensor = config.simulation.sensor
    downsample = config.simulation.downsample
    mask2sensor = float(config.simulation.mask2sensor)
    if mask_type.upper() in ("MURA", "MLS"):
        return CodedAperture.from_sensor(
            sensor_name=sensor, downsample=downsample, method=mask_type.upper(),
            n_bits=int(config.mask.n_bits), distance_sensor=mask2sensor, device=device)
    if mask_type.upper() == "FZA":
        return FresnelZoneAperture.from_sensor(
            sensor_name=sensor, downsample=downsample, distance_sensor=mask2sensor,
            device=device)
    if mask_type.lower() == "phasecontour":
        return PhaseContour.from_sensor(
            sensor_name=sensor, downsample=downsample,
            n_iter=int(config.mask.phase_mask_iter), distance_sensor=mask2sensor,
            device=device)
    raise ValueError(f"unknown mask type {mask_type!r}")


@app(_CONFIG)
def simulate(config, device):
    from ..._device import as_host
    from ...data.image import rgb2bayer, rgb2gray
    from ...data.io import load_image, save_image
    from ...data.simulation import FarFieldSimulator
    from ...eval import metric
    from ...recon import admm
    from ...recon.tikhonov import CodedApertureReconstruction

    fp = config.files.original
    assert fp and os.path.exists(fp), f"File {fp} does not exist."
    sim_cfg = config.simulation
    image_format = str(sim_cfg.image_format).lower()
    bayer = image_format not in ("grayscale", "rgb")

    # 1) simulate mask
    mask = build_mask(config, device)
    psf = as_host(mask.psf)
    psf = psf / psf.sum()

    # 2) simulate measurement
    image = load_image(fp).astype(np.float32) / 255.0
    flatcam_sim = bool(sim_cfg.flatcam)
    if flatcam_sim and config.mask.type.upper() not in ("MURA", "MLS"):
        warnings.warn("FlatCam simulation only supported for MURA/MLS; "
                      "using far-field PSF simulation.")
        flatcam_sim = False

    simulator = FarFieldSimulator(
        psf=psf[None],
        object_height=sim_cfg.object_height,
        scene2mask=sim_cfg.scene2mask,
        mask2sensor=sim_cfg.mask2sensor,
        sensor=sim_cfg.sensor,
        snr_db=sim_cfg.snr_db,
        max_val=sim_cfg.max_val,
        device=device,
    )
    image_plane, object_plane = simulator.propagate_image(image, return_object_plane=True)
    image_plane = as_host(image_plane)
    object_plane = as_host(object_plane)

    if image_format == "grayscale":
        image_plane = np.asarray(rgb2gray(image_plane))
        object_plane = np.asarray(rgb2gray(object_plane))
    elif bayer:
        pattern = image_format[-4:]
        image_plane = np.asarray(rgb2bayer(image_plane, pattern=pattern))
        object_plane = np.asarray(rgb2bayer(object_plane, pattern=pattern))

    if flatcam_sim:
        image_plane = as_host(mask.simulate(object_plane, snr_db=sim_cfg.snr_db))

    if config.save:
        save_image(object_plane, os.path.join(config.run_dir, "original.png"))
        save_image(image_plane, os.path.join(config.run_dir, "lensless.png"))
        save_image(psf, os.path.join(config.run_dir, "psf.png"))

    # 3) reconstruct
    algo = str(config.recon.algo).lower()
    if algo == "tikhonov":
        recon = CodedApertureReconstruction(
            mask, object_plane.shape, lmbd=float(config.recon.tikhonov.reg), device=device)
        recovered = as_host(recon.apply(image_plane))
    elif algo == "admm":
        if bayer:
            raise ValueError("ADMM reconstruction not supported for Bayer.")
        psf5 = psf[None] if psf.ndim == 3 else psf[None, :, :, None]
        data = image_plane[None, None] if image_plane.ndim == 3 else \
            image_plane[None, None, :, :, None]
        conv = admm.make_convolver(psf5.astype(np.float32), device=device)
        recovered = as_host(admm.run_jit(conv, data, n_iter=int(config.recon.admm.n_iter)))[0, 0]
    else:
        raise ValueError(f"unknown recon algo {algo!r}")

    if config.save:
        save_image(recovered, os.path.join(config.run_dir, "reconstruction.png"))

    print("\nEvaluation:")
    truth = np.squeeze(object_plane)
    est = np.squeeze(np.asarray(recovered, np.float32))
    if est.shape != truth.shape:  # e.g. Tikhonov at mask resolution
        import cv2

        est = cv2.resize(est, (truth.shape[1], truth.shape[0]))
    channel_axis = 2 if truth.ndim == 3 else None
    print("MSE", float(metric.mse(truth, est)))
    print("PSNR", float(metric.psnr(truth, est)))
    print("SSIM", float(metric.ssim(truth, est, channel_axis=channel_axis, device=device)))
    return est


if __name__ == "__main__":
    simulate()
