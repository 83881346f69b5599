"""Simulate the DigiCam PSF from a programmable-mask pattern (the port of
``scripts/sim/digicam_psf.py``).

1) Load the full-grid (3, H, W) pattern and extract the controllable
   subregion around the aperture's center.
2) Place the cell values on the sensor grid and propagate to the sensor
   plane (spherical illumination times the mask, angular spectrum):
   ``AdafruitLCD.get_psf`` on the app's device.
3) Save the simulated PSF and the extracted mask values and, with
   ``save=true``, its plot and, when a measured PSF is given, the measured
   PSF's plot and an overlay of the two.

    python -m lenslesspicam_tpu_torch.scripts.sim.digicam_psf files.pattern=pattern.npy

Reads ``configs/sim_digicam_psf.yaml``; returns the simulated PSF (numpy,
``(H, W, 3)``).  Deliberate difference: the plots are best-effort.  The
PSF's PNG and ``mask_vals.npy`` are written first; when matplotlib cannot
be imported (the CUDA machine has none) the app prints that it skips the
plots and returns.  Only the ``ImportError`` of ``import matplotlib`` is
caught, so a fault in the plotting itself still raises.  The JAX app
needs matplotlib whenever ``save=true``.
"""

import os
import time

import numpy as np

from .._common import app, config_path

_CONFIG = config_path("sim_digicam_psf.yaml")


@app(_CONFIG)
def digicam_psf(config, device):
    import torch

    from ..._device import as_host
    from ...data.io import save_image
    from ...hardware.slm import adafruit_full2subpattern
    from ...hardware.trainable_mask import AdafruitLCD

    fp = config.files.pattern
    assert fp and os.path.exists(fp), f"Pattern {fp} does not exist."
    out_dir = config.run_dir

    dc = config.digicam
    ap_center = tuple(int(v) for v in dc.ap_center)
    ap_shape = tuple(int(v) for v in dc.ap_shape)

    # load the full-grid pattern and extract the aperture subregion
    pattern = np.load(fp)
    if pattern.ndim == 2:
        pattern = np.stack([pattern] * 3, axis=0)
    pattern_sub = adafruit_full2subpattern(pattern, ap_shape, ap_center)
    print("Controllable region shape:", pattern_sub.shape)
    print("Total number of pixels:", int(np.prod(pattern_sub.shape)))

    slm_vals = np.asarray(pattern_sub, np.float32) / 255.0
    if str(dc.slm) == "adafruit":
        # flatten the color channel along rows (column-major), the
        # stored-pattern convention (reference digicam_psf.py:117-119)
        slm_vals = slm_vals.reshape((-1, slm_vals.shape[-1]), order="F")
    if config.save:
        np.save(os.path.join(out_dir, "mask_vals.npy"), slm_vals)

    t0 = time.time()
    downsample = int(dc.downsample) if int(dc.downsample) > 1 else None
    mask = AdafruitLCD(
        initial_vals=slm_vals,
        sensor=str(dc.sensor),
        downsample=downsample,
        scene2mask=float(config.sim.scene2mask),
        mask2sensor=float(config.sim.mask2sensor),
        vertical_shift=(int(dc.vertical_shift) // max(int(dc.downsample), 1)
                        if dc.vertical_shift else 0),
        horizontal_shift=(int(dc.horizontal_shift) // max(int(dc.downsample), 1)
                          if dc.horizontal_shift else 0),
        flipud=bool(config.sim.flipud),
        deadspace=bool(config.sim.deadspace),
        device=device,
    )
    with torch.no_grad():
        psf_sim = as_host(mask.get_psf(mask.params))[0]  # (H, W, 3)
    print(f"\nProcessing time: {time.time() - t0:.2f} seconds")

    if config.save:
        bn = os.path.basename(fp).split(".")[0]
        save_image(psf_sim, os.path.join(out_dir, f"{bn}_SIM_psf.png"))
        try:
            import matplotlib
        except ImportError:
            print("matplotlib is not installed: the PSF plots are skipped")
        else:
            _plots(matplotlib, psf_sim, config, out_dir)
        print(f"\nFiles saved to: {out_dir}")
    return psf_sim


def _plots(matplotlib, psf_sim, config, out_dir):
    """The simulated PSF's plot and, when ``files.psf`` names a measured
    PSF, its plot and the overlay of the two."""
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ...data.io import load_psf
    from ...utils.plot import plot_image

    dc = config.digicam
    fig, ax = plt.subplots(frameon=False)
    plot_image(psf_sim, gamma=float(dc.gamma), ax=ax)
    ax.set_axis_off()
    fig.savefig(os.path.join(out_dir, "sim_psf_plot.png"))
    plt.close(fig)

    psf_fp = config.files.psf
    if psf_fp and os.path.exists(psf_fp):
        psf_meas = np.asarray(load_psf(psf_fp, downsample=int(dc.downsample)))
        fig, ax = plt.subplots(frameon=False)
        plot_image(psf_meas, gamma=float(dc.gamma), ax=ax)
        ax.set_axis_off()
        fig.savefig(os.path.join(out_dir, "meas_psf_plot.png"))
        plt.close(fig)

        fig, ax = plt.subplots()
        ax.imshow(psf_sim / psf_sim.max(), alpha=0.7)
        ax.imshow(np.squeeze(psf_meas) / psf_meas.max(), alpha=0.4)
        fig.savefig(os.path.join(out_dir, "psf_overlay.png"))
        plt.close(fig)


if __name__ == "__main__":
    digicam_psf()
