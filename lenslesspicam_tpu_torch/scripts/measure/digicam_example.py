"""DigiCam end to end: set a programmable-mask pattern, capture (or load)
a measurement, and reconstruct it with the simulated (or measured) PSF
(the port of ``scripts/measure/digicam_example.py``).

1) Mask values from ``mask.fp``, or a pattern drawn from
   ``RandomState(mask.seed)``.
2) The PSF: a measured one (``psf=``), or simulated from the mask by
   ``AdafruitLCD`` on the app's device.
3) The measurement: ``capture.fp``, or, with ``rpi.username`` and
   ``rpi.hostname``, the pattern set on the Raspberry Pi over SSH
   (``hardware.remote.set_programmable_mask``) and a capture fetched from
   it (``hardware.remote.capture``).
4) One exact ADMM solve; the raw measurement and the result saved.

    python -m lenslesspicam_tpu_torch.scripts.measure.digicam_example capture.fp=raw.png

Reads the JAX app's ``_DEFAULTS`` (no YAML); returns the normalized
reconstruction (numpy, ``(1, H, W, 3)``).  Deliberate differences: none in
what it computes; the SSH path uses the port's ``hardware/remote.py``.
"""

import os

import numpy as np

from .._common import app

_DEFAULTS = {
    "psf": None,                 # measured PSF path (else simulate)
    "capture": {
        "fp": None,              # measurement path (else capture via SSH)
        "sensor": "rpi_hq",
        "down": 8,
        "flip": True,
        "exp": 0.8,
    },
    "mask": {
        "fp": None,              # (3*Nh, Nw) stored mask values .npy
        "seed": 0,
        "shape": [18, 26],
        "center": [57, 77],
    },
    "simulation": {
        "scene2mask": 0.3,
        "mask2sensor": 0.002,
        "deadspace": True,
        "gamma": None,
    },
    "rpi": {"username": None, "hostname": None},
    "recon": {"n_iter": 100},
    "output_dir": "outputs",
}


@app(None)
def digicam(config, device):
    import torch

    from ..._device import as_host
    from ...data.image import gamma_correction
    from ...data.io import load_image, load_psf, save_image
    from ...hardware.slm import adafruit_sub2full
    from ...hardware.trainable_mask import AdafruitLCD
    from ...recon import admm
    from ...utils.config import apply_defaults

    apply_defaults(config, _DEFAULTS)
    out_dir = config["run_dir"]
    cap = config["capture"]
    sim = config["simulation"]

    # 1) mask values
    if config["mask"]["fp"]:
        mask_vals = np.load(config["mask"]["fp"])
    else:
        rng = np.random.RandomState(int(config["mask"]["seed"]))
        mask_vals = rng.uniform(0, 1, tuple(config["mask"]["shape"]))

    mask = AdafruitLCD(
        initial_vals=mask_vals.astype(np.float32),
        sensor=cap["sensor"],
        downsample=int(cap["down"]),
        flipud=bool(cap["flip"]),
        scene2mask=float(sim["scene2mask"]),
        mask2sensor=float(sim["mask2sensor"]),
        deadspace=bool(sim["deadspace"]),
        device=device,
    )

    # 2) PSF
    if config["psf"]:
        psf = np.asarray(load_psf(config["psf"], downsample=int(cap["down"]),
                                  flip=bool(cap["flip"])), np.float32)
    else:
        with torch.no_grad():
            psf = as_host(mask.get_psf(mask.params))
    psf_np = psf[0]
    if sim["gamma"]:
        psf_np = gamma_correction(psf_np / psf_np.max(), gamma=float(sim["gamma"]))
    save_image(psf_np, os.path.join(out_dir, "digicam_psf.png"))
    print(f"PSF shape: {psf.shape}")

    # 3) measurement
    if cap["fp"]:
        img = np.asarray(load_image(cap["fp"], verbose=True))
    else:
        from ...hardware import remote

        assert config["rpi"]["username"] and config["rpi"]["hostname"], (
            "no capture.fp given and no RPi configured (rpi.username/hostname)")
        pattern = adafruit_sub2full(mask_vals, center=tuple(config["mask"]["center"]))
        print("Setting mask...")
        remote.set_programmable_mask(
            pattern, "adafruit", rpi_username=config["rpi"]["username"],
            rpi_hostname=config["rpi"]["hostname"])
        print("Capturing...")
        localfile, img = remote.capture(
            rpi_username=config["rpi"]["username"],
            rpi_hostname=config["rpi"]["hostname"],
            exp=float(cap["exp"]), output_path=out_dir)
        print(f"Captured to {localfile}")
        img = np.asarray(img)

    print("image range:", img.min(), img.max())

    # 4) reconstruct
    img = img.astype(np.float32) / img.max()
    if img.ndim == 3:
        img = img[None]          # (D, H, W, C)
    if cap["flip"]:
        img = np.rot90(img, k=2, axes=(-3, -2))
    if img.shape[-3:-1] != psf.shape[-3:-1]:
        from ...data.image import resize

        img = np.asarray(resize(img, shape=psf.shape[-3:-1] + (img.shape[-1],)))
    print("Reconstructing")
    conv = admm.make_convolver(psf, device=device)
    res = as_host(admm.run_jit(conv, np.ascontiguousarray(img)[None],
                               n_iter=int(config["recon"]["n_iter"])))[0]
    res = res / res.max()
    save_image(img[0], os.path.join(out_dir, "digicam_raw.png"))
    save_image(res[0], os.path.join(out_dir, "digicam_recon.png"))
    print("Done")
    return res


if __name__ == "__main__":
    digicam()
