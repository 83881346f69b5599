"""The demo end to end: display an image, set the mask, capture,
reconstruct (the port of ``scripts/demo.py``).

1) The image ``fp`` is shown on the Raspberry Pi's screen.
2) With ``camera.mask``, a seeded random DigiCam pattern is set on the LCD
   and its PSF simulated by ``AdafruitLCD`` on the app's device; else
   ``camera.psf`` is a measured PSF, its corner background subtracted.
3) A capture with the full set of camera settings of ``capture``.
4) The measurement, resized to the PSF and normalized, is solved by the
   port's ``ADMM`` or ``FISTA`` (``recon.algo``, in chunks of
   ``disp_iter``); the result is cropped (``postproc``) and saved, and the
   raw capture removed.

    python -m lenslesspicam_tpu_torch.scripts.demo rpi.username=pi \
        rpi.hostname=raspberrypi.local camera.psf=psf.png

The Pi is reached only through the port's ``hardware/remote.py`` (display,
mask, capture) over SSH.  Reads the JAX app's ``_DEFAULTS``; returns the
run directory (None with ``save=false``), as the JAX app does.  Deliberate
difference: the diagnostic plots (raw data, histogram, PSF) are
best-effort.  When matplotlib cannot be imported (the CUDA machine has
none) the app prints that it skips them and goes on; only the
``ImportError`` of ``import matplotlib`` is caught.  The JAX app needs
matplotlib whenever ``save`` or ``plot`` is set.
"""

import os
import time

import numpy as np

from ._common import app

_DEFAULTS = {
    "rpi": {"username": None, "hostname": None,
            "python": "~/LenslessPiCam/lensless_env/bin/python"},
    "fp": "data/original/tree.png",    # image to display
    "plot": True,
    "save": True,
    "display": {"brightness": 100, "rot90": 0, "pad": 0,
                "vshift": 0, "hshift": 0, "wait": 2},
    "camera": {
        # EITHER a measured PSF path ...
        "psf": None,
        # ... OR a simulated DigiCam mask (dict enables it):
        #   {"seed": 0, "mask_shape": [54, 26], "mask_center": [57, 77],
        #    "device": "adafruit", "flipud": False}
        "mask": None,
        "red_gain": 1.9, "blue_gain": 1.2,
    },
    "capture": {"sensor": "rpi_hq", "exp": 0.02, "iso": 100,
                "bayer": True, "legacy": True, "rgb": False, "gray": False,
                "nbits": 12, "nbits_out": 12, "config_pause": 2,
                "sensor_mode": "0", "down": None, "awb_gains": None,
                "delay": 2, "gamma": 2.2},
    "recon": {"algo": "admm", "downsample": 4, "gamma": 2.2,
              "flipud": False,
              "admm": {"n_iter": 100, "disp_iter": 20,
                       "mu1": 1e-6, "mu2": 1e-5, "mu3": 4e-5, "tau": 1e-4},
              "fista": {"n_iter": 300, "disp_iter": 50, "lip_fact": 1.8}},
    "postproc": {"crop_hor": None, "crop_vert": None},
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    from ..utils.config import apply_defaults

    apply_defaults(config, _DEFAULTS)

    from ..hardware import remote

    assert config["rpi"]["username"], "set rpi.username and rpi.hostname"
    user, host = config["rpi"]["username"], config["rpi"]["hostname"]
    save = config["run_dir"] if config["save"] else None

    # 1) display the file on the screen
    disp = dict(config["display"])
    wait = disp.pop("wait", 2)
    remote.display(config["fp"], user, host, wait=wait, **disp)

    # 2) program the mask (DigiCam) and simulate its PSF
    mask = None
    if config["camera"]["mask"] is not None:
        from ..hardware.slm import adafruit_sub2full
        from ..hardware.trainable_mask import AdafruitLCD

        mcfg = config["camera"]["mask"]
        rng = np.random.RandomState(mcfg.get("seed", 0) % (2 ** 32 - 1))
        mask_vals = rng.uniform(
            0, 1, tuple(mcfg["mask_shape"])).astype(np.float32)
        pattern = adafruit_sub2full(mask_vals,
                                    center=tuple(mcfg["mask_center"]))
        remote.set_programmable_mask(
            pattern, mcfg.get("device", "adafruit"),
            rpi_username=user, rpi_hostname=host)
        mask = AdafruitLCD(initial_vals=mask_vals,
                           sensor=config["capture"]["sensor"],
                           slm=mcfg.get("device", "adafruit"),
                           downsample=config["recon"]["downsample"],
                           flipud=mcfg.get("flipud", False), device=device)
    time.sleep(config["capture"]["delay"])  # for the picture to display

    # 3) capture (the full parameter set rides hardware/remote.capture)
    cap = {k: v for k, v in config["capture"].items()
           if k not in ("delay", "gamma")}
    raw_fp, img = remote.capture(
        user, host, fn="raw_data", output_path=config["run_dir"],
        rpi_python=config["rpi"]["python"], verbose=config["plot"],
        **cap)
    img = np.asarray(img)

    plt = None
    if save or config["plot"]:
        try:
            import matplotlib
        except ImportError:
            print("matplotlib is not installed: the plots are skipped")
        else:
            if not config["plot"]:
                matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            from ..utils.plot import pixel_histogram, plot_image

            ax = plot_image(img, gamma=config["capture"]["gamma"])
            ax.set_title("Raw data")
            if save:
                plt.savefig(os.path.join(save, "raw.png"))
            pixel_histogram(img)
            if save:
                plt.savefig(os.path.join(save, "histogram.png"))

    # 4) reconstruct
    import torch

    from .. import ADMM, FISTA
    from .._device import as_host
    from ..data.image import resize
    from ..data.io import load_psf, save_image

    if mask is not None:
        with torch.no_grad():
            psf = as_host(mask.get_psf(mask.params))
        bg = np.zeros(psf.shape[-1], np.float32)
    else:
        assert config["camera"]["psf"], "set camera.psf or camera.mask"
        psf, bg = load_psf(config["camera"]["psf"],
                           downsample=config["recon"]["downsample"],
                           return_float=True, return_bg=True)
    if plt is not None:
        ax = plot_image(psf[0], gamma=config["recon"]["gamma"])
        ax.set_title("PSF")
        if save:
            plt.savefig(os.path.join(save, "psf.png"))

    data = np.asarray(img, np.float32) - bg
    data = np.clip(data, 0, None)
    if data.ndim == 3:
        data = data[None]
    elif data.ndim == 2:
        data = data[None, :, :, None]
    if data.shape != psf.shape:
        data = resize(data, shape=psf.shape)
    data /= np.linalg.norm(data.ravel())
    if config["recon"]["flipud"]:
        data = np.ascontiguousarray(np.rot90(data, k=2, axes=(-3, -2)))

    algo_name = config["recon"]["algo"]
    params = dict(config["recon"][algo_name])
    n_iter = params.pop("n_iter")
    disp_iter = params.pop("disp_iter", None)
    if algo_name == "admm":
        recon = ADMM(psf, device=device, **params)
    elif algo_name == "fista":
        recon = FISTA(psf, device=device, **params)
    else:
        raise ValueError(f"Unsupported algorithm: {algo_name}")
    recon.set_data(data)
    t0 = time.time()
    res = as_host(recon.apply(n_iter=n_iter, disp_iter=disp_iter))
    print(f"Processing time : {time.time() - t0:.3f} s")

    # 5) postprocess and save
    final = res[0]
    if config["postproc"]["crop_hor"] is not None:
        lo, hi = config["postproc"]["crop_hor"]
        final = final[:, int(lo * final.shape[1]):int(hi * final.shape[1])]
    if config["postproc"]["crop_vert"] is not None:
        lo, hi = config["postproc"]["crop_vert"]
        final = final[int(lo * final.shape[0]):int(hi * final.shape[0]), :]
    if save:
        out_fp = os.path.join(save, "reconstructed.png")
        save_image(final, out_fp)
        print(f"saved {out_fp}")

    os.remove(raw_fp)  # clean up the raw capture
    if plt is not None and config["plot"]:
        plt.show()
    return save


if __name__ == "__main__":
    main()
