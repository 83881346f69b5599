"""Reconstruct a previously captured raw measurement (the port of
``scripts/recon/demo.py``, the offline half of the demo pipeline).

    python -m lenslesspicam_tpu_torch.scripts.recon.demo raw=raw_data.png \
        camera.psf=psf.png recon.algo=fista

The demo's camera models: a measured PSF (with its corner background
subtracted) or a DigiCam PSF simulated from a seeded mask; Bayer or RGB
input; a flip; per-algorithm parameter groups; a fractional post-crop.
Returns the cropped reconstruction as a numpy array.
"""

import os
import time

import numpy as np

from .._common import app

_DEFAULTS = {
    "raw": None,                 # captured measurement file
    "bayer": False,
    "nbits_out": 12,
    "camera": {"psf": None, "mask": None,
               "red_gain": 1.9, "blue_gain": 1.2},
    "recon": {"algo": "admm", "downsample": 4, "flipud": False,
              "admm": {"n_iter": 100, "mu1": 1e-6, "mu2": 1e-5,
                       "mu3": 4e-5, "tau": 1e-4},
              "fista": {"n_iter": 300, "lip_fact": 1.8}},
    "postproc": {"crop_hor": None, "crop_vert": None},
    "save": True,
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    from ...utils.config import apply_defaults

    apply_defaults(config, _DEFAULTS)
    from ... import ADMM, FISTA
    from ..._device import as_host
    from ...data.image import resize
    from ...data.io import load_image, load_psf, save_image

    assert config["raw"], "set raw=<captured measurement file>"
    img = load_image(config["raw"], bayer=config["bayer"],
                     red_gain=config["camera"]["red_gain"],
                     blue_gain=config["camera"]["blue_gain"],
                     nbits_out=config["nbits_out"], return_float=True)

    if config["camera"]["mask"] is not None:
        from ...hardware.trainable_mask import AdafruitLCD

        mcfg = config["camera"]["mask"]
        rng = np.random.RandomState(mcfg.get("seed", 0) % (2 ** 32 - 1))
        vals = rng.uniform(0, 1, tuple(mcfg["mask_shape"])).astype(np.float32)
        mask = AdafruitLCD(initial_vals=vals,
                           sensor=mcfg.get("sensor", "rpi_hq"),
                           slm=mcfg.get("device", "adafruit"),
                           downsample=config["recon"]["downsample"],
                           flipud=mcfg.get("flipud", False), device=device)
        psf = as_host(mask.get_psf(mask.params))
        bg = np.zeros(psf.shape[-1], np.float32)
    else:
        assert config["camera"]["psf"], "set camera.psf or camera.mask"
        psf, bg = load_psf(config["camera"]["psf"],
                           downsample=config["recon"]["downsample"],
                           return_float=True, return_bg=True)

    data = np.clip(np.asarray(img, np.float32) - bg, 0, None)
    if data.ndim == 3:
        data = data[None]
    elif data.ndim == 2:
        data = data[None, :, :, None]
    if data.shape != psf.shape:
        data = resize(data, shape=psf.shape)
    data /= np.linalg.norm(data.ravel())
    if config["recon"]["flipud"]:
        data = np.rot90(data, k=2, axes=(-3, -2))

    algo = config["recon"]["algo"]
    params = dict(config["recon"][algo])
    n_iter = params.pop("n_iter")
    recon = (ADMM(psf, device=device, **params) if algo == "admm"
             else FISTA(psf, device=device, **params))
    recon.set_data(data)
    t0 = time.time()
    res = as_host(recon.apply(n_iter=n_iter))
    print(f"Processing time : {time.time() - t0:.3f} s")

    final = res[0]
    if config["postproc"]["crop_hor"] is not None:
        lo, hi = config["postproc"]["crop_hor"]
        final = final[:, int(lo * final.shape[1]):int(hi * final.shape[1])]
    if config["postproc"]["crop_vert"] is not None:
        lo, hi = config["postproc"]["crop_vert"]
        final = final[int(lo * final.shape[0]):int(hi * final.shape[0]), :]
    if config["save"]:
        out_fp = os.path.join(config["run_dir"], "reconstructed.png")
        save_image(final, out_fp)
        print(f"saved {out_fp}")
    return final


if __name__ == "__main__":
    main()
