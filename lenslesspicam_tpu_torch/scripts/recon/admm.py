"""ADMM reconstruction app (the port of ``scripts/recon/admm.py``).

    python -m lenslesspicam_tpu_torch.scripts.recon.admm input.psf=psf.png \
        input.data=meas.png preprocess.downsample=4 admm.n_iter=100

Reads ``configs/recon.yaml``; returns the reconstruction as a numpy array
``(depth, H, W, C)``, as the JAX app does.
"""

import os
import time

from .._common import app, config_path

_CONFIG = config_path("recon.yaml")


@app(_CONFIG)
def main(config, device):
    from ... import ADMM
    from ..._device import as_host
    from ...data.io import load_data, save_image

    assert config.input.psf and config.input.data, "set input.psf and input.data"

    t0 = time.time()
    psf, data = load_data(
        config.input.psf,
        config.input.data,
        downsample=config.preprocess.downsample,
        shape=config.preprocess.shape,
        flip=config.preprocess.flip,
        bayer=config.preprocess.bayer,
        blue_gain=config.preprocess.blue_gain,
        red_gain=config.preprocess.red_gain,
        single_psf=config.preprocess.single_psf,
        gray=config.preprocess.gray,
    )
    print(f"data load : {time.time() - t0:.3f} s  psf {psf.shape} data {data.shape}")

    t0 = time.time()
    recon = ADMM(
        psf,
        mu1=float(config.admm.mu1),
        mu2=float(config.admm.mu2),
        mu3=float(config.admm.mu3),
        tau=float(config.admm.tau),
        device=device,
    )
    recon.set_data(data)
    print(f"setup     : {time.time() - t0:.3f} s")

    t0 = time.time()
    res = as_host(recon.apply(n_iter=config.admm.n_iter))
    print(f"recon     : {time.time() - t0:.3f} s ({config.admm.n_iter} iterations)")

    if config.save:
        out = os.path.join(config.run_dir, "reconstruction.png")
        save_image(res[0], out)
        print(f"saved     : {out}")
    return res


if __name__ == "__main__":
    main()
