"""Projected gradient descent / FISTA reconstruction app (the port of
``scripts/recon/gradient_descent.py``; 3-D PSFs from .npy / .npz files).

    python -m lenslesspicam_tpu_torch.scripts.recon.gradient_descent \
        input.psf=psf.png input.data=meas.png gradient_descent.method=fista

Reads ``configs/recon.yaml``; returns a numpy array ``(depth, H, W, C)``.
"""

import os
import time

from .._common import app, config_path

_CONFIG = config_path("recon.yaml")


@app(_CONFIG)
def main(config, device):
    from ... import FISTA, GradientDescent, NesterovGradientDescent
    from ..._device import as_host
    from ...data.io import load_data, save_image

    assert config.input.psf and config.input.data

    psf, data = load_data(
        config.input.psf, config.input.data,
        downsample=config.preprocess.downsample,
        flip=config.preprocess.flip, gray=config.preprocess.gray,
        use_3d=str(config.input.psf).endswith((".npy", ".npz")),
    )
    method = config.gradient_descent.method
    cls = {"vanilla": GradientDescent, "nesterov": NesterovGradientDescent,
           "fista": FISTA}[method]
    recon = cls(psf, device=device)
    recon.set_data(data)
    t0 = time.time()
    res = as_host(recon.apply(n_iter=config.gradient_descent.n_iter))
    print(f"{method} recon: {time.time() - t0:.3f} s")
    if config.save:
        save_image(res[0], os.path.join(config.run_dir, "reconstruction.png"))
    return res


if __name__ == "__main__":
    main()
