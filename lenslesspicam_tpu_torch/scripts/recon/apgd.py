"""APGD reconstruction app (the port of ``scripts/recon/apgd.py``: the
accelerated proximal gradient solver of ``recon.apgd``).

    python -m lenslesspicam_tpu_torch.scripts.recon.apgd input.psf=psf.png \
        input.data=meas.png apgd.n_iter=500

Reads ``configs/recon.yaml``; returns a numpy array ``(batch, depth, H, W,
C)``.
"""

import os
import time

from .._common import app, config_path

_CONFIG = config_path("recon.yaml")


@app(_CONFIG)
def main(config, device):
    from ..._device import as_host
    from ...data.io import load_data, save_image
    from ...recon import apgd

    assert config.input.psf and config.input.data
    psf, data = load_data(config.input.psf, config.input.data,
                          downsample=config.preprocess.downsample)
    conv = apgd.make_convolver(psf, device=device)
    t0 = time.time()
    res = as_host(apgd.run(
        conv, data, n_iter=config.apgd.n_iter,
        prox_penalty=config.apgd.prox_penalty,
        diff_penalty=config.apgd.diff_penalty,
    ))
    print(f"apgd recon: {time.time() - t0:.3f} s")
    if config.save:
        save_image(res[0, 0], os.path.join(config.run_dir, "reconstruction.png"))
    return res


if __name__ == "__main__":
    main()
