"""Simulate a lensless dataset from images and a PSF or a mask design (the
port of ``scripts/sim/simulate_dataset.py``).

    python -m lenslesspicam_tpu_torch.scripts.sim.simulate_dataset n_files=32 \
        mask.type=FresnelZoneAperture mask.downsample=16

Reads ``configs/simulate.yaml``; writes the pairs as .npy files and
returns their folder.
"""

import os

import numpy as np

from .._common import app, config_path

_CONFIG = config_path("simulate.yaml")


@app(_CONFIG)
def main(config, device):
    from ..._device import as_host
    from ...data.datasets import simulate_dataset
    from ...data.io import load_psf, save_image

    psf = None
    if config.psf:
        psf = load_psf(config.psf, downsample=config.mask.downsample)
    elif config.mask.type:
        from ...hardware import mask as mask_mod

        cls = getattr(mask_mod, config.mask.type)
        m = cls.from_sensor(config.sensor, downsample=config.mask.downsample,
                            distance_sensor=float(config.mask.distance_sensor),
                            device=device)
        psf = as_host(m.psf)[None]
        psf = psf / np.linalg.norm(psf)

    ds = simulate_dataset(
        {
            "dataset": config.dataset,
            "n_files": config.n_files,
            "object_height": config.object_height,
            "scene2mask": config.scene2mask,
            "mask2sensor": config.mask2sensor,
            "sensor": config.sensor,
            "snr_db": config.snr_db,
        },
        psf=psf,
        device=device,
    )

    save_dir = config.save_dir or os.path.join(config.run_dir, "dataset")
    os.makedirs(os.path.join(save_dir, "diffuser"), exist_ok=True)
    os.makedirs(os.path.join(save_dir, "lensed"), exist_ok=True)
    for i in range(len(ds)):
        lensless, lensed = ds[i]
        np.save(os.path.join(save_dir, "diffuser", f"im{i}.npy"), lensless)
        np.save(os.path.join(save_dir, "lensed", f"im{i}.npy"), lensed)
    if psf is not None:
        np.save(os.path.join(save_dir, "psf.npy"), np.asarray(psf))
    save_image(ds[0][0], os.path.join(config.run_dir, "example_lensless.png"))
    print(f"saved {len(ds)} pairs to {save_dir}")
    return save_dir


if __name__ == "__main__":
    main()
