"""Measure a PSF for each of a set of DigiCam patterns: set each pattern on
the LCD, then capture the point source's response, over SSH (the port of
``scripts/hardware/digicam_measure_psfs.py``).

    python -m lenslesspicam_tpu_torch.scripts.hardware.digicam_measure_psfs \
        rpi.username=pi rpi.hostname=raspberrypi.local masks=patterns.npy

``masks`` is an ``(N, 3, H, W)`` ``.npy``; capture ``i`` is fetched as
``psf_{i:04d}`` into the run directory.  Reads the JAX app's
``_DEFAULTS``; both legs ride the port's ``hardware/remote.py``.  Returns
None, as the JAX app does.
"""

import numpy as np

from .._common import app

_DEFAULTS = {
    "rpi": {"username": None, "hostname": None},
    "masks": None,            # .npy of patterns (N, 3, H, W)
    "capture": {"exp": 0.5, "bayer": True},
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    from ...hardware import remote

    assert config["rpi"]["username"] and config["masks"]
    masks = np.load(config["masks"])
    for i, pattern in enumerate(masks):
        remote.set_programmable_mask(pattern,
                                     rpi_username=config["rpi"]["username"],
                                     rpi_hostname=config["rpi"]["hostname"])
        fp, _ = remote.capture(config["rpi"]["username"],
                               config["rpi"]["hostname"],
                               fn=f"psf_{i:04d}",
                               output_path=config["run_dir"],
                               **config["capture"])
        print(f"[{i}] {fp}")


if __name__ == "__main__":
    main()
