"""Program the DigiCam's LCD with a saved or a seeded random pattern over
SSH (the port of ``scripts/hardware/config_digicam.py``).

    python -m lenslesspicam_tpu_torch.scripts.hardware.config_digicam \
        rpi.username=pi rpi.hostname=raspberrypi.local seed=3

The pattern: ``pattern=<.npy>``, or uint8 values of shape ``(3, *shape)``
drawn from ``RandomState(seed)``; saved as ``pattern.npy`` in the run
directory with ``save=true``, then set on the Pi through the port's
``hardware/remote.set_programmable_mask`` when ``rpi.username`` is given.
Reads the JAX app's ``_DEFAULTS``; returns None, as the JAX app does.
"""

import os

import numpy as np

from .._common import app

_DEFAULTS = {
    "rpi": {"username": None, "hostname": None},
    "pattern": None,          # .npy file; random if not given
    "shape": [26, 40],
    "seed": 0,
    "save": True,
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    if config["pattern"]:
        pattern = np.load(config["pattern"])
    else:
        rng = np.random.RandomState(config["seed"])
        pattern = (rng.rand(3, *config["shape"]) * 255).astype(np.uint8)
    if config["save"]:
        fp = os.path.join(config["run_dir"], "pattern.npy")
        np.save(fp, pattern)
        print(f"saved {fp}")
    if config["rpi"]["username"]:
        from ...hardware import remote

        remote.set_programmable_mask(pattern,
                                     rpi_username=config["rpi"]["username"],
                                     rpi_hostname=config["rpi"]["hostname"])
        print("mask programmed")


if __name__ == "__main__":
    main()
