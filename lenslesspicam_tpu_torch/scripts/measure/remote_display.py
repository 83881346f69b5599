"""Display an image on the Raspberry Pi's screen over SSH (the port of
``scripts/measure/remote_display.py``).

    python -m lenslesspicam_tpu_torch.scripts.measure.remote_display \
        rpi.username=pi rpi.hostname=raspberrypi.local fp=image.png

Reads the JAX app's ``_DEFAULTS``; the scp rides the port's
``hardware/remote.py``.  Returns None, as the JAX app does.
"""

from .._common import app

_DEFAULTS = {
    "rpi": {"username": None, "hostname": None},
    "fp": None,
    "display": {"brightness": 100, "rot90": 0, "pad": 0, "vshift": 0, "hshift": 0},
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    for key, val in _DEFAULTS.items():
        config.setdefault(key, val)
    from ...hardware import remote

    assert config["rpi"]["username"] and config["fp"]
    remote.display(config["fp"], config["rpi"]["username"],
                   config["rpi"]["hostname"], **config["display"])
    print("displayed", config["fp"])


if __name__ == "__main__":
    main()
