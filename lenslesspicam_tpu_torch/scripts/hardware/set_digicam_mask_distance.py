"""Set the DigiCam's mask-to-sensor distance with its stepper motors over
SSH (the port of ``scripts/hardware/set_digicam_mask_distance.py``).

    python -m lenslesspicam_tpu_torch.scripts.hardware.set_digicam_mask_distance \
        rpi.username=pi rpi.hostname=raspberrypi.local distance_mm=4

Reads the JAX app's ``_DEFAULTS``; the command rides the port's
``hardware/remote.py``.  Returns None, as the JAX app does.
"""

from .._common import app

_DEFAULTS = {"rpi": {"username": None, "hostname": None}, "distance_mm": 4.0,
             "output_dir": "outputs"}


@app(None)
def main(config, device):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    from ...hardware import remote

    assert config["rpi"]["username"], "set rpi.username / rpi.hostname"
    remote.set_mask_sensor_distance(float(config["distance_mm"]),
                                    config["rpi"]["username"],
                                    config["rpi"]["hostname"])
    print(f"mask-sensor distance set to {config['distance_mm']} mm")


if __name__ == "__main__":
    main()
