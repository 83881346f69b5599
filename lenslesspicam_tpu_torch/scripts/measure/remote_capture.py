"""Capture from the Raspberry Pi's camera over SSH (the port of
``scripts/measure/remote_capture.py``).

    python -m lenslesspicam_tpu_torch.scripts.measure.remote_capture \
        rpi.username=pi rpi.hostname=raspberrypi.local capture.exp=0.1

Reads the JAX app's ``_DEFAULTS``; the capture rides the port's
``hardware/remote.py`` (the Pi runs ``on_device_capture.py``).  A raw
Bayer capture is also saved demosaiced as ``*_rgb.png``.  Returns None, as
the JAX app does.
"""

from .._common import app

_DEFAULTS = {
    "rpi": {"username": None, "hostname": None},
    "capture": {"exp": 0.02, "iso": 100, "bayer": True, "nbits_out": 12},
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    for key, val in _DEFAULTS.items():
        config.setdefault(key, val)
    from ...hardware import remote

    assert config["rpi"]["username"], "set rpi.username and rpi.hostname"
    fp, _ = remote.capture(
        config["rpi"]["username"], config["rpi"]["hostname"],
        output_path=config["run_dir"], **config["capture"],
    )
    print(f"captured {fp}")

    if config["capture"]["bayer"]:
        from ...data.io import load_image, save_image

        rgb = load_image(fp, bayer=False)
        save_image(rgb, fp.replace(".dng", "_rgb.png"))


if __name__ == "__main__":
    main()
