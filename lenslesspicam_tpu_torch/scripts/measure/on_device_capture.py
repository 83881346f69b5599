"""Camera capture on the Raspberry Pi itself (the port of
``scripts/measure/on_device_capture.py``).

The Pi runs it; ``hardware/remote.capture`` starts it there by path over
SSH and parses what it prints.  It takes raw Bayer frames (8 or 16 bit),
converts them on the Pi to RGB or grayscale through the HQ camera's ISP
chain (demosaic, black level, white-balance gains, colour matrix) when
asked, on the modern (libcamera / picamera2) or the legacy (picamerax)
camera stack, with exposure, ISO, sensor mode, white balance, resolution
and downsampling set from the config.

    python -m lenslesspicam_tpu_torch.scripts.measure.on_device_capture legacy=True exp=0.02
    python lenslesspicam_tpu_torch/scripts/measure/on_device_capture.py sensor=rpi_gs \
        legacy=False bayer=False down=2

Reads the JAX app's ``_DEFAULTS``.  It builds no tensor, so unlike the
port's other apps it resolves no device and runs without a CUDA card.  The
``key : value`` lines it prints are read by ``hardware/remote.capture``
(``RPi distribution``, ``Red gain``, ``Blue gain``): they are the JAX
app's, byte for byte.  The camera packages (``picamera2``, ``picamerax``)
and the ``libcamera-still`` / ``exiftool`` commands exist only on the Pi and
are reached only inside the capture functions.  Returns None, as the JAX
app does.
"""

import os
import sys
import time
from fractions import Fraction

if not __package__:        # run by path, as hardware/remote.capture starts it
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "..", "..", ".."))

from lenslesspicam_tpu_torch.utils.config import config_main  # noqa: E402

# legacy picamera AWB / exposure sensor modes, index == sensor_mode
SENSOR_MODES = [
    "off", "auto", "sunlight", "cloudy", "shade", "tungsten",
    "fluorescent", "incandescent", "flash", "horizon",
]

_DEFAULTS = {
    "sensor": "rpi_hq",
    "fn": "capture",
    "exp": 0.02,              # seconds
    "iso": 100,
    "config_pause": 2,        # settle time after configuring, seconds
    "sensor_mode": "0",
    "bayer": True,
    "rgb": False,             # convert to RGB on-device (legacy bayer path)
    "gray": False,            # convert to grayscale on-device
    "sixteen": False,         # 16-bit bayer container (12-bit HQ data)
    "legacy": True,           # picamerax (buster) vs libcamera/picamera2
    "down": None,             # downsample factor (modern PNG / rgb out)
    "res": None,              # explicit (width, height) override
    "nbits_out": 12,
    "awb_gains": None,        # [red, blue]; None = auto then freeze
    "output_dir": ".",
}


def get_distro():
    """'NAME VERSION' of the running OS, from ``/etc/os-release``."""
    try:
        with open("/etc/os-release") as f:
            info = dict(line.rstrip().split("=", 1)
                        for line in f if "=" in line)
        return (info.get("PRETTY_NAME") or info.get("NAME", "unknown")
                ).strip('"')
    except OSError:
        return "unknown"


def _capture_modern(config, fn):
    """Bullseye and later: ``libcamera-still`` DNG for raw Bayer, picamera2
    PNG otherwise."""
    import subprocess

    import numpy as np

    if config["bayer"]:
        assert config["down"] is None, "raw DNG capture cannot downsample"
        jpg_fn = fn + ".jpg"
        fn += ".dng"
        cmd = [
            "libcamera-still", "-r",
            "--gain", f"{config['iso'] / 100}",
            "--shutter", f"{int(config['exp'] * 1e6)}",
            "-o", jpg_fn,
        ]
        proc = subprocess.Popen(cmd, shell=False, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        proc.stdout.readlines()
        proc.stderr.readlines()
        os.system(f"exiftool {fn}")
        print("JPG saved to : {}".format(jpg_fn))
        return fn

    from picamera2 import Picamera2, Preview

    picam2 = Picamera2()
    picam2.start_preview(Preview.NULL)
    fn += ".png"

    max_res = picam2.camera_properties["PixelArraySize"]
    res = config["res"]
    if res:
        assert len(res) == 2
    else:
        res = np.array(max_res)
        if config["down"] is not None:
            res = (np.array(res) / config["down"]).astype(int)
    res = tuple(int(r) for r in res)
    print("Resolution : {}".format(res))

    picam2.preview_configuration.main.size = res
    picam2.still_configuration.size = res
    picam2.still_configuration.enable_raw()
    picam2.still_configuration.raw.size = res

    picam2.configure(picam2.create_preview_configuration())
    controls = {
        "ExposureTime": int(config["exp"] * 1e6),
        "AnalogueGain": 1.0,
    }
    if config["awb_gains"] is not None:
        assert len(config["awb_gains"]) == 2
        controls["ColourGains"] = tuple(config["awb_gains"])
    picam2.set_controls(controls)

    picam2.start("preview", show_preview=False)
    time.sleep(config["config_pause"])
    picam2.switch_mode_and_capture_file("still", fn)
    return fn


def _capture_legacy_bayer(config, fn):
    """Legacy picamerax raw Bayer capture with the camera's processing off,
    and the optional conversion to RGB or grayscale on the Pi."""
    import cv2
    import numpy as np
    import picamerax.array

    from lenslesspicam_tpu_torch.data.image import bayer2rgb_cc, resize, rgb2gray
    from lenslesspicam_tpu_torch.hardware.constants import (
        RPI_HQ_CAMERA_BLACK_LEVEL, RPI_HQ_CAMERA_CCM_MATRIX)

    fn += ".png"
    sensor_mode = int(config["sensor_mode"])
    camera = picamerax.PiCamera(framerate=1 / config["exp"],
                                sensor_mode=sensor_mode,
                                resolution=config["res"])
    # as little processing as possible
    camera.iso = config["iso"]
    camera.shutter_speed = int(config["exp"] * 1e6)
    camera.exposure_mode = "off"
    camera.drc_strength = "off"
    camera.image_denoise = False
    camera.image_effect = "none"
    camera.still_stats = False

    time.sleep(config["config_pause"])
    awb_gains = camera.awb_gains           # freeze the settled AWB
    camera.awb_mode = "off"
    camera.awb_gains = awb_gains

    print("Resolution : {}".format(camera.resolution))
    print("Shutter speed : {}".format(camera.shutter_speed))
    print("ISO : {}".format(camera.iso))
    print("Frame rate : {}".format(camera.framerate))
    print("Sensor mode : {}".format(SENSOR_MODES[sensor_mode]))
    # parsed by hardware/remote.capture — keep the format stable
    red_gain = float(awb_gains[0])
    blue_gain = float(awb_gains[1])
    print("Red gain : {}".format(red_gain))
    print("Blue gain : {}".format(blue_gain))

    stream = picamerax.array.PiBayerArray(camera)
    camera.capture(stream, "jpeg", bayer=True)
    if config["sixteen"]:
        output = np.sum(stream.array, axis=2).astype(np.uint16)
    else:
        output = (np.sum(stream.array, axis=2) >> 2).astype(np.uint8)

    if config["rgb"] or config["gray"]:
        n_bits = 12 if config["sixteen"] else 8
        if config["awb_gains"] is not None:
            red_gain, blue_gain = config["awb_gains"]
        output_rgb = bayer2rgb_cc(
            output, nbits=n_bits, blue_gain=blue_gain, red_gain=red_gain,
            black_level=RPI_HQ_CAMERA_BLACK_LEVEL,
            ccm=RPI_HQ_CAMERA_CCM_MATRIX, nbits_out=config["nbits_out"])
        if config["down"]:
            output_rgb = resize(output_rgb[None, ...], 1 / config["down"],
                                interpolation=cv2.INTER_CUBIC)[0]
        if config["gray"]:
            output_gray = rgb2gray(output_rgb[None, ...])
            output_gray = output_gray.astype(output_rgb.dtype).squeeze()
            cv2.imwrite(fn, output_gray)
        else:
            cv2.imwrite(fn, cv2.cvtColor(output_rgb, cv2.COLOR_RGB2BGR))
    else:
        from PIL import Image

        Image.fromarray(output).save(fn)
    return fn


def _capture_legacy_png(config, fn):
    """Legacy non-Bayer capture (the camera's ISP output)."""
    import numpy as np
    from picamerax import PiCamera

    fn += ".png"
    res = config["res"]
    if res:
        assert len(res) == 2
    else:
        camera = PiCamera()
        res = np.array(camera.MAX_RESOLUTION)
        camera.close()
        if config["down"] is not None:
            res = (np.array(res) / config["down"]).astype(int)
    camera = PiCamera(framerate=1 / config["exp"],
                      sensor_mode=int(config["sensor_mode"]),
                      resolution=tuple(int(r) for r in res))
    time.sleep(config["config_pause"])
    if config["awb_gains"] is not None:
        assert len(config["awb_gains"]) == 2
        camera.awb_mode = "off"
        camera.awb_gains = (Fraction(config["awb_gains"][0]),
                            Fraction(config["awb_gains"][1]))
        time.sleep(0.1)
    print("Resolution : {}".format(tuple(int(r) for r in res)))
    print("Red gain : {}".format(float(camera.awb_gains[0])))
    print("Blue gain : {}".format(float(camera.awb_gains[1])))
    try:
        camera.capture(fn)
    except ValueError:
        raise ValueError(
            "Out of resources! Use bayer for higher resolution, or "
            "increase `gpu_mem` in /boot/config.txt.")
    return fn


@config_main(None)
def main(config):
    from lenslesspicam_tpu_torch.hardware.sensor import SensorOptions, SensorParam, sensor_dict
    from lenslesspicam_tpu_torch.utils.config import apply_defaults

    apply_defaults(config, _DEFAULTS)

    sensor = config["sensor"]
    assert sensor in SensorOptions.values(), (
        f"sensor must be one of {SensorOptions.values()}")
    spec = sensor_dict[sensor]
    assert config["nbits_out"] in spec[SensorParam.BIT_DEPTH], (
        f"nbits_out must be one of {spec[SensorParam.BIT_DEPTH]} "
        f"for sensor {sensor}")
    assert spec[SensorParam.MIN_EXPOSURE] <= config["exp"] <= \
        spec[SensorParam.MAX_EXPOSURE], (
        f"exposure {config['exp']} outside sensor range")
    if sensor == SensorOptions.RPI_GS.value:
        assert not config["legacy"], "global-shutter sensor needs libcamera"

    distro = get_distro()
    print("RPi distribution : {}".format(distro))

    fn = config["fn"]
    if "bullseye" in distro and not config["legacy"]:
        assert not config["rgb"] and not config["gray"], (
            "on-device RGB/gray conversion is a legacy-stack feature")
        out = _capture_modern(config, fn)
    elif config["bayer"]:
        out = _capture_legacy_bayer(config, fn)
    else:
        out = _capture_legacy_png(config, fn)
    print("Image saved to : {}".format(out))


if __name__ == "__main__":
    main()
