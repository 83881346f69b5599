"""Prepare an image for the display: fit it to the screen's resolution with
a padding margin, rotate, shift and dim it (the port of
``scripts/measure/prep_display_image.py``).

    python -m lenslesspicam_tpu_torch.scripts.measure.prep_display_image fp=image.png pad=10

Reads the JAX app's ``_DEFAULTS``; the canvas is host numpy (OpenCV's
resize, ``data.image.shift_with_pad``), saved as ``display.png`` in the run
directory.  Returns None, as the JAX app does.
"""

import os

import numpy as np

from .._common import app

_DEFAULTS = {
    "fp": None,
    "screen_res": [1080, 1920],
    "pad": 0,            # fraction of screen to pad around the image
    "vshift": 0,
    "hshift": 0,
    "rot90": 0,
    "brightness": 100,
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    for key, val in _DEFAULTS.items():
        config.setdefault(key, val)
    from ...data.image import shift_with_pad
    from ...data.io import load_image, save_image

    assert config["fp"]
    img = load_image(config["fp"], return_float=True)
    if config["rot90"]:
        img = np.rot90(img, config["rot90"])

    sh, sw = config["screen_res"]
    pad_frac = config["pad"] / 100.0 if config["pad"] > 1 else config["pad"]
    target_h = int(sh * (1 - 2 * pad_frac))
    scale = min(target_h / img.shape[0], sw / img.shape[1])
    import cv2

    img = cv2.resize(img, (int(img.shape[1] * scale), int(img.shape[0] * scale)))
    canvas = np.zeros((sh, sw, 3), np.float32)
    y0 = (sh - img.shape[0]) // 2
    x0 = (sw - img.shape[1]) // 2
    canvas[y0 : y0 + img.shape[0], x0 : x0 + img.shape[1]] = (
        img if img.ndim == 3 else img[:, :, None]
    )
    if config["vshift"] or config["hshift"]:
        canvas = shift_with_pad(canvas, (config["vshift"], config["hshift"]), axis=(0, 1))
    canvas *= config["brightness"] / 100.0

    out = os.path.join(config["run_dir"], "display.png")
    save_image(canvas, out, normalize=False)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
