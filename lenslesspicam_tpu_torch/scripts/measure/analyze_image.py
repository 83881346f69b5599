"""Analyze a measured image or PSF (the port of
``scripts/measure/analyze_image.py``).

Modes:

- default: RGB and grayscale views with their pixel histograms;
- ``lens=True``: the PSF of a lensed system, per-channel cross sections
  with their -N dB widths;
- ``lensless=True``: the PSF of a lensless camera, the grayscale and
  per-channel autocorrelations and their -N dB widths;
- ``bayer=True``: raw Bayer data demosaiced and color-corrected with the
  given red and blue gains; ``save=<fp>`` writes the RGB (and 8-bit)
  result.

    python -m lenslesspicam_tpu_torch.scripts.measure.analyze_image fp=psf.png \
        lensless=True gamma=2.2 save_auto=True

Reads the JAX app's ``_DEFAULTS`` (no YAML) and returns None, as the JAX
app does.  Host work only (numpy, OpenCV and matplotlib through
``utils/plot.py``); it keeps the JAX app's hard need for matplotlib, so it
runs where matplotlib is installed (not on the CUDA machine).  Deliberate
difference: matplotlib is imported when the app runs, after the device
check, where the JAX app imports it with the module.
"""

import os

import numpy as np

from .._common import app

_DEFAULTS = {
    "fp": None,
    "gamma": 2.2,
    "width": 3,          # dB drop for width estimation
    "bayer": False,
    "lens": False,
    "lensless": False,
    "bg": None,          # blue gain
    "rg": None,          # red gain
    "plot_width": None,
    "save": None,        # save color-corrected RGB from Bayer
    "save_auto": True,
    "nbits": None,
    "down": 1,
    "back": None,        # background image to subtract
    "output_dir": "outputs",
}


@app(None)
def main(config, device):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ...data.image import gamma_correction, rgb2gray
    from ...data.io import load_image, load_psf, save_image
    from ...utils import plot as P

    for key, val in _DEFAULTS.items():
        config.setdefault(key, val)
    assert config["fp"], "set fp=<image path>"
    fp = config["fp"]
    out_dir = config["run_dir"]
    gamma = config["gamma"]
    width = config["width"]
    plot_width = config["plot_width"]
    nbits = config["nbits"]

    if config["lensless"]:
        img = load_psf(fp, verbose=True, bayer=config["bayer"],
                       blue_gain=config["bg"], red_gain=config["rg"],
                       nbits_out=nbits, return_float=False,
                       downsample=config["down"])[0]
    else:
        img = load_image(fp, verbose=True, bayer=config["bayer"],
                         blue_gain=config["bg"], red_gain=config["rg"],
                         nbits_out=nbits, back=config["back"],
                         downsample=config["down"])
    img = np.asarray(img)
    if nbits is None:
        nbits = int(np.ceil(np.log2(max(img.max(), 2))))

    # RGB view + histogram
    fig_rgb, ax_rgb = plt.subplots(ncols=2, figsize=(15, 5))
    P.plot_image(img, gamma=gamma, ax=ax_rgb[0]).set_title("RGB")
    P.pixel_histogram(img, ax=ax_rgb[1], nbits=nbits).set_title("Histogram")
    fig_rgb.savefig(os.path.join(out_dir, "rgb_analysis.png"))

    # grayscale view + histogram
    ncols = 3 if config["lens"] else 2
    fig_gray, ax_gray = plt.subplots(ncols=ncols, figsize=(15, 5))
    img_grey = np.asarray(rgb2gray(img[None])) if img.ndim == 3 else img
    P.plot_image(img_grey, gamma=gamma, ax=ax_gray[0]).set_title("Grayscale")
    P.pixel_histogram(img_grey, ax=ax_gray[1], nbits=nbits).set_title("Histogram")

    img_grey = np.squeeze(img_grey)
    img = np.squeeze(img)
    fig_auto = None

    if config["lens"]:
        # PSF width via -NdB cross-sections
        P.plot_cross_section(img_grey, color="gray", plot_db_drop=width,
                             ax=ax_gray[2], plot_width=plot_width)
        fig_auto, ax_cross = plt.subplots(ncols=3, figsize=(15, 5))
        for i, c in enumerate(["r", "g", "b"]):
            print(f"-- {c} channel")
            ax, _ = P.plot_cross_section(
                img[:, :, i], color=c, ax=ax_cross[i], plot_db_drop=width,
                max_val=2 ** nbits - 1, plot_width=plot_width)
            if i > 0:
                ax.set_ylabel("")
    elif config["lensless"]:
        # autocorrelation flatness: grayscale + per-channel widths
        fig_auto, ax_auto = plt.subplots(ncols=4, nrows=2, figsize=(15, 5))
        _, autocorr_grey = P.plot_autocorr2d(img_grey, ax=ax_auto[0][0])
        print("-- grayscale")
        P.plot_cross_section(autocorr_grey, color="gray", plot_db_drop=width,
                             ax=ax_auto[1][0], plot_width=plot_width)
        for i, c in enumerate(["r", "g", "b"]):
            _, autocorr_c = P.plot_autocorr2d(img[:, :, i], ax=ax_auto[0][i + 1])
            print(f"-- {c} channel")
            ax, _ = P.plot_cross_section(
                autocorr_c, color=c, ax=ax_auto[1][i + 1],
                plot_db_drop=width, plot_width=plot_width)
            ax.set_ylabel("")

    fig_gray.savefig(os.path.join(out_dir, "grey_analysis.png"))

    if config["bayer"] and config["save"]:
        import cv2

        cv2.imwrite(config["save"], cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2BGR))
        print(f"\nColor-corrected RGB image saved to: {config['save']}")
        vis = img / img.max()
        if gamma:
            vis = gamma_correction(vis, gamma=gamma)
        save_8bit = str(config["save"]).replace(".png", "_8bit.png")
        save_image(vis, save_8bit)
        print(f"8bit version saved to: {save_8bit}")

    if fig_auto is not None and config["save_auto"]:
        auto_fp = os.path.join(out_dir, "autocorrelation.png")
        fig_auto.savefig(auto_fp)
        print(f"\nAutocorrelation saved to: {auto_fp}")
    print(f"saved analysis to {out_dir}")


if __name__ == "__main__":
    main()
