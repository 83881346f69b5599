"""Compare a saved reconstruction (.npy) with the original image (the port
of ``scripts/eval/compute_metrics_from_original.py``).

Extracts the matching region (crop and rotation, ``eval.metric.extract``),
prints MSE / PSNR / SSIM (and LPIPS when its weights are available) and
plots both side by side.  The figure is best-effort, as ``benchmark_recon``'s
curves are: without matplotlib the app prints that it skipped the figure
and still returns the metrics (the JAX app needs matplotlib to start).

    python -m lenslesspicam_tpu_torch.scripts.eval.compute_metrics_from_original \
        files.recon=recon.npy files.original=original.png
"""

import os

import numpy as np

from .._common import app

_DEFAULTS = {
    "files": {"recon": None, "original": None},
    "alignment": {"vertical_crop": None, "horizontal_crop": None,
                  "rotation": 0},
    "verbose": True,
    "output_dir": "outputs",
}


@app(None)
def compute_metrics(config, device):
    for k, v in _DEFAULTS.items():
        if isinstance(v, dict):
            config.setdefault(k, {})
            for kk, vv in v.items():
                config[k].setdefault(kk, vv)
        else:
            config.setdefault(k, v)
    from ...data.io import load_image
    from ...eval.metric import extract, lpips, mse, psnr, ssim
    from ...utils.plot import plot_image

    recon_fp = config["files"]["recon"]
    original_fp = config["files"]["original"]
    assert recon_fp and os.path.exists(recon_fp), "set files.recon=<npy>"
    assert original_fp and os.path.exists(original_fp), "set files.original=<img>"

    est = np.load(recon_fp)
    if config["verbose"]:
        print("estimate shape", est.shape)
    img = load_image(original_fp)
    img = img / img.max()

    al = config["alignment"]
    vc = tuple(int(v) for v in al["vertical_crop"]) if al["vertical_crop"] \
        else (0, est.shape[-3 if est.ndim > 2 else 0])
    hc = tuple(int(v) for v in al["horizontal_crop"]) if al["horizontal_crop"] \
        else (0, est.shape[-2 if est.ndim > 2 else 1])
    est, img_resize = extract(est, img, vc, hc, float(al["rotation"]),
                              verbose=config["verbose"])

    scores = {"MSE": float(mse(img_resize, est)), "PSNR": float(psnr(img_resize, est))}
    print("\nMSE", scores["MSE"])
    print("PSNR", scores["PSNR"])
    channel_axis = 2 if np.squeeze(est).ndim == 3 else None
    scores["SSIM"] = float(ssim(img_resize, est, channel_axis=channel_axis, device=device))
    print("SSIM", scores["SSIM"])
    try:
        scores["LPIPS"] = float(lpips(img_resize, est, device=device))
        print("LPIPS", scores["LPIPS"])
    except RuntimeError as e:      # no LPIPS weights given
        print(f"LPIPS unavailable ({e})")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"comparison plot skipped: {e}")
        return scores
    _, ax = plt.subplots(ncols=2, figsize=(10, 5))
    plot_image(est, ax=ax[0]).set_title("Reconstruction")
    plot_image(img_resize, ax=ax[1]).set_title("Original")
    save = os.path.join(config["run_dir"], "comparison.png")
    plt.savefig(save)
    plt.close("all")
    print(f"Save comparison to {save}")
    return scores


if __name__ == "__main__":
    compute_metrics()
