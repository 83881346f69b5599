"""The PSF-error robustness sweep of DigiCam reconstructions (the port of
``scripts/recon/digicam_mirflickr_psf_err.py``).

For each test sample: perturb a growing share of the programmable mask's
pixels (flip them, or draw them anew from a uniform), simulate the PSF of
the corrupted pattern on the app's device (``AdafruitLCD`` through
``test_set.simulate_psf``), reconstruct with it, and record the PSF error
and PSNR / SSIM (and LPIPS when its weights are given) against the ground
truth.  Plots each metric against the key-error ratio.  ``metrics_fp=<json>``
skips the sweep and plots stored metrics.

    python -m lenslesspicam_tpu_torch.scripts.recon.digicam_mirflickr_psf_err \
        model=admm n_files=10

Reads ``configs/recon_psf_err.yaml``; writes ``metrics.json`` and returns
the metrics (lists of ``(n_percents, n_files)``).  Deliberate differences:
the plots are best-effort: ``metrics.json`` is written first, and when
matplotlib cannot be imported (the CUDA machine has none) the app prints
that it skips the plots.  Only the ``ImportError`` of ``import matplotlib``
is caught, so a fault in the plotting itself still raises; the JAX app
needs matplotlib to finish.  The LPIPS catch is ``RuntimeError`` (no
weights given: the entry is NaN), where the JAX app turns any exception
into NaN.
"""

import json
import os

import numpy as np

from .._common import app, config_path

_CONFIG = config_path("recon_psf_err.yaml")


def key_to_ratio_correct(key_length, bit_depth, n_pixel):
    """Mask-pixel error rate <-> key-error ratio conversion
    (reference digicam_mirflickr_psf_err.py:17-18)."""
    return np.emath.logn(bit_depth, 2) * key_length / n_pixel


def run_sweep(test_set, build_recon_fn, percent_pixels_wrong, n_files=None, flip=True,
              seed=0, save_idx=(), run_dir=".", verbose=True, device=None):
    """The sweep over any multimask dataset with ``get_mask_vals``,
    ``simulate_psf`` and ``extract_roi``.  ``build_recon_fn(psf) -> recon``
    where ``recon(lensless)`` returns a (B, D, H, W, C) reconstruction;
    the metrics run on ``device`` (None: the app's device).  Returns the
    metrics dict of ``(n_percents, n_files)`` lists."""
    from ..._device import as_host
    from ...data.io import save_image
    from ...eval import metric
    from .._common import app_device

    device = app_device(device)
    assert getattr(test_set, "multimask", False), (
        "PSF-error sweep needs a multimask dataset (per-sample patterns)")
    rng = np.random.RandomState(seed)
    if n_files is None:
        n_files = len(test_set)

    psf_norms = {lab: float(np.mean(np.asarray(psf) ** 2)) for lab, psf in test_set.psf.items()}

    names = ["PSNR", "SSIM", "LPIPS_Vgg", "psf_err"]
    metrics_values = {k: np.zeros((len(percent_pixels_wrong), n_files)) for k in names}

    for idx in range(n_files):
        sample = test_set[idx]
        lensless, lensed = sample[0], sample[1]
        if len(sample) > 2:
            mask_label = int(np.asarray(sample[-1]))
        else:
            mask_label = int(np.asarray(test_set.extra_fields(idx)["mask_label"]))
        lensless = np.asarray(lensless)
        truth = np.squeeze(np.asarray(lensed))
        truth = truth / max(truth.max(), 1e-12)

        if idx in save_idx:
            os.makedirs(os.path.join(run_dir, str(idx)), exist_ok=True)
            save_image(truth, os.path.join(run_dir, str(idx), f"original_idx{idx}.png"))
            save_image(np.squeeze(lensless),
                       os.path.join(run_dir, str(idx), f"lensless_idx{idx}.png"))

        mask_vals = np.asarray(test_set.get_mask_vals(mask_label), np.float32)
        clean_psf = np.asarray(test_set.psf[mask_label])

        for pi, percent_wrong in enumerate(percent_pixels_wrong):
            noisy = mask_vals.copy()
            if percent_wrong > 0:
                n_pixels = noisy.size
                n_wrong = int(n_pixels * percent_wrong / 100)
                wrong = rng.choice(n_pixels, n_wrong, replace=False)
                flat = noisy.reshape(-1)
                if flip:
                    flat[wrong] = 1.0 - flat[wrong]
                else:
                    flat[wrong] = rng.uniform(size=n_wrong)
                noisy = flat.reshape(mask_vals.shape)

            psf = np.asarray(test_set.simulate_psf(noisy), np.float32)
            metrics_values["psf_err"][pi, idx] = (
                float(np.mean((psf - clean_psf) ** 2)) / psf_norms[mask_label])

            recon = build_recon_fn(psf)
            res = as_host(recon(lensless[None]))[0]
            pred = test_set.extract_roi(res, axis=(-3, -2))
            pred = np.squeeze(pred)
            pred = pred / max(pred.max(), 1e-12)

            channel_axis = 2 if truth.ndim == 3 else None
            metrics_values["PSNR"][pi, idx] = float(metric.psnr(truth, pred))
            metrics_values["SSIM"][pi, idx] = float(
                metric.ssim(truth, pred, channel_axis=channel_axis, device=device))
            try:
                metrics_values["LPIPS_Vgg"][pi, idx] = float(
                    metric.lpips(truth, pred, device=device))
            except RuntimeError:  # no LPIPS weights given
                metrics_values["LPIPS_Vgg"][pi, idx] = np.nan

            if idx in save_idx:
                save_image(pred, os.path.join(run_dir, str(idx), f"recon_err{percent_wrong}.png"))
                save_image(psf / psf.max(),
                           os.path.join(run_dir, str(idx), f"psf_err{percent_wrong}.png"))
        if verbose:
            print(f"[{idx + 1}/{n_files}] done")

    return {k: v.tolist() for k, v in metrics_values.items()}


def plot_metrics(metrics_values, percent_pixels_wrong, run_dir, digicam_ratio=None,
                 n_pixel=None):
    """One figure a metric, its mean and spread over the files against the
    share of wrong pixels (or the key-error ratio).  Best-effort: without
    matplotlib it prints that it skips them."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: the metric plots are skipped")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    percents = np.asarray(percent_pixels_wrong, float)
    x = percents / 100.0
    xlabel = "Fraction of mask pixels wrong"
    if digicam_ratio is not None and n_pixel is not None:
        x = key_to_ratio_correct(percents / 100.0 * n_pixel, 2, n_pixel) * digicam_ratio
        xlabel = "Key-error ratio"
    for k, vals in metrics_values.items():
        vals = np.asarray(vals, float)
        fig, ax = plt.subplots()
        mean = np.nanmean(vals, axis=1)
        std = np.nanstd(vals, axis=1)
        ax.errorbar(x[: len(mean)], mean, yerr=std, marker="o")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(k)
        ax.grid()
        fig.savefig(os.path.join(run_dir, f"{k}_vs_psf_err.png"))
        plt.close(fig)


@app(_CONFIG)
def main(config, device):
    from ._pretrained import build_recon, build_test_set, load_bundle

    run_dir = config.run_dir
    percents = [float(p) for p in config.percent_pixels_wrong]

    if config.metrics_fp:
        with open(config.metrics_fp) as f:
            metrics_values = json.load(f)
        plot_metrics(metrics_values, percents, run_dir)
        print(f"plots saved to {run_dir}")
        return metrics_values

    model_name = config.model or "admm"
    model_path, model_config = load_bundle(
        "digicam", config.dataset, model_name, local_model_dir=config.cache_dir)
    test_set = build_test_set(model_config, cache_dir=config.cache_dir,
                              n_files=config.n_files, return_mask_label=True,
                              hf_repo=config.hf_repo, device=device)

    def build_recon_fn(psf):
        return build_recon(model_name, model_path, psf[None] if psf.ndim == 3 else psf,
                           n_iter=int(config.n_iter), device=device)

    metrics_values = run_sweep(
        test_set, build_recon_fn, percents, n_files=config.n_files,
        flip=bool(config.flip), seed=int(config.seed),
        save_idx=set(int(i) for i in (config.save_idx or [])),
        run_dir=run_dir, device=device)

    with open(os.path.join(run_dir, "metrics.json"), "w") as f:
        json.dump(metrics_values, f, indent=4)
    plot_metrics(metrics_values, percents, run_dir)
    print(f"metrics + plots saved to {run_dir}")
    return metrics_values


if __name__ == "__main__":
    main()
