"""Benchmark sweep app (the port of ``scripts/eval/benchmark_recon.py``):
algorithms x iteration counts -> ``results.json`` and metric-against-
iteration curves.

    python -m lenslesspicam_tpu_torch.scripts.eval.benchmark_recon \
        algorithms=[ADMM,FISTA] n_iter_range=[5,100]

Reads ``configs/benchmark.yaml``.  The optional LPIPS checkpoints
(``lpips_vgg_weights`` / ``lpips_alex_weights``) go through
``eval.lpips.metric_from_weights`` on the app's device.
"""

import json
import os

import numpy as np

from .._common import app, config_path

_CONFIG = config_path("benchmark.yaml")

# Literature baselines hardcoded for comparison
# (reference scripts/eval/benchmark_recon.py:381-414, Monakhova et al. 2019)
BASELINES = {
    "ADMM_Monakhova2019_100iter": {"MSE": 0.0622, "LPIPS_Alex": 0.5711, "ReconstructionError": 13.62},
    "ADMM_Monakhova2019_5iter": {"MSE": 0.1041, "LPIPS_Alex": 0.6309, "ReconstructionError": 11.32},
    "Le-ADMM_Monakhova2019": {"MSE": 0.0618, "LPIPS_Alex": 0.4434, "ReconstructionError": 13.70},
    "Le-ADMM-U_Monakhova2019": {"MSE": 0.0074, "LPIPS_Alex": 0.1904, "ReconstructionError": 22.14},
}


def _get_batches(config, device):
    from ...data.datasets import get_dataset, simulate_dataset

    if config.dataset == "simulated":
        rng = np.random.RandomState(0)
        psf = rng.rand(1, 64, 96, 3).astype(np.float32)
        psf /= np.linalg.norm(psf)
        ds = simulate_dataset({"dataset": "random", "n_files": config.n_files}, psf=psf,
                              device=device)
    else:
        ds = get_dataset(config.dataset, split="test",
                         downsample=config.downsample, device=device)
        psf = ds.psf
    batches = list(ds.batches(batch_size=config.batchsize))
    return psf, batches, ds


@app(_CONFIG)
def main(config, device):
    from ... import ADMM, FISTA, GradientDescent, NesterovGradientDescent
    from ...eval.benchmark import benchmark

    psf, batches, ds = _get_batches(config, device)

    # optional perceptual metrics from pretrained checkpoints (LPIPS_Alex:
    # the literature baselines' backbone, reference
    # scripts/eval/benchmark_recon.py:387-414)
    lpips_fns = {}
    for net, cfg_key in (("vgg", "lpips_vgg_weights"),
                         ("alex", "lpips_alex_weights")):
        path = getattr(config, cfg_key, None)
        if path and os.path.exists(str(path)):
            from ...eval.lpips import metric_from_weights

            lpips_fns[net] = metric_from_weights(str(path), net=net, device=device)
        elif path:
            print(f"{cfg_key}={path} not found; skipping LPIPS-{net}")

    algo_map = {
        "ADMM": lambda: ADMM(psf, mu1=float(config.admm.mu1),
                             mu2=float(config.admm.mu2),
                             mu3=float(config.admm.mu3),
                             tau=float(config.admm.tau), device=device),
        "FISTA": lambda: FISTA(psf, device=device),
        "GradientDescent": lambda: GradientDescent(psf, device=device),
        "NesterovGradientDescent": lambda: NesterovGradientDescent(psf, device=device),
    }

    results = {}
    for algo_name in config.algorithms:
        recon = algo_map[algo_name]()
        results[algo_name] = {}
        for n_iter in config.n_iter_range:
            res = benchmark(
                lambda lensless: recon.batch_apply(lensless, n_iter=n_iter),
                batches, snr=config.snr,
                lpips_fn=lpips_fns.get("vgg"),
                lpips_alex_fn=lpips_fns.get("alex"),
                device=device,
            )
            results[algo_name][int(n_iter)] = res
            print(f"{algo_name} n_iter={n_iter}: {res}")

    out_fp = os.path.join(config.run_dir, "results.json")
    with open(out_fp, "w") as f:
        json.dump({"results": results, "baselines": BASELINES}, f, indent=2)
    print(f"saved {out_fp}")

    # metric-against-iteration curves
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for metric in ("MSE", "PSNR", "SSIM"):
            fig, ax = plt.subplots()
            for algo_name, sweeps in results.items():
                iters = sorted(sweeps)
                ax.plot(iters, [sweeps[i][metric] for i in iters], marker="o",
                        label=algo_name)
            ax.set_xlabel("iterations")
            ax.set_ylabel(metric)
            ax.set_xscale("log")
            ax.legend()
            fig.savefig(os.path.join(config.run_dir, f"{metric}.png"))
    except Exception as e:  # plotting is best-effort
        print(f"plotting skipped: {e}")
    return results


if __name__ == "__main__":
    main()
