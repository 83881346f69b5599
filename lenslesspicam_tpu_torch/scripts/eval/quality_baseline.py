"""Offline quality-baseline harness (the port of
``scripts/eval/quality_baseline.py``): an iteration sweep of
reconstructions of simulated measurements, written to a results JSON.

The reference's benchmark protocol (its scripts/eval/benchmark_recon.py
and configs/benchmark/defaults.yaml): n_iter over [5, 10, 20, 50, 100,
200, 300] for ADMM, FISTA, GD and Nesterov and the two split-FFT solvers,
MSE / PSNR / SSIM against the ground-truth scene.  The scenes are
deterministic synthetic structures and the PSF a seeded random point
diffuser, as in the JAX app.

``admm_rfused`` runs the fused half-spectrum solver ``run_rsplit_jit``
(f32 storage, placement v3): on the card its kernels K1 ``rfft_w`` once a
solve, K3 ``e1_rtv``, two K4 ``h_passA_pair``, K5 ``fft_h_combine_dual``
and K6 ``irfft_w_dual_state`` each iteration.  ``admm_split`` runs
``run_split_jit`` with its default backend ``"jax"``, the plain loop, as
the JAX app does.

Two differences from the JAX app, both on purpose:

* no entry of the sweep is skipped: the JAX app catches every exception of
  a solve and prints it as skipped (a catch for optional backends), which
  would hide a kernel that fails on the card; every algorithm exists in
  the port, so a failure raises;
* ``--out`` defaults to ``outputs/quality_baseline_torch.json``; the JAX
  app's committed baseline under ``benchmarks/`` is its own.

    python -m lenslesspicam_tpu_torch.scripts.eval.quality_baseline [--out PATH] [--quick]
"""

import argparse
import json
import os
import sys

import numpy as np

from .._common import app_device

N_ITER_SWEEP = [5, 10, 20, 50, 100, 200, 300]
SHAPE = (96, 128)
ALGOS = ["admm", "fista", "gd", "nesterov", "admm_split", "admm_rfused"]


def make_scenes(shape=SHAPE):
    """Deterministic structured test scenes in [0, 1]."""
    h, w = shape
    rects = np.zeros((h, w), np.float32)
    rects[20:40, 30:60] = 1.0
    rects[50:80, 70:110] = 0.6
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blobs = (np.exp(-((yy - 30) ** 2 + (xx - 40) ** 2) / 150.0)
             + 0.7 * np.exp(-((yy - 70) ** 2 + (xx - 90) ** 2) / 400.0)
             + 0.15 * np.sin(xx / 3.0) * np.sin(yy / 4.0) + 0.15)
    blobs = (blobs / blobs.max()).astype(np.float32)
    # "grid": thin lines and point sources, for the TV's edges
    grid = np.zeros((h, w), np.float32)
    grid[::12, :] = 0.5
    grid[:, ::16] = 0.5
    rng = np.random.RandomState(3)
    pys, pxs = rng.randint(4, h - 4, 12), rng.randint(4, w - 4, 12)
    grid[pys, pxs] = 1.0
    return {"rects": rects, "blobs": blobs, "grid": grid}


def make_psf(shape=SHAPE, seed=0):
    rng = np.random.RandomState(seed)
    h, w = shape
    psf = np.zeros((h, w), np.float32)
    ys, xs = rng.randint(0, h, 200), rng.randint(0, w, 200)
    psf[ys, xs] = rng.rand(200)
    psf /= np.linalg.norm(psf)
    return psf


def simulate(scene, psf, device=None):
    """Noiseless forward measurement (padded circular convolution),
    max-normalized like the reference's data loading."""
    import torch

    from ..._device import as_host
    from ...ops.fft_conv import FFTConvolver

    device = app_device(device)
    fwd = FFTConvolver.from_psf(psf[None, :, :, None], pad=True, norm="backward",
                                device=device)
    meas = as_host(fwd.convolve(torch.from_numpy(
        scene[None, None, :, :, None]).to(device))).squeeze()
    return (meas / meas.max()).astype(np.float32)


def reconstruct(algo, psf, meas, n_iter, device=None):
    from ..._device import as_host
    from ...recon import admm, admm_split, gd

    device = app_device(device)
    psf4 = psf[None, :, :, None]
    data5 = meas[None, None, :, :, None]
    if algo == "admm":
        conv = admm.make_convolver(psf4, device=device)
        return as_host(admm.run_jit(conv, data5, n_iter=n_iter))[0, 0, :, :, 0]
    if algo in ("fista", "gd", "nesterov"):
        method = {"gd": "vanilla"}.get(algo, algo)
        conv = gd.make_convolver(psf4, device=device)
        return as_host(gd.run(conv, psf4, data5, n_iter=n_iter, method=method))[0, 0, :, :, 0]
    if algo == "admm_split":
        pre = admm_split.precompute_split(psf, meas, device=device)
        return as_host(admm_split.run_split_jit(pre, n_iter=n_iter))
    if algo == "admm_rfused":
        pre = admm_split.precompute_rsplit(psf, meas, device=device)
        return as_host(admm_split.run_rsplit_jit(pre, n_iter=n_iter))
    raise ValueError(algo)


def metrics_of(scene, est, device=None):
    from ...eval import metric

    t = scene[:, :, None]
    e = np.asarray(est, np.float32)[:, :, None]
    return {
        "mse": float(metric.mse(t, e)),
        "psnr": float(metric.psnr(t, e)),
        "ssim": float(metric.ssim(t, e, device=app_device(device))),
    }


def run_sweep(algos=None, scenes=None, sweep=None, device=None):
    """``{scene: {algo: {str(n): metrics}}}``; a solve that fails raises."""
    device = app_device(device)
    scenes = scenes or make_scenes()
    psf = make_psf()
    algos = algos or ALGOS
    sweep = sweep or N_ITER_SWEEP
    results = {}
    for sname, scene in scenes.items():
        meas = simulate(scene, psf, device)
        results[sname] = {}
        for algo in algos:
            results[sname][algo] = {}
            for n in sweep:
                est = reconstruct(algo, psf, meas, n, device)
                m = metrics_of(scene, est, device)
                results[sname][algo][str(n)] = m
                print(f"{sname:6s} {algo:12s} n={n:3d}  "
                      f"PSNR {m['psnr']:6.2f}  SSIM {m['ssim']:.4f}",
                      file=sys.stderr)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("outputs", "quality_baseline_torch.json"))
    ap.add_argument("--quick", action="store_true",
                    help="one scene, short sweep (smoke run)")
    args = ap.parse_args(argv)
    device = app_device()

    if args.quick:
        results = run_sweep(algos=["admm", "fista"],
                            scenes={"rects": make_scenes()["rects"]},
                            sweep=[5, 20], device=device)
    else:
        results = run_sweep(device=device)

    payload = {
        "protocol": {
            "n_iter_sweep": N_ITER_SWEEP,
            "shape": list(SHAPE),
            "psf": "seeded 200-point random diffuser (seed 0)",
            "admm_params": "mu1=1e-6 mu2=1e-5 mu3=4e-5 tau=1e-4 "
                           "(reference defaults, lensless/recon/admm.py:39-42)",
            "reference_protocol":
                "scripts/eval/benchmark_recon.py:381-414 + "
                "configs/benchmark/defaults.yaml:34",
            "device": str(device),
        },
        "results": results,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
