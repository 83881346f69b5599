"""In-loop kernel times of the port's fused solvers on one card.

    python3 profile_solver.py [--solver rsplit|split] [--mode bench|f32] [--n 20]

Builds the port's kernels, makes the 12 MP certification measurement of
``chip_smoke.py`` (seed 0), runs one solve to warm up and traces a second
solve of ``--n`` iterations with ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON line: for every CUDA kernel its device time
in all and per call and its number of calls, the sum over kernels, the
traced window's wall time and the device's busy share of it (the sum over
the window), the solver's it/s by the difference method
(``chip_smoke.rate``), and the card's name and power limit.  ``--solver
rsplit`` is the half-spectrum ``run_rsplit``, ``split`` the full-width
``run_split(backend="fused")``; ``--mode bench`` runs either in the
storage modes the JAX bench's headline environment gives it (bf16
spectra, int16 carries; the full-width path keeps f32 TV carries),
``f32`` at f32.  It
imports only the package API that both solvers have had since they
landed, so it also times an older checkout: run it from that checkout's
root.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from lenslesspicam_tpu_torch.ops import _build
from lenslesspicam_tpu_torch.ops.fft_conv import FFTConvolver
from lenslesspicam_tpu_torch.recon import admm_split

MODES = {("rsplit", "bench"): dict(io="bf16", carry_tv="i16", carry_v="i16"),
         ("split", "bench"): dict(io="bf16", carry_tv="f32", carry_v="i16"),
         ("rsplit", "f32"): {}, ("split", "f32"): {}}


def device_time_us(evt) -> float:
    """An event's device time in microseconds, under the attribute names of
    either profiler generation."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", choices=("rsplit", "split"), default="rsplit")
    ap.add_argument("--mode", choices=("bench", "f32"), default="bench")
    ap.add_argument("--n", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_solver: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    scene, psf2d = cs.cert_scene_psf(cs.SENSOR, np.random.RandomState(0))
    fwd = FFTConvolver.from_psf(psf2d[None, :, :, None], pad=True, norm="backward")
    meas = fwd.convolve(torch.from_numpy(scene)[None, None, :, :, None].to("cuda"))
    meas = (meas / meas.max().clamp_min(1e-9))[0, 0, :, :, 0].cpu().numpy()
    del fwd
    modes = MODES[(args.solver, args.mode)]
    if args.solver == "rsplit":
        pre = admm_split.precompute_rsplit(psf2d, meas)

        def solve(k):
            return admm_split.run_rsplit(pre, n_iter=k, **modes)
    else:
        pre = admm_split.precompute_split(psf2d, meas)

        def solve(k):
            return admm_split.run_split(pre, n_iter=k, backend="fused", **modes)

    solve(args.n)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve(args.n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = device_time_us(evt)
            kernels[evt.key] = {"us": us, "calls": evt.count, "us_per_call": us / max(evt.count, 1)}
    total = sum(k["us"] for k in kernels.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"solver": args.solver, "mode": args.mode, "modes": modes,
                      "n_iter": args.n,
                      "grid": list(cs.SENSOR), "kernels": kernels, "kernel_us": total,
                      "wall_us": wall_us, "busy_share": total / wall_us if wall_us else None,
                      "it_per_s": cs.rate(solve), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
