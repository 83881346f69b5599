"""In-loop kernel times of the port's solvers on one card.

    python3 profile_solver.py [--solver rsplit|rsplit_v2|split|pallas|rgb|batch4|spatial|
                                        spatial_pallas|learned|train]
                              [--mode bench|f32] [--n 20]

Builds the port's kernels, makes the 12 MP certification measurement of
``chip_smoke.py`` (seed 0), runs one solve to warm up and traces a second
solve of ``--n`` iterations with ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON line: for every CUDA kernel its device time
in all and per call and its number of calls; the sum over kernels, split
into the port's own CUDA kernels (``port_us``) and PyTorch's (``torch_us``:
the state algebra, casts, copies, ``dc_patch``'s FFTs; NCCL's kernels
among them, also apart as ``nccl_us``); the traced
window's wall time and the device's busy share of it (the sum over the
window); per iteration the bytes that PyTorch's operations read and write
(``torch_bytes_per_iter``, counted by a dispatch mode over a 1- and a
2-iteration solve: each tensor input read once, each output written once,
views and allocations nothing); the solver's it/s by the difference method
(``chip_smoke.rate``); and the card's name and power limit.

``--solver rsplit`` is the half-spectrum ``run_rsplit`` (v3 placement),
``rsplit_v2`` the same solver in the v2 placement (K8, K4, K5, K4, K9), ``split`` the
full-width ``run_split(backend="fused")``, ``pallas`` the full-width
``run_split(backend="pallas")``, ``rgb`` and ``batch4`` the JAX bench's RGB
(3 planes) and gray batch=4 rungs through ``run_rsplit_general`` (always
in the headline mode), ``spatial`` and ``spatial_pallas`` the loop of
``parallel/spatial.py``'s rpallas and pallas backends over a one-rank NCCL
group at f32 (``--mode f32``; its host precompute and placement before the
trace, the final gather not in it); ``--mode bench`` runs a solver in the storage modes
the JAX bench's headline environment gives it (bf16 spectra, int16
carries; the full-width fused path keeps f32 TV carries, the pallas path
has no carries), ``f32`` at f32.  The ``rsplit``, ``rsplit_v2``, ``split``,
``rgb`` and ``batch4`` solvers use only package API that they have had
since they landed, so the script also times an older checkout: run it
from that checkout's root.  ``--solver learned`` traces ``--n`` forward
calls of ``chip_smoke.py``'s learned serving model (the zoo's
``Unet4M+U5+Unet4M`` on seeded weights, a batch of 4 DiffuserCam
measurements, 270 x 480 x 3, ``eval()``, ``torch.inference_mode()``, TF32
off; no kernel of the port is built or launched) and adds the device time
by group (``groups``: cuDNN's layout transposes, its convolutions, cuFFT's
transforms, the rest), the convolutions' operations per call counted from
their shapes (2 per multiply-add) and their time at the card's f32 peak,
and images/s; its it/s are forward calls per second.  ``--solver train``
traces ``--n`` steps of ``chip_smoke.py``'s train rung (``Trainer.train_step``
on the JAX bench's model and batch, TF32 off, after two warm-up steps) with
the same groups plus the optimizer's (``optimizer``: Adam's and the clip's
elementwise kernels), and times each stage of a step with CUDA events, the
median over ``--n`` steps: the forward and the loss with the autograd graph
(``forward_ms``), ``loss_and_grads`` (``forward_backward_ms``; the backward is
the difference) and ``apply_grads`` (``update_ms``); its it/s are steps per
second.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as cs
from lenslesspicam_tpu_torch.ops import _build
from lenslesspicam_tpu_torch.ops.fft_conv import FFTConvolver
from lenslesspicam_tpu_torch.recon import admm_split

HEADLINE = dict(io="bf16", carry_tv="i16", carry_v="i16")
MODES = {("rsplit", "bench"): HEADLINE, ("rsplit_v2", "bench"): HEADLINE,
         ("split", "bench"): dict(io="bf16", carry_tv="f32", carry_v="i16"),
         ("pallas", "bench"): dict(io="bf16"),
         ("rgb", "bench"): HEADLINE, ("batch4", "bench"): HEADLINE,
         ("rsplit", "f32"): {}, ("rsplit_v2", "f32"): {}, ("split", "f32"): {},
         ("pallas", "f32"): {}, ("spatial", "f32"): {}, ("spatial_pallas", "f32"): {}}


def device_time_us(evt) -> float:
    """An event's device time in microseconds, under the attribute names of
    either profiler generation."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# a kernel's name after ``__global__ void`` and its launch bounds, whose
# arguments may hold one level of parentheses (a constexpr call)
KERNEL_DECL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")


def port_kernel_names() -> set:
    """The names of the port's own CUDA kernels, from its sources and
    headers."""
    names = set()
    for path in (*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")):
        names.update(KERNEL_DECL.findall(path.read_text()))
    return names


class ByteCount(TorchDispatchMode):
    """Counts the bytes that the aten operations run under it read and
    write: each tensor input once (an ``out=`` tensor is not read), each
    output once; views and ``empty`` allocations move nothing.  The port's
    CUDA kernels run through ``ctypes`` and are not seen."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if not (func.is_view or name.startswith("empty")):
            ins = [a for a in (*args, *(v for k, v in kwargs.items() if k != "out"))
                   if isinstance(a, torch.Tensor)]
            outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                    if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def measurement(solver, scene, psf2d):
    """The solver's measurement: gray (H, W), or the bench rung's (B, 1,
    H, W, C) planes scaled per plane and normalized per plane, as
    ``chip_smoke.mode_phase`` makes them; with the PSF it takes."""
    if solver not in ("rgb", "batch4"):
        fwd = FFTConvolver.from_psf(psf2d[None, :, :, None], pad=True, norm="backward")
        meas = fwd.convolve(torch.from_numpy(scene)[None, None, :, :, None].to("cuda"))
        return (meas / meas.max().clamp_min(1e-9))[0, 0, :, :, 0].cpu().numpy(), psf2d
    ch, b = (3, 1) if solver == "rgb" else (1, 4)
    scales = np.linspace(1.0, 0.55, b * ch).astype(np.float32)
    scenes = np.stack([scene * s for s in scales]).reshape(b, ch, *cs.SENSOR).transpose(0, 2, 3, 1)
    psf = np.repeat(psf2d[None, :, :, None], ch, axis=-1)
    fwd = FFTConvolver.from_psf(psf, pad=True, norm="backward")
    meas = fwd.convolve(torch.from_numpy(np.ascontiguousarray(scenes[:, None])).to("cuda"))
    meas = meas / meas.amax(dim=(-3, -2), keepdim=True).clamp_min(1e-9)
    return meas.cpu().numpy(), psf


# device kernels by what computes them, from their names: cuDNN's layout
# transposes around its convolutions, its convolutions (implicit GEMM,
# the transposed convolutions' dgrad engine), cuFFT's transforms
OPTIMIZER_GROUP = ("optimizer", re.compile(r"multi_tensor|adam|foreach", re.I))
KERNEL_GROUPS = (("layout", re.compile(r"nhwcToNchw|nchwToNhwc", re.I)),
                 ("convolution", re.compile(r"conv|cudnn|xmma|winograd|implicit|fprop", re.I)),
                 ("fft", re.compile(r"fft", re.I)))


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def profile_learned(n):
    """Trace ``n`` forward calls of the learned serving model (module
    docstring); print one JSON line."""
    from lenslesspicam_tpu_torch.zoo.model_dict import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = cs.learned_model(build_model(cs.LEARNED_NAME))
    psf, data, _ = cs.learned_inputs(cs.DIFFUSERCAM, cs.LEARNED_BATCH)
    psf, data = torch.from_numpy(psf).cuda(), torch.from_numpy(data).cuda()

    def forward(k):
        for _ in range(k):
            model(data, psf)

    flops = [0]

    def count(mod, inputs, out):    # 2 x multiply-adds of one call, from its shapes
        k = mod.weight[0].numel()        # (in / groups) * kH * kW, or out / groups * kH * kW
        flops[0] += 2 * k * (out.numel() if isinstance(mod, torch.nn.Conv2d)
                             else inputs[0].numel())

    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d,
                                                           torch.nn.ConvTranspose2d))]
    hooks = [m.register_forward_hook(count) for m in convs]
    with torch.inference_mode():
        forward(1)
    for h in hooks:
        h.remove()
    with torch.inference_mode():
        forward(2)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            forward(n)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        calls = cs.rate(forward, base=1, full=6, pairs=3)
    kernels, groups = kernel_groups(prof, KERNEL_GROUPS)
    total = sum(k["us"] for k in kernels.values())
    print(json.dumps({"solver": "learned", "model": cs.LEARNED_NAME,
                      "grid": [*cs.DIFFUSERCAM, 3], "batch": cs.LEARNED_BATCH, "forward_calls": n,
                      "kernels": kernels, "kernel_us": total, "groups": groups,
                      "group_share": {g: us / total for g, us in groups.items()} if total else None,
                      "kernel_us_per_call": total / n, "conv_flops_per_call": flops[0],
                      "conv_bound_us_per_call": flops[0] / cs.F32_FLOP_PER_S * 1e6,
                      "wall_us": wall_us,
                      "busy_share": total / wall_us if wall_us else None, "it_per_s": calls,
                      "images_per_s": calls["median"] * cs.LEARNED_BATCH,
                      "card": card_name()}), flush=True)
    return 0


def kernel_groups(prof, groups_rx):
    """Device time by kernel and by group of a finished trace."""
    kernels = {}
    groups = dict.fromkeys([g for g, _ in groups_rx] + ["other"], 0.0)
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = device_time_us(evt)
            kernels[evt.key] = {"us": us, "calls": evt.count, "us_per_call": us / max(evt.count, 1)}
            groups[next((g for g, rx in groups_rx if rx.search(evt.key)), "other")] += us
    return kernels, groups


def profile_train(n):
    """Trace ``n`` steps of the train rung (module docstring); print one
    JSON line."""
    from lenslesspicam_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    psf, batch = cs.train_inputs()
    trainer = Trainer(cs.train_model("cuda"), psf, lambda: iter([batch]), [batch],
                      TrainerConfig(epochs=1, lr=1e-4), device="cuda")
    data, lensed = (torch.from_numpy(batch[k]).cuda() for k in ("lensless", "lensed"))
    psf_t = torch.from_numpy(psf).cuda()

    def steps(k):
        for _ in range(k):
            trainer.train_step(batch)

    def forward():
        trainer.model.train()
        return trainer._loss(trainer.model(data, psf_t), lensed, psf_t, None)

    def stage_ms(fn):
        out = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return float(np.median(out))

    steps(2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, groups = kernel_groups(prof, (OPTIMIZER_GROUP, *KERNEL_GROUPS))
    total = sum(k["us"] for k in kernels.values())
    grads = trainer.loss_and_grads(batch)[1]
    stages = {"forward_ms": stage_ms(forward),
              "forward_backward_ms": stage_ms(lambda: trainer.loss_and_grads(batch)),
              "update_ms": stage_ms(lambda: trainer.apply_grads(grads))}
    stages["backward_ms"] = stages["forward_backward_ms"] - stages["forward_ms"]
    print(json.dumps({"solver": "train", "grid": [*cs.TRAIN_GRID, 3], "batch": cs.TRAIN_BATCH,
                      "steps": n, "kernels": kernels, "kernel_us": total, "groups": groups,
                      "group_share": {g: us / total for g, us in groups.items()} if total else None,
                      "kernel_us_per_step": total / n, "stages": stages, "wall_us": wall_us,
                      "busy_share": total / wall_us if wall_us else None,
                      "it_per_s": cs.rate(steps, base=1, full=6, pairs=3),
                      "card": card_name()}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver",
                    choices=("rsplit", "rsplit_v2", "split", "pallas", "rgb", "batch4",
                             "spatial", "spatial_pallas", "learned", "train"),
                    default="rsplit")
    ap.add_argument("--mode", choices=("bench", "f32"), default="bench")
    ap.add_argument("--n", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_solver: no CUDA device", file=sys.stderr)
        return 1
    if args.solver == "learned":
        return profile_learned(args.n)
    if args.solver == "train":
        return profile_train(args.n)
    if (args.solver, args.mode) not in MODES:
        print(f"profile_solver: {args.solver} does not run in the {args.mode} mode",
              file=sys.stderr)
        return 2
    _build.build_all()
    scene, psf2d = cs.cert_scene_psf(cs.SENSOR, np.random.RandomState(0))
    meas, psf = measurement(args.solver, scene, psf2d)
    modes = MODES[(args.solver, args.mode)]
    if args.solver in ("rsplit", "rsplit_v2"):
        pre = admm_split.precompute_rsplit(psf, meas)
        placement = "v2" if args.solver == "rsplit_v2" else "v3"

        def solve(k):
            return admm_split.run_rsplit(pre, n_iter=k, placement=placement, **modes)
    elif args.solver in ("spatial", "spatial_pallas"):
        from lenslesspicam_tpu_torch.parallel import distributed as pdist, spatial
        from lenslesspicam_tpu_torch.recon import admm

        pdist.initialize(device="cuda")
        mesh = pdist.multihost_mesh(("sp",))
        conv = admm.make_convolver(psf[None, :, :, None], pad_policy="tpu")
        ph, pw = conv.padded_shape[1:3]
        data5 = torch.from_numpy(meas).to("cuda")[None, None, :, :, None]
        params = admm.ADMMParams()
        if args.solver == "spatial":
            inputs = spatial._rpallas_inputs(mesh, conv, data5, params)

            def solve(k):
                return spatial._build_rpallas_run(mesh, ph, pw, params, k)(*inputs)
        else:
            inputs = spatial._pallas_inputs(mesh, conv, data5, params)

            def solve(k):
                return spatial._build_pallas_run(mesh, ph, params, k)(*inputs)
    elif args.solver in ("rgb", "batch4"):
        pre, info = admm_split.precompute_rsplit_general(psf, meas)
        meas_t = torch.from_numpy(meas).to("cuda")

        def solve(k):
            return admm_split.run_rsplit_general(pre, info, meas_t, n_iter=k, **modes)
    else:
        pre = admm_split.precompute_split(psf, meas)
        backend = "fused" if args.solver == "split" else "pallas"

        def solve(k):
            return admm_split.run_split(pre, n_iter=k, backend=backend, **modes)

    solve(args.n)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve(args.n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    own = port_kernel_names()
    kernels, port_us = {}, 0.0
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = device_time_us(evt)
            kernels[evt.key] = {"us": us, "calls": evt.count, "us_per_call": us / max(evt.count, 1)}
            if any(re.search(rf"\b{n}\b", evt.key) for n in own):
                port_us += us
    total = sum(k["us"] for k in kernels.values())
    nccl_us = sum(k["us"] for name, k in kernels.items() if "nccl" in name.lower())
    counted = []
    for k in (1, 2):
        with ByteCount() as bc:
            solve(k)
        counted.append(bc.bytes)
    smi = card_name()
    print(json.dumps({"solver": args.solver, "mode": args.mode, "modes": modes,
                      "n_iter": args.n, "grid": list(cs.SENSOR), "kernels": kernels,
                      "kernel_us": total, "port_us": port_us, "torch_us": total - port_us,
                      "nccl_us": nccl_us,
                      "torch_us_per_iter": (total - port_us) / args.n,
                      "torch_bytes_per_iter": counted[1] - counted[0],
                      "wall_us": wall_us, "busy_share": total / wall_us if wall_us else None,
                      "it_per_s": cs.rate(solve), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
