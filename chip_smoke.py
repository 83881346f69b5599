"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card (at the 12 MP
grid and at a small one), reconstructs a 12 MP measurement with the exact
solver and with the fused solver through the kernels, checks that the
fused run went through every kernel, measures both solvers' rates, and
prints one JSON line per phase.  The last line is
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lenslesspicam_tpu_torch.ops import _build, kernels as K
from lenslesspicam_tpu_torch.ops.fft_conv import FFTConvolver
from lenslesspicam_tpu_torch.recon import admm, admm_split
from lenslesspicam_tpu_torch.recon.admm import ADMMParams

SENSOR = (3040, 4056)        # 12 MP, padded to 6144 x 8192
SMALL = (48, 64)             # padded to 96 x 128
TOL_KERNEL = 1e-4            # max |kernel - plain| / max |plain|
TOL_PSNR_DB = 0.1            # |PSNR exact - PSNR fused| at n = 10
TOL_SMALL = 1e-5             # fused vs exact, normalized, small grid, n = 10
TOL_LOOP = 1e-4              # fused loop, kernels vs plain versions, n = 3
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOP_PER_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores

KERNEL_INFO = {   # wrapper -> (label, CUDA source, TPU kernel it replaces)
    "rfft_w": ("K1", "lenslesspicam_tpu_torch/ops/csrc/rfft_w.cu",
               "lenslesspicam_tpu/ops/pallas_kernels2.py:1810"),
    "e1_rtv": ("K3", "lenslesspicam_tpu_torch/ops/csrc/e1_rtv.cu",
               "lenslesspicam_tpu/ops/pallas_kernels2.py:2224"),
    "h_passA_pair": ("K4", "lenslesspicam_tpu_torch/ops/csrc/h_pass_a.cu",
                     "lenslesspicam_tpu/ops/pallas_kernels2.py:583"),
    "h_combine_dual": ("K5", "lenslesspicam_tpu_torch/ops/csrc/h_combine.cu",
                       "lenslesspicam_tpu/ops/pallas_kernels2.py:1096"),
    "irfft_w_dual_state": ("K6", "lenslesspicam_tpu_torch/ops/csrc/w_dual_state.cu",
                           "lenslesspicam_tpu/ops/pallas_kernels2.py:2090"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=7):
    """Median device time of one call, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def rel_err(outs, refs):
    """(max relative, max absolute) error over paired output tensors; the
    relative error of each is max |a - b| / max |b|."""
    errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(outs, refs)]
    abs_errs = [float((a - b).abs().max()) for a, b in zip(outs, refs)]
    return max(errs), max(abs_errs)


def flatten(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in flatten(y) if isinstance(t, torch.Tensor)]
    return [x] if isinstance(x, torch.Tensor) else []


def stage_flops(L):
    """Flops per output point of one DFT stage of length L in the kernels'
    design (``dft`` in ops/csrc/lpt_dft.cuh): L complex multiply-adds
    (8 flops each), or a + b of them plus one twiddle (6 flops) when the
    stage splits as L = a * b (a, b multiples of 4, a + b least)."""
    a = max([a for a in range(4, L + 1, 4) if a * a <= L and L % a == 0
             and (L // a) % 4 == 0] or [0])
    return 8.0 * L if not a else 8.0 * (a + L // a) + 6.0


def kernel_cases(ph, pw, gen):
    """Seeded inputs at the shapes the fused loop gives each kernel, with
    the operation count of each kernel's DFT stages (the elementwise
    algebra around them adds a few percent and is not counted)."""
    dev = "cuda"
    m = pw // 2
    w1, w2 = K.factors(m, True)
    h1, h2 = K.factors(ph, True)
    p = ADMMParams()

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    w_core = ph * m * (stage_flops(w1) + stage_flops(w2))
    x = rn(ph, pw)
    # K3's TV carries at their KKT scale (|a| ~ tau, |b| ~ mu3 |image|):
    # unit-scale carries make a' = mu2 u - eta cancel to ~1e-4 of its
    # operands and no f32 evaluation order can keep 1e-4 relative there
    img = rn(ph, pw)
    a0, a1 = rn(ph, pw, scale=p.tau), rn(ph, pw, scale=p.tau)
    b = rn(ph, pw, scale=p.mu3)
    q = [rn(h1, h2, m) for _ in range(4)]
    c = [rn(h1, h2, m) for _ in range(7)]
    s = [rn(ph, m) for _ in range(4)] + [rn(ph) for _ in range(4)]
    v, dp = rn(ph, pw, scale=p.mu1), rn(ph, pw)
    mask = (torch.rand(ph, pw, generator=gen, device=dev) > 0.5).float()
    return {
        "rfft_w": ((x,), w_core),
        "e1_rtv": ((img, a0, a1, b, p.mu2, p.mu3, p.tau), w_core),
        "h_passA_pair": ((*q, ph, False), 2 * ph * m * stage_flops(h1)),
        "h_combine_dual": ((*c, ph), 4 * ph * m * stage_flops(h2)),
        "irfft_w_dual_state": ((*s, v, mask, dp, p.mu1), 3 * w_core),
    }


def check_kernels(ph, pw, timed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(ph)
    rows = {}
    for name, (args, flops) in kernel_cases(ph, pw, gen).items():
        wrapper, plain = getattr(K, name), getattr(K, name + "_plain")
        out = wrapper(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(flatten(out), flatten(ref))
        if not rel <= TOL_KERNEL:
            raise AssertionError(f"{name} at {ph}x{pw}: rel err {rel:.3e} > {TOL_KERNEL}")
        row = {"kernel": name, "grid": [ph, pw], "max_abs_err": ab,
               "max_rel_err": rel, "tol_rel": TOL_KERNEL}
        if timed:
            byt = nbytes(*flatten(args), *flatten(out))
            t_bytes = byt / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOP_PER_S * 1e3
            row.update(ms=time_ms(lambda: wrapper(*args)),
                       plain_ms=time_ms(lambda: plain(*args)),
                       bytes=byt, flops=flops, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=None)
            if name == "rfft_w":     # one library call, same function: rfft along W
                xn = torch.randn(ph, pw, generator=gen, device="cuda")
                row["library_ms"] = time_ms(lambda: torch.fft.rfft(xn, dim=-1))
        emit(dict(phase="kernel", **row))
        rows[name] = row
    return rows


def chain_yardstick(ph, pw):
    """K4 -> K5 -> K4 (``fft_h_combine_dual``) against the same function
    in torch.fft calls: fft along H of two half planes, the combine, and
    the inverse of F and H F."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    m = pw // 2
    planes = [torch.randn(ph, m, generator=gen, device="cuda") for _ in range(7)]
    rkr, rki, vr, vi, hr, hi, rr = planes

    def lib():
        A = torch.fft.fft(torch.complex(rkr, rki), dim=0)
        B = torch.fft.fft(torch.complex(vr, vi), dim=0)
        H = torch.complex(hr, hi)
        F = rr * (A + torch.conj(H) * B)
        return torch.fft.ifft(F, dim=0), torch.fft.ifft(H * F, dim=0)

    emit({"phase": "chain", "name": "fft_h_combine_dual (K4, K5, K4)",
          "grid": [ph, pw],
          "ms": time_ms(lambda: K.fft_h_combine_dual(*planes, ph)),
          "library_ms": time_ms(lib),
          "note": "library_ms: torch.fft (natural order) of the same algebra"})


def cert_scene_psf(shape, rng):
    """Structured scene (rects, blobs, HDR point sources) and a sparse
    random PSF at the given grid (the JAX bench's certification scene)."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ry, rx = yy / h, xx / w
    scene = np.zeros((h, w), np.float32)
    scene[int(0.2 * h):int(0.4 * h), int(0.23 * w):int(0.47 * w)] = 1.0
    scene[int(0.5 * h):int(0.8 * h), int(0.55 * w):int(0.86 * w)] = 0.6
    scene += (0.8 * np.exp(-((ry - 0.3) ** 2 + (rx - 0.7) ** 2) / 0.01)
              + 0.5 * np.exp(-((ry - 0.72) ** 2 + (rx - 0.25) ** 2) / 0.03)
              + 0.1 * np.sin(rx * 40.0) * np.sin(ry * 30.0) + 0.1)
    for (cy, cx) in ((0.12, 0.15), (0.5, 0.74), (0.85, 0.33)):
        scene[int(cy * h):int(cy * h) + 2, int(cx * w):int(cx * w) + 2] = 3.0
    scene = scene.astype(np.float32)
    n_pts = max(200, (h * w) // 64)
    psf = np.zeros((h, w), np.float32)
    qys = rng.randint(0, h, n_pts)
    qxs = rng.randint(0, w, n_pts)
    psf[qys, qxs] = rng.rand(n_pts)
    psf /= np.linalg.norm(psf)
    return scene, psf


def psnr_db(out, scene_n):
    on = out / out.max().clamp_min(1e-9)
    return float(-10.0 * torch.log10(torch.mean((on - scene_n) ** 2) + 1e-12))


def small_end_to_end():
    """Fused (kernels) against exact at 48 x 64, n = 10, on the card."""
    rng = np.random.RandomState(12)
    psf = rng.rand(*SMALL).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(*SMALL).astype(np.float32)
    conv = admm.make_convolver(psf[None, :, :, None])
    ref = admm.run(conv, data[None, None, :, :, None], n_iter=10)[0, 0, :, :, 0]
    out = admm_split.run_rsplit(admm_split.precompute_rsplit(psf, data), n_iter=10)
    err = float((out - ref).abs().max() / ref.abs().max())
    if not err <= TOL_SMALL:
        raise AssertionError(f"small grid fused vs exact: {err:.3e} > {TOL_SMALL}")
    emit({"phase": "small_end_to_end", "grid": list(SMALL), "n_iter": 10,
          "fused_vs_exact": err, "tol": TOL_SMALL})


def rate(fn, base=2, full=52, pairs=5):
    """it/s by the difference method: (full - base) / (t_full - t_base)
    over back-to-back pairs; pairs that do not scale are dropped."""
    fn(base)
    torch.cuda.synchronize()
    rates = []
    for _ in range(pairs):
        t0 = time.perf_counter()
        fn(full)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn(base)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if (t1 - t0) > (t2 - t1):
            rates.append((full - base) / ((t1 - t0) - (t2 - t1)))
    if len(rates) < 2:
        raise AssertionError(f"only {len(rates)} timing pairs scaled")
    q = statistics.quantiles(rates, n=4)
    return {"median": statistics.median(rates), "iqr": q[2] - q[0],
            "pairs": len(rates), "rates": rates}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "ptxas": regs})

    check_kernels(2 * SMALL[0], 2 * SMALL[1], timed=False)
    ph, pw = 6144, 8192
    krows = check_kernels(ph, pw, timed=True)
    chain_yardstick(ph, pw)
    small_end_to_end()

    # end to end at 12 MP: scene, PSF and measurement from seed 0
    rng = np.random.RandomState(0)
    scene, psf2d = cert_scene_psf(SENSOR, rng)
    fwd = FFTConvolver.from_psf(psf2d[None, :, :, None], pad=True,
                                     norm="backward")
    meas = fwd.convolve(torch.from_numpy(scene)[None, None, :, :, None].cuda())
    meas = (meas / meas.max().clamp_min(1e-9))[0, 0, :, :, 0]
    scene_n = torch.from_numpy(scene / scene.max()).cuda()
    del fwd

    t0 = time.perf_counter()
    pre = admm_split.precompute_rsplit(psf2d, meas.cpu().numpy())
    t_pre = time.perf_counter() - t0
    conv = admm.make_convolver(psf2d[None, :, :, None])
    data5 = meas[None, None, :, :, None]

    torch.cuda.reset_peak_memory_stats()
    n = 10
    K.reset_launches()
    fused = admm_split.run_rsplit(pre, n_iter=n)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    want = {"rfft_w": 1, "e1_rtv": n, "h_passA_pair": 2 * n,
            "h_combine_dual": n, "irfft_w_dual_state": n}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    peak_fused = torch.cuda.max_memory_allocated()
    exact = admm.run(conv, data5, n_iter=n)[0, 0, :, :, 0]
    if tuple(fused.shape) != SENSOR or not bool(torch.isfinite(fused).all()):
        raise AssertionError("fused output is not finite at the sensor shape")
    p_exact, p_fused = psnr_db(exact, scene_n), psnr_db(fused, scene_n)
    diff = float((fused - exact).abs().max() / exact.abs().max())
    if not abs(p_exact - p_fused) <= TOL_PSNR_DB:
        raise AssertionError(f"PSNR exact {p_exact:.3f} vs fused {p_fused:.3f} dB")
    n3 = 3
    k3 = admm_split.run_split_rfused(pre, n_iter=n3)
    p3 = admm_split.run_split_rfused(pre, n_iter=n3, ops=K.PLAIN)
    loop_err = float((k3 - p3).abs().max() / p3.abs().max())
    if not loop_err <= TOL_LOOP:
        raise AssertionError(f"fused loop kernels vs plain: {loop_err:.3e}")
    emit({"phase": "end_to_end", "grid": list(SENSOR), "padded": [ph, pw],
          "n_iter": n, "psnr_exact_db": p_exact, "psnr_fused_db": p_fused,
          "tol_db": TOL_PSNR_DB, "fused_vs_exact_normalized": diff,
          "loop_kernels_vs_plain_n3": loop_err, "tol_loop": TOL_LOOP,
          "launches": counts, "precompute_s": t_pre,
          "peak_mem_fused_bytes": peak_fused,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})

    fused_rate = rate(lambda k: admm_split.run_rsplit(pre, n_iter=k))
    exact_rate = rate(lambda k: admm.run(conv, data5, n_iter=k))
    emit({"phase": "rate", "grid": list(SENSOR), "method": "(n=52 - n=2) pairs",
          "fused_it_per_s": fused_rate, "exact_it_per_s": exact_rate,
          "card": smi})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][1],
         "replaces": KERNEL_INFO[name][2], "label": KERNEL_INFO[name][0],
         "launches": counts[name], "max_abs_err": krows[name]["max_abs_err"],
         "max_rel_err": krows[name]["max_rel_err"], "ms": krows[name]["ms"],
         "plain_ms": krows[name]["plain_ms"], "bound_ms": krows[name]["bound_ms"],
         "bound_by": krows[name]["bound_by"], "library_ms": krows[name]["library_ms"]}
        for name in KERNEL_INFO]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
