"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card (at a small
grid in every storage-dtype combination the kernels are built for, at
the 12 MP grid in the f32 mode and in the JAX bench's headline storage
mode: bf16 spectra, int16 carries), runs the small-grid fused loop
through the kernels against the plain loop in every storage mode, runs
K1 -> K2 round trips at 12 MP, reconstructs a 12 MP measurement with the
exact solver and with the fused solver through the kernels in both
modes, passes the JAX bench's gates (bench.py:376-435) in the headline
mode, checks that each counted run went through every kernel of its
path, measures the solvers' rates, and prints one JSON line per phase.  The last line is ``{"ok": true, "device": {...}}``; any
failure raises and exits non-zero.  Without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
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
TOL_KERNEL = 1e-4            # f32 outputs: max |kernel - plain| / max |plain|
TOL_PSNR_DB = 0.1            # |PSNR exact - PSNR fused| at n = 10
TOL_SMALL = 1e-5             # fused vs exact, normalized, small grid, n = 10
TOL_LOOP = 1e-4              # fused loop, kernels vs plain versions, n = 3
# headline mode (io bf16, int16 carries): a bf16 output may differ from the
# plain version's by one bf16 ulp where the two f32 pre-images straddle a
# rounding boundary, an int16 output by one LSB, and at most 1 % of a
# bf16 or int16 plane may differ at all (a store that truncates instead of
# rounding to nearest even is off by one on about half of it);
# saturation values 1e-5
BF16_ULP = 2.0 ** -7
TOL_BF16_FLOOR = 1e-5        # times max |plain|, for values near zero
TOL_FLIP_SHARE = 1e-2
TOL_SAT = 1e-5
# K1 -> K2 round trip, max |x - x'| / max |x|: exact at f32; at bf16 the
# spectra are rounded to 8 bits
TOL_ROUND_TRIP = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the quantized loop amplifies rounding flips along its trajectory (a
# 3e-7 relative change of the data alone moves the JAX package's own
# headline loop by 5e-3 at n = 3): kernels vs plain versions, n = 3
TOL_LOOP_HEADLINE = 2e-2
TOL_PSNR_DEEP_DB = 1.2       # one-sided: headline >= exact - 1.2 dB at n = 100, 300
TOL_COLLAPSE_DB = 0.5        # headline n = 300 >= headline n = 10 - 0.5 dB
HEADLINE = dict(io="bf16", carry_tv="i16", carry_v="i16")
F32, BF16, I16 = torch.float32, torch.bfloat16, torch.int16
NAME = {F32: "f32", BF16: "bf16", I16: "i16"}
# (io, carry, K2 out dtype) of the timed 12 MP checks
MODES = {"f32": (F32, F32, F32), "headline": (BF16, I16, F32)}
# every (io, carry) the CUDA code is built for, K2's out dtype bf16 with
# 2-byte carries so that all four (io, out) pairs run
COMBOS = [(io, c, BF16 if c != F32 else F32) for io in (F32, BF16) for c in (F32, BF16, I16)]
# (io, carry_tv, carry_v) of the small-grid loop: each knob alone, bf16
# carries, the headline mode (as tests/test_torch_modes.py)
LOOP_MODES = [("bf16", "f32", "f32"), ("f32", "i16", "f32"), ("f32", "f32", "i16"),
              ("f32", "bf16", "bf16"), ("bf16", "i16", "i16")]
TOL_LOOP_MODES = 5e-2        # normalized, n = 20 (tests/test_pallas_fft.py:249)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOP_PER_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores

KERNEL_INFO = {   # wrapper -> (label, CUDA source, TPU kernel it replaces)
    "rfft_w": ("K1", "lenslesspicam_tpu_torch/ops/csrc/rfft_w.cu",
               "lenslesspicam_tpu/ops/pallas_kernels2.py:1810"),
    "irfft_w": ("K2", "lenslesspicam_tpu_torch/ops/csrc/irfft_w.cu",
                "lenslesspicam_tpu/ops/pallas_kernels2.py:1831"),
    "e1_rtv": ("K3", "lenslesspicam_tpu_torch/ops/csrc/e1_rtv.cu",
               "lenslesspicam_tpu/ops/pallas_kernels2.py:2224"),
    "h_passA_pair": ("K4", "lenslesspicam_tpu_torch/ops/csrc/h_pass_a.cu",
                     "lenslesspicam_tpu/ops/pallas_kernels2.py:583"),
    "h_combine_dual": ("K5", "lenslesspicam_tpu_torch/ops/csrc/h_combine.cu",
                       "lenslesspicam_tpu/ops/pallas_kernels2.py:1096"),
    "irfft_w_dual_state": ("K6", "lenslesspicam_tpu_torch/ops/csrc/w_dual_state.cu",
                           "lenslesspicam_tpu/ops/pallas_kernels2.py:2090"),
    "sat_scan_i16": ("K7", "lenslesspicam_tpu_torch/ops/csrc/sat_scan.cu",
                     "lenslesspicam_tpu/ops/pallas_kernels2.py:313"),
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


def out_err(a, b):
    """(max abs, max relative, share not bit-equal, within tolerance) of
    one kernel output against the plain version's: f32 within TOL_KERNEL
    of max |plain|; bf16 elementwise within one ulp plus TOL_BF16_FLOOR of
    max |plain|; int16 within one LSB (max abs counted in LSB, max
    relative None); bf16 and int16 with at most TOL_FLIP_SHARE of the
    elements not bit-equal; a saturation value within TOL_SAT relative."""
    if not isinstance(a, torch.Tensor) or a.dim() == 0:
        a, b = float(a), float(b)
        rel = abs(a - b) / max(abs(b), 1e-30)
        return abs(a - b), rel, None, rel <= TOL_SAT
    if a.dtype != b.dtype or a.shape != b.shape:
        return None, None, None, False
    if a.dtype == torch.int16:
        d = (a.int() - b.int()).abs()
        share = float((d != 0).float().mean())
        return float(d.max()), None, share, float(d.max()) <= 1.0 and share <= TOL_FLIP_SHARE
    af, bf = a.float(), b.float()
    d, scale = (af - bf).abs(), float(bf.abs().max().clamp_min(1e-30))
    ab, rel = float(d.max()), float(d.max()) / scale
    if a.dtype == torch.bfloat16:
        share = float((d != 0).float().mean())
        ok = bool((d <= BF16_ULP * bf.abs() + TOL_BF16_FLOOR * scale).all())
        return ab, rel, share, ok and share <= TOL_FLIP_SHARE
    return ab, rel, None, rel <= TOL_KERNEL


def flatten(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in flatten(y)]
    return [x]


def tensors(x):
    return [t for t in flatten(x) if isinstance(t, torch.Tensor)]


def fft_ops(n):
    """Operations of one complex length-n FFT: 5 n log2 n, the radix-2
    count."""
    return 5.0 * n * math.log2(n)


UNPACK_OPS = 14    # per bin, packing a real length-2m transform into a complex length-m one
TV_OPS = 31        # per point, K3's TV and non-negativity update and rk (e1_rtv_plain)
X_OPS = 9          # per point, K6's X and v update (irfft_w_dual_state_plain)
COMBINE_OPS = 16   # per point, K5's F = R (A + conj(H) B) and H F
SAT_OPS = 2        # per value scanned for the saturation max (abs, max)


def kernel_cases(ph, pw, gen, io, carry, k2_out):
    """Seeded inputs at the shapes the fused loop gives each kernel, the
    spectra and static planes at ``io``, the TV and v carries at
    ``carry``, K2's output at ``k2_out``; with the operations each
    function needs, counted from the function and not from the kernels'
    design: 5 n log2 n per complex length-n FFT, UNPACK_OPS per bin of a
    packed real transform, and the elementwise algebra around them."""
    dev = "cuda"
    m = pw // 2
    h1, h2 = K.factors(ph, True)
    p = ADMMParams()
    i16 = carry == I16

    def rn(*s, scale=1.0, dtype=io):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    w_row = ph * (fft_ops(m) + UNPACK_OPS * m)       # one packed-real W transform per row
    sc_a, sc_b = K._tv_scales(p.mu2, p.mu3, p.tau)
    # K3's TV carries at their KKT scale (|a| ~ tau, |b| ~ mu3 |image|):
    # unit-scale carries make a' = mu2 u - eta cancel to ~1e-4 of its
    # operands and no f32 evaluation order can keep 1e-4 relative there
    img = rn(ph, pw)
    a0, a1 = (K._store_carry(rn(ph, pw, scale=p.tau, dtype=F32), carry, sc_a)
              for _ in range(2))
    b = K._store_carry(rn(ph, pw, scale=p.mu3, dtype=F32), carry, sc_b)
    q = [rn(h1, h2, m) for _ in range(4)]
    c = [rn(h1, h2, m) for _ in range(7)]
    # K6 at its loop scale: data only inside the support mask and v of
    # order mu1, so v' stays inside the int16 full scale 256 mu1
    s = [rn(ph, m) for _ in range(4)] + [rn(ph, dtype=F32) for _ in range(4)]
    v = K.encode_v(rn(ph, pw, scale=p.mu1, dtype=F32), p.mu1, carry)
    mask32 = (torch.rand(ph, pw, generator=gen, device=dev) > 0.5).float()
    mask = mask32.to(io)
    dp = (mask32 * torch.rand(ph, pw, generator=gen, device=dev)).to(io)
    # an int16 plane reaching full scale both ways, and one -32768 (> 1)
    x16 = torch.randint(-20000, 20001, (ph, pw), generator=gen, device=dev,
                        dtype=torch.int16)
    x16[1, 2], x16[3, 4], x16[ph // 2, pw // 3] = 32767, -32767, -32768
    pts = ph * pw
    return {
        "rfft_w": ((rn(ph, pw),), w_row),
        "irfft_w": ((rn(ph, m), rn(ph, m), k2_out), w_row),
        "e1_rtv": ((img, a0, a1, b, p.mu2, p.mu3, p.tau),
                   w_row + pts * (TV_OPS + (3 * SAT_OPS if i16 else 0))),
        "h_passA_pair": ((*q, ph, False), 2 * ph * m * (5.0 * math.log2(h1) + 6)),
        "h_combine_dual": ((*c, ph), ph * m * (4 * 5.0 * math.log2(h2) + COMBINE_OPS)),
        "irfft_w_dual_state": ((*s, v, mask, dp, p.mu1),
                               3 * w_row + pts * (X_OPS + (SAT_OPS if i16 else 0))),
        "sat_scan_i16": ((x16,), SAT_OPS * pts),
    }


def library_call(name, args):
    """One PyTorch call computing the same function on the same inputs
    (the yardstick of ``library_ms``), or None where there is none."""
    if name == "rfft_w":      # rfft along W; torch.fft takes no bf16: f32 copy
        x = args[0].float()
        return lambda: torch.fft.rfft(x, dim=-1)
    if name == "irfft_w":     # irfft along W of a half spectrum of the same size
        z = torch.complex(args[0].float(), args[1].float())
        return lambda: torch.fft.irfft(z, n=2 * z.shape[-1], dim=-1)
    if name == "sat_scan_i16":
        return lambda: torch.aminmax(args[0])
    return None


def check_kernels(ph, pw, timed, io, carry, k2_out, mode):
    """Each kernel against its plain version on the inputs of
    :func:`kernel_cases`; with ``timed`` also its time, the plain
    version's, the library call's and the bound.  One JSON line per
    kernel; returns the rows by kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(ph)
    rows = {}
    for name, (args, flops) in kernel_cases(ph, pw, gen, io, carry, k2_out).items():
        wrapper, plain = getattr(K, name), getattr(K, name + "_plain")
        out = wrapper(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        errs = [out_err(a, b) for a, b in zip(flatten(out), flatten(ref))]
        if len(flatten(out)) != len(flatten(ref)) or not all(e[3] for e in errs):
            raise AssertionError(f"{name} ({mode}) at {ph}x{pw}: errors {errs}")
        lsb = [e[0] for e in errs if e[1] is None]     # int16 outputs, in LSB
        val = [e for e in errs if e[1] is not None]
        shares = [e[2] for e in errs if e[2] is not None]
        row = {"kernel": name, "mode": mode, "grid": [ph, pw],
               "dtypes": sorted({str(t.dtype) for t in tensors((args, out))}),
               "max_abs_err": max(e[0] for e in val),
               "max_rel_err": max(e[1] for e in val),
               "max_lsb_err": max(lsb) if lsb else None,
               "max_flip_share": max(shares) if shares else None}
        if timed:
            byt = nbytes(*tensors(args), *tensors(out))
            t_bytes = byt / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOP_PER_S * 1e3
            lib = library_call(name, args)
            row.update(ms=time_ms(lambda: wrapper(*args)),
                       plain_ms=time_ms(lambda: plain(*args)),
                       bytes=byt, flops=flops, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=time_ms(lib) if lib else None)
        emit(dict(phase="kernel", **row))
        rows[name] = row
    return rows


def round_trip(ph, pw):
    """K2's own path: ``irfft_w(rfft_w(x)) == x`` at 12 MP through the two
    entry points, at f32 and at bf16 io, each run with the launch counts
    set to 0 just before it and read just after.  Returns the counts of
    the bf16 run."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    x0 = torch.randn(ph, pw, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x = x0.to(dtype)
        K.reset_launches()
        back = K.irfft_w(*K.rfft_w(x))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        want = {name: int(name in ("rfft_w", "irfft_w")) for name in counts}
        if counts != want:
            raise AssertionError(f"round trip launch counts {counts} != {want}")
        err = float((back - x.float()).abs().max() / x.float().abs().max())
        if not err <= TOL_ROUND_TRIP[dtype]:
            raise AssertionError(f"K1 -> K2 round trip ({dtype}) at {ph}x{pw}: {err:.3e}")
        emit({"phase": "round_trip", "grid": [ph, pw], "io": str(dtype),
              "max_rel_err": err, "tol": TOL_ROUND_TRIP[dtype], "launches": counts})
    return counts


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
    """Fused (kernels) against exact at 48 x 64, n = 10, on the card; then
    in every storage mode of LOOP_MODES the loop through the kernels
    against the loop through the plain versions, n = 20, with both
    saturation values in (0, 1) where a carry is int16."""
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
    pre = admm_split.precompute_rsplit(psf, data / data.max())
    loops = []
    for io, tv, v in LOOP_MODES:
        modes = dict(io=io, carry_tv=tv, carry_v=v)
        k, k_sat = admm_split.run_split_rfused(pre, n_iter=20, return_sat=True, **modes)
        p, p_sat = admm_split.run_split_rfused(pre, n_iter=20, return_sat=True,
                                               ops=K.PLAIN, **modes)
        lerr = float((k - p).abs().max() / p.abs().max())
        sats_ok = (0.0 < k_sat < 1.0 and 0.0 < p_sat < 1.0) if "i16" in (tv, v) else \
            (k_sat == 0.0 and p_sat == 0.0)
        if not (lerr <= TOL_LOOP_MODES and sats_ok and bool(torch.isfinite(k).all())):
            raise AssertionError(f"small loop {modes} kernels vs plain: {lerr:.3e}, "
                                 f"sat {k_sat} vs {p_sat}")
        loops.append({**modes, "kernels_vs_plain": lerr, "sat": k_sat, "sat_plain": p_sat})
    emit({"phase": "small_end_to_end", "grid": list(SMALL), "n_iter": 10,
          "fused_vs_exact": err, "tol": TOL_SMALL, "loop_n_iter": 20,
          "loop_modes": loops, "tol_loop_modes": TOL_LOOP_MODES})


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


def end_to_end_headline(pre, conv, data5, scene_n, p_exact10):
    """The JAX bench's gate design (bench.py:376-435) in the headline mode
    at 12 MP, on the f32 phase's scene, PSF and precompute: exactness at
    n = 10, one-sided quality at n = 100 and 300, anti-collapse, carry
    saturation below full scale; the launch counts of the n = 10 run and
    the loop through the kernels against the loop through the plain
    versions at n = 3."""
    torch.cuda.reset_peak_memory_stats()
    n = 10
    K.reset_launches()
    out10, sat10 = admm_split.run_rsplit(pre, n_iter=n, return_sat=True, **HEADLINE)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    want = {"rfft_w": 1, "irfft_w": 0, "e1_rtv": n, "h_passA_pair": 2 * n,
            "h_combine_dual": n, "irfft_w_dual_state": n, "sat_scan_i16": 2}
    if counts != want:
        raise AssertionError(f"headline launch counts {counts} != {want}")
    peak = torch.cuda.max_memory_allocated()
    if tuple(out10.shape) != SENSOR or not bool(torch.isfinite(out10).all()):
        raise AssertionError("headline output is not finite at the sensor shape")
    p10 = psnr_db(out10, scene_n)
    if not abs(p_exact10 - p10) <= TOL_PSNR_DB:
        raise AssertionError(f"headline exactness gate (n=10): exact {p_exact10:.3f} "
                             f"vs headline {p10:.3f} dB")
    deep = {}
    for nd in (100, 300):
        pe = psnr_db(admm.run(conv, data5, n_iter=nd)[0, 0, :, :, 0], scene_n)
        out, sat = admm_split.run_rsplit(pre, n_iter=nd, return_sat=True, **HEADLINE)
        po = psnr_db(out, scene_n)
        if not sat < 1.0:
            raise AssertionError(f"headline carry saturation (n={nd}): {sat:.3f}")
        if not po >= pe - TOL_PSNR_DEEP_DB:
            raise AssertionError(f"headline quality gate (n={nd}): {po:.3f} dB more than "
                                 f"{TOL_PSNR_DEEP_DB} dB below exact {pe:.3f} dB")
        deep[nd] = {"psnr_exact_db": pe, "psnr_headline_db": po, "sat": sat}
    if not deep[300]["psnr_headline_db"] >= p10 - TOL_COLLAPSE_DB:
        raise AssertionError(f"headline anti-collapse gate: n=300 "
                             f"{deep[300]['psnr_headline_db']:.3f} dB below n=10 {p10:.3f} dB")
    if not sat10 < 1.0:
        raise AssertionError(f"headline carry saturation (n=10): {sat10:.3f}")
    k3 = admm_split.run_split_rfused(pre, n_iter=3, **HEADLINE)
    p3 = admm_split.run_split_rfused(pre, n_iter=3, ops=K.PLAIN, **HEADLINE)
    loop_err = float((k3 - p3).abs().max() / p3.abs().max())
    if not loop_err <= TOL_LOOP_HEADLINE:
        raise AssertionError(f"headline loop kernels vs plain: {loop_err:.3e}")
    emit({"phase": "end_to_end_headline", "mode": HEADLINE, "grid": list(SENSOR),
          "n_iter": n, "psnr_exact_db": p_exact10, "psnr_headline_db": p10,
          "tol_db": TOL_PSNR_DB, "sat_n10": sat10, "deep": deep,
          "tol_deep_db": TOL_PSNR_DEEP_DB, "tol_collapse_db": TOL_COLLAPSE_DB,
          "loop_kernels_vs_plain_n3": loop_err, "tol_loop": TOL_LOOP_HEADLINE,
          "launches": counts, "peak_mem_headline_bytes": peak})
    return counts


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

    ph, pw = 6144, 8192
    for io, carry, k2_out in COMBOS:
        check_kernels(2 * SMALL[0], 2 * SMALL[1], False, io, carry, k2_out,
                      f"io={NAME[io]},carry={NAME[carry]},k2_out={NAME[k2_out]}")
    krows = {mode: check_kernels(ph, pw, True, *dts, mode) for mode, dts in MODES.items()}
    counts_rt = round_trip(ph, pw)
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
    counts_f32 = K.launch_counts()
    want = {"rfft_w": 1, "irfft_w": 0, "e1_rtv": n, "h_passA_pair": 2 * n,
            "h_combine_dual": n, "irfft_w_dual_state": n, "sat_scan_i16": 0}
    if counts_f32 != want:
        raise AssertionError(f"launch counts {counts_f32} != {want}")
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
          "launches": counts_f32, "precompute_s": t_pre,
          "peak_mem_fused_bytes": peak_fused,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})

    counts = end_to_end_headline(pre, conv, data5, scene_n, p_exact)

    fused_rate = rate(lambda k: admm_split.run_rsplit(pre, n_iter=k))
    headline_rate = rate(lambda k: admm_split.run_rsplit(pre, n_iter=k, **HEADLINE))
    exact_rate = rate(lambda k: admm.run(conv, data5, n_iter=k))
    emit({"phase": "rate", "grid": list(SENSOR), "method": "(n=52 - n=2) pairs",
          "fused_it_per_s": fused_rate, "headline_it_per_s": headline_rate,
          "exact_it_per_s": exact_rate, "card": smi})

    # one entry per kernel: the headline mode's numbers, the f32 mode's
    # beside them; launches from the headline solve, K2's from its own
    # path (the round trip; no solver calls it)
    keys = ("max_abs_err", "max_rel_err", "max_lsb_err", "max_flip_share", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "bytes", "flops")
    path = {name: ("round_trip" if name == "irfft_w" else "end_to_end_headline")
            for name in KERNEL_INFO}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][1],
         "replaces": KERNEL_INFO[name][2], "label": KERNEL_INFO[name][0],
         "launches": (counts_rt if path[name] == "round_trip" else counts)[name],
         "path": path[name],
         **{k: krows["headline"][name][k] for k in keys},
         "f32": {"launches": counts_f32[name],
                 **{k: krows["f32"][name][k] for k in keys}}}
        for name in KERNEL_INFO]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
