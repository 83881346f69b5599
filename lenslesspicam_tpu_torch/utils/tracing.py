"""Profiling and tracing utilities (port of lenslesspicam_tpu/utils/tracing.py).

* ``trace(log_dir)`` -- a context manager around ``torch.profiler``: a
  Chrome trace of the CPU and (with a card) CUDA activity is written into
  ``log_dir`` (Perfetto or ``chrome://tracing`` read it), the traced
  region an NVTX range when the card is there;
* ``time_fn`` -- best wall-clock seconds of a call, the card synchronized
  around each repeat;
* ``roofline_report`` -- the fused ADMM iteration's bytes and operations
  against the H100's data sheet (3.35 TB/s HBM, 67 TFLOP/s f32), and the
  fraction of that bound an achieved it/s reaches;
* ``fused_admm_launches_per_iter`` -- the port's kernel launches per
  iteration of each solver placement.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM data sheet, f32 outside the tensor cores


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/lpt_trace"):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``log_dir/trace_<pid>_<ms>.json``; yields ``log_dir``.  With a CUDA
    card the CUDA activity is traced too and the block is an NVTX range
    ``lpt.trace`` (``torch.cuda.nvtx``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.nvtx.range_push("lpt.trace")
        try:
            with record_function("lpt.trace"):
                yield log_dir
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn, *args, repeats: int = 5, **kwargs) -> float:
    """Best wall-clock seconds over repeats after one warm-up call, the card
    synchronized before and after each."""
    fn(*args, **kwargs)
    _sync()
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def admm_bytes_per_iter(padded_shape, channels=1, dtype_bytes=4) -> int:
    """Memory traffic estimate for one ADMM iteration on the padded grid.

    Counts reads+writes of the state arrays across the fused update
    chains and the 6 rFFT/irFFT passes (each FFT ~ 2x grid traffic for
    the real side + 1x for the half-complex side).
    """
    d, ph, pw = padded_shape[0], padded_shape[1], padded_shape[2]
    grid = d * ph * pw * channels * dtype_bytes
    half = grid  # complex64 half-spectrum ~ same bytes as real grid
    # elementwise: U/X/W/image/dual updates touch ~22 grid-sized arrays
    elementwise = 22 * grid
    # 6 FFTs: input + output each
    ffts = 6 * (grid + half)
    return elementwise + ffts


def fused_admm_bytes_per_iter(padded_shape, io_bytes=2, half_spectrum=True,
                              channels=1) -> int:
    """Memory traffic of one iteration of the fused ADMM pipeline
    (``recon/admm_split.run_split_rfused`` / ``run_split_fused``), counted
    from the JAX kernels' block specs, as the JAX package counts it (the
    same environment knobs: ``LPT_RFUSED_V3``, ``LPT_CARRY_IO``,
    ``LPT_CARRY_TV``, ``LPT_CARRY_V``):

    e1 (carry-rebuild): reads image x3 (halo refs) + fwd + mask + dp
        (io) and the {v, b, a0 x2 (halo), a1} carries (f32); writes rk/v
        spectra (4 planes, io) + {v', a0', a1', b'} (f32).  The
        accumulating duals xi/rho/eta/u are rebuilt in-kernel and never
        cross memory.
    combine_dual: 2x forward pass-A (8) + one fused stage-2 kernel
        (7 in, 4 out) + 2x inverse pass-A (8).
    dual:    passB 8 + 2x passA 8 spectrum planes (io)
    e2 (pure dual W-inverse): reads 4 spectra, writes image/fwd (io).

    half_spectrum=True halves every spectrum plane (packed-real path).
    Returns (total, bytes of 2-byte planes, bytes of 4-byte planes).
    """
    d, ph, pw = padded_shape[0], padded_shape[1], padded_shape[2]
    a = d * ph * pw * channels            # elements per full plane
    h = 0.5 if half_spectrum else 1.0     # spectrum plane scale
    v3 = (half_spectrum
          and os.environ.get("LPT_RFUSED_V3", "1") != "0")
    if v3:
        # v3 placement: fwd never crosses memory (X/v chain inside the dual
        # W-inverse), halos via 8-row stripe refs of the same planes
        # (2 io stripes on image + 1 carry stripe on a0 at br=32)
        io_planes = (1 + 2 * h            # e1: image read + rk spectra
                     + 8 * h              # 2x forward pass-A
                     + 11 * h             # combine_dual kernel (7 in, 4 out)
                     + 8 * h              # 2x inverse pass-A
                     + 4 * h + 2          # e2: 4 spectra in, mask+dp
                     + 1 + 2 * h          # e2: image out + v' spectra
                     + 2 * 8 / 32)        # image halo stripes
        carry_planes = 6 + 2 + 8 / 32     # e1 a0/a1/b r+w, e2 v r+w, a0 stripe
    else:
        io_planes = (6 + 4 * h            # e1 reads + spectrum writes
                     + 8 * h              # 2x forward pass-A
                     + 11 * h             # combine_dual kernel (7 in, 4 out)
                     + 8 * h              # 2x inverse pass-A
                     + 4 * h + 2)         # e2 dual inverse
        carry_planes = 5 + 4              # e1 carry reads + writes
    carry_bytes = (2 if os.environ.get("LPT_CARRY_IO", "").lower() == "bf16"
                   else 4)
    tv_bytes = (2 if os.environ.get("LPT_CARRY_TV", "").lower()
                in ("i16", "bf16") else carry_bytes)
    v_bytes = (2 if os.environ.get("LPT_CARRY_V", "").lower()
               in ("i16", "bf16") else carry_bytes)
    v_planes = 2                          # e2 v r+w
    tv_planes = carry_planes - v_planes
    b2 = a * (io_planes * io_bytes if io_bytes == 2 else 0)
    b4 = a * (io_planes * io_bytes if io_bytes == 4 else 0)
    for planes, nbytes in ((v_planes, v_bytes), (tv_planes, tv_bytes)):
        if nbytes == 2:
            b2 += a * planes * nbytes
        else:
            b4 += a * planes * nbytes
    return int(b2 + b4), int(b2), int(b4)


# kernel launches per iteration of each placement, whatever the grid and
# the number of planes (one launch a kernel a pass): the half-spectrum
# solver's v3 and v2 (``recon/admm_split.run_split_rfused``; v3's K1 runs
# once before the loop), the spatial solver's rpallas and pallas backends
# (``parallel/spatial.py``; chip_smoke.py's want_counts and
# want_spatial_counts at n = 1)
_LAUNCHES = {
    "v3": {"e1_rtv": 1, "h_passA_pair": 2, "h_combine_dual": 1, "irfft_w_dual_state": 1},
    "v2": {"e1_rcarry": 1, "h_passA_pair": 2, "h_combine_dual": 1, "irfft_w_dual": 1},
    "spatial": {"rfft_w": 1, "h_passA_pair": 2, "h_combine_dual": 1, "irfft_w_dual": 1},
    "spatial_pallas": {"fft_w": 2, "h_passA": 4, "h_passB": 4, "ifft_w": 2},
}


def fused_admm_launches_per_iter(ph: int, pw: int, placement: str = "v3") -> dict:
    """The port's kernel launches (wrapper name -> count) in one iteration
    of ``placement``: "v3" or "v2" (the fused half-spectrum solver),
    "spatial" (``spatial_sharded_admm_rpallas``) or "spatial_pallas"
    (``spatial_sharded_admm_pallas``).  The counterpart of the JAX
    package's ``fused_admm_matmuls_per_iter``, whose count of TPU matmul
    calls has no meaning on the card; the launches do not depend on the
    (ph, pw) grid or on the number of planes."""
    if placement not in _LAUNCHES:
        raise ValueError(f"placement {placement!r} is not one of {sorted(_LAUNCHES)}")
    return dict(_LAUNCHES[placement])


def _fft_ops(n: int) -> float:
    """Operations of a complex length-n FFT, 5 n log2 n (chip_smoke.py)."""
    return 5.0 * n * math.log2(n)


def fused_admm_flops_per_iter(ph: int, pw: int, half_spectrum: bool = True,
                              channels: int = 1) -> float:
    """Operations of one iteration of the fused solver, counted from its
    functions as ``chip_smoke.kernel_cases`` counts them: 5 n log2 n a
    complex length-n FFT, 14 a bin to pack a real transform into a complex
    one of half the length, 31 a point of TV step, 9 of X/v update, 16 of
    spectrum combine, 6 and 8 of K4's forward and inverse twiddles.
    half_spectrum: v3 (K3, K4, K5, K4, K6); else the full-width solver
    (K10, K4, K5, K4, K11), its H stages on W lanes, a real W transform
    counted as the packed complex one and its unpack, and 4 a bin for the
    real part of an inverse."""
    from ..ops.split_fft import _factor

    h1, h2 = _factor(ph)
    m = pw // 2 if half_spectrum else pw
    pts = ph * pw
    w_row = ph * (_fft_ops(pw // 2) + 14 * (pw // 2))
    if half_spectrum:
        e1, e2 = w_row + 31 * pts, 3 * w_row + 9 * pts
    else:
        e1, e2 = 2 * w_row + (31 + 9) * pts, 2 * (w_row + 4 * pts)
    passa = 2 * ph * m * (5.0 * math.log2(h1) + 6) + 2 * ph * m * (5.0 * math.log2(h1) + 8)
    combine = ph * m * (4 * 5.0 * math.log2(h2) + 16)
    return channels * (e1 + passa + combine + e2)


def roofline_report(shape=(3040, 4056), iters_per_s=None, channels=1,
                    hbm_bw=HBM_BYTES_PER_S, half_spectrum=True,
                    flop_rate=F32_FLOP_PER_S) -> dict:
    """Roofline of the fused ADMM iteration at a sensor ``shape`` (padded
    as the solvers pad it) on the H100: term 1 the bytes of
    :func:`fused_admm_bytes_per_iter` over ``hbm_bw`` (3.35 TB/s, the data
    sheet; io at 2 bytes under ``LPT_SPLIT_IO=bf16``, as in the JAX
    package), term 2 the operations of :func:`fused_admm_flops_per_iter`
    over ``flop_rate`` (67 TFLOP/s f32, the data sheet); the bound is
    the larger.  With ``iters_per_s`` also the fractions of each bound
    reached."""
    from ..ops.padding import padded_size

    ph = padded_size(shape[0])
    pw = padded_size(shape[1])
    io_bytes = 2 if os.environ.get("LPT_SPLIT_IO", "").lower() == "bf16" else 4
    bytes_per_iter, b2, b4 = fused_admm_bytes_per_iter(
        (1, ph, pw), io_bytes, half_spectrum=half_spectrum, channels=channels)
    flops = fused_admm_flops_per_iter(ph, pw, half_spectrum, channels)
    t_bytes = bytes_per_iter / hbm_bw
    t_ops = flops / flop_rate
    t_combined = max(t_bytes, t_ops)
    launches = fused_admm_launches_per_iter(ph, pw, "v3")
    out = {
        "padded_shape": (ph, pw),
        "bytes_per_iter": bytes_per_iter,
        "bytes_2B": b2,
        "bytes_4B": b4,
        "sol_iters_per_s": 1.0 / t_bytes,
        "flops_per_iter": flops,
        "ops_iters_per_s": 1.0 / t_ops,
        "combined_bound_iters_per_s": 1.0 / t_combined,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "launches_per_iter": sum(launches.values()),
    }
    if iters_per_s is not None:
        out["achieved_iters_per_s"] = iters_per_s
        out["fraction_of_sol"] = iters_per_s * t_bytes
        out["fraction_of_combined"] = iters_per_s * t_combined
    return out
