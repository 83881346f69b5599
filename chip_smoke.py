"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card (at a small
grid in every storage-dtype combination the kernels are built for, K1-K3,
K6, K8 and K9 also at 96 x 384 and 96 x 1536 and K10-K13 at 96 x 1536,
where each runs its split design instead of the radix FFT (K3, K8 and K10
run their radix designs, the TV step at the radix FFT's pass-0
positions, at the small grids and 12 MP; K8 in all 18 of its type
combinations at 96 x 128, 96 x 384, 96 x 1536 and 12 MP), K5, which runs its
split design at 96 x 128, in its radix design's column form at 256 x 80,
a guarded lane tile, and K4 and K14, which run their split designs at 96
x 128 and their radix designs (n1 = 48) at 6144 x 80, a guarded lane
tile, alone and stacked, K4 and K14 in both directions wherever they
are held; at the 12 MP grid in the
f32 mode and in the JAX bench's headline storage mode, bf16 spectra with
int16 carries, K2, K3, K6, K8 and K9 there in every combination; each
kernel that takes a plane axis also on a stack of 6 planes over 3
constant planes at the small grid and on the RGB and batch=4 rungs'
stacks at 12 MP), runs the small-grid fused loop through the kernels against the plain loop in every storage
mode, runs K1 -> K2 round trips at 12 MP, reconstructs a 12 MP
measurement with the exact solver and with the fused solver through the
kernels in both modes and both kernel placements (v3, v2), passes the
JAX bench's gates (bench.py:376-435) in the headline mode, runs its RGB
and gray batch=4 rungs (bench.py:573-700) per plane in the headline
mode, runs the full-width split solver (``run_split(backend="fused")``,
K10, K4, K5, K4, K11) and its kernels K10-K13, and K4, K5 and K14 at
its lane width W (phase ``split``: every
built storage combination at 96 x 512, a 6-over-3 stack, K10-K13 also at
96 x 1536 alone and stacked, K12 and K13 at an odd row count at W = 512
and 8192, both modes at 12 MP, K4, K5 and K14 there also on the RGB
and batch=4 stacks, K13 also bf16 in and out as the pallas
loop runs it, the K12 -> K13 round trip, the f32 and bench-mode solves
against the exact one, their rates),
runs its pass-level backend (``run_split(backend="pallas")``, K12, K14, K15, K16, K17, K4, K13; phase
``split_pallas``: K14-K18 against their plain versions at 96 x 512 in both
io modes and as a 6-over-3 stack and at 12 MP with kernel rows, K15-K18's
radix design also at 256 x 80, a guarded lane tile, alone and stacked,
and at 256 x 79, an odd lane width, the
``fft_h`` and ``ifft_h_dual`` chains against torch.fft, K18's composition
``fft_h_combine2`` against ``fft_h`` then ``fft_h_combine``,
``filtered_synthesis_pallas2`` at 12 MP against torch.fft, the f32 and bf16
solves against the exact one, launch counts, rates), runs the bandwidth
probe P1-P3 (phase ``bandwidth``: every reading of the JAX script at
6144 x 8192 bit-equal to its plain version, NaN to NaN, P3 also with NaN,
inf and overflowing constants on planes holding +-0, +-inf and NaN, then
timed beside the library copies, each reading the median of 5 timing
pairs with every pair's rate kept, the gate raising on a median or on two
pairs above 1.05 x the data sheet's rate; the largest median reading of
P1, P2 or their library calls is the card's measured streaming rate, and
every kernel row gets a bound at that rate beside the data sheet's),
runs every kernel and the v3, full-width fused and pallas solvers at the
padded grids of GRIDS, where the split designs take their general form
(phase ``grids``: the published baseline's 540 x 960, 768 x 1024, 480 x
640, 96 x 270), passes CUDA tensors that require grad to the public entry
points against numpy inputs (phase ``device_inputs``), runs the classical
solvers, the public API and the evaluation layer (phase ``classical``:
``GradientDescent``, ``NesterovGradientDescent``, ``FISTA``, ``ADMM`` with an
initial estimate and ``APGD`` at 12 MP, with ``apply(disp_iter=...)``
chunks, ``reconstruction_error``, PSNR / SSIM and rates; every new entry
point at 32 x 40 x 3 on the card against the CPU; ``benchmark`` at the
DiffuserCam grid on both), serves the learned models (phase ``learned``:
the zoo's ``Unet4M+U5+Unet4M`` and ``U20`` built by ``build_model`` on
seeded weights carried from a JAX-layout tree, a batch of 4 DiffuserCam
measurements, images/s, peak memory, the card against the CPU; every
other learned family on the card against the CPU at 64 x 112 x 3; no
kernel of the port launched), serves from files (phase ``files``: the 12 MP
PSF and measurement written as the RPi HQ sensor's raw 12-bit mosaics in
.npy files, read by ``data.io.load_data`` through the numpy demosaic and
ISP chain, solved in the headline mode with a gray headline solve's launch
counts and held to the exact solver on the same loaded arrays, the result
saved as a PNG and decoded back to its pixels, host seconds of each step;
phase ``zoo_load``: the ``learned`` phase's Unet4M+U5+Unet4M written as a
reference checkpoint folder, Hydra config and DataParallel keys, read by
``zoo.model_dict.load_model`` onto the card, ``torch.equal`` to the
in-memory model, the card against the CPU, images/s and peak memory,
``benchmark`` over a ``MeasuredDataset`` folder saving a reconstruction,
a learned-PSF override, ``angular_spectrum`` and ``fresnel_conv`` at 12
MP / 4 and ``FarFieldSimulator`` on a batch of 4, each against the CPU),
trains (phase ``train``: the JAX bench's train rung, UNetRes pre and post
around a 5-iteration unrolled ADMM with remat, a batch of 4 at 270 x 480 x
3, through ``train.trainer.Trainer``: one step on the card against the CPU
from the same weights, the remat gradient against none and
``filtered_synthesis``'s backward against plain autograd, a warm-up step
and 10 steps whose loss falls, steps/s and peak memory; phase
``train_mask``: DigiCam mask co-optimization, an ``AdafruitLCD`` at
380 x 507 with the unrolled ADMM for 3 steps on
``SimulatedDatasetTrainableMask`` batches, its PSF and gradient on the
card against the CPU; neither launches a kernel of the port),
runs the row-sharded spatial ADMM of ``parallel/spatial.py`` over a
one-rank NCCL group (phase ``spatial``: at 12 MP gray the rpallas backend
(K1, K4, K5, K9), the pallas backend (K12-K15) and auto, which must
choose rpallas, and rpallas at 3 MP RGB, each against the exact solver,
with launch counts, collectives, peak memory, host precompute seconds and
the loop's it/s; the collectives per iteration beside
``ici_traffic_model``; the on-path kernels at a 4-way split's pencil
shapes), serves the DigiCam multimask dataset in the Hugging Face hub's
format (phase ``hub``: ``get_dataset("digicam_mirflickr_multi")`` over 8
seeded rows at 380 x 507 x 3 with 4 mask labels, its files from a stand-in
``hf_hub_download`` over a temporary folder; each label's PSF simulated on
the card against the CPU; ``benchmark`` over its batches of 4, each
sample solved by the fused RGB solver, f32 v3, one precompute per label,
with an RGB solve's launches of K1, K3, K4, K5 and K6; one sample against
the exact solver; ``HFSimulated`` and a simulated
``HITLDatasetTrainableMask`` sample on the card against the CPU), runs
the CLI apps of ``lenslesspicam_tpu_torch.scripts`` as a user runs them
(phase ``cli``: ``recon.admm`` on a synthetic 12 MP RGB pair of 16-bit PNGs
at downsample 1, padded to 6144 x 8192 x 3, and at downsample 4, each held
to the ``ADMM`` API on the same loaded arrays; ``quality_baseline``'s full
sweep on the card with each ``admm_rfused`` solve's launches of K1, K3, K4,
K5 and K6, each of its 126 PSNRs within 0.01 dB of the same sweep on the
CPU; the other apps
of ``recon``, ``eval`` and ``sim`` at their configs' sizes, the hub's on
stand-in rows and a seeded zoo checkpoint; host seconds and peak memory
of each), checks that each counted run went
through every kernel of its path, measures the solvers' rates, and prints
one JSON line per phase.
The last line is ``{"ok": true, "device": {...}}``; any failure raises
and exits non-zero.  Without a CUDA device it exits non-zero before
printing any result.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

import lenslesspicam_tpu_torch as lpt
from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.eval import lpips
from lenslesspicam_tpu_torch.eval.benchmark import benchmark
from lenslesspicam_tpu_torch.eval.metrics import compute_metrics, ssim
from lenslesspicam_tpu_torch.eval.pnp import parameterize_perturb
from lenslesspicam_tpu_torch.ops import _build, kernels as K, probe_bw as PB
from lenslesspicam_tpu_torch.ops import split_fft as sf
from lenslesspicam_tpu_torch.ops.fft_conv import FFTConvolver
from lenslesspicam_tpu_torch.ops.padding import padded_size
from lenslesspicam_tpu_torch.recon import admm, admm_split, apgd
from lenslesspicam_tpu_torch.recon.admm import ADMMParams
from lenslesspicam_tpu_torch.models.trainable_recon import processor_block
from lenslesspicam_tpu_torch.models.unet import drunet_denoise
from lenslesspicam_tpu_torch.recon.base import ADMM, apply_admm
from lenslesspicam_tpu_torch.utils.tracing import F32_FLOP_PER_S, HBM_BYTES_PER_S
from lenslesspicam_tpu_torch.zoo.model_dict import _UNET_NC, build_model

SENSOR = (3040, 4056)        # 12 MP, padded to 6144 x 8192
SMALL = (48, 64)             # padded to 96 x 128
# padded to 96 x 384: M = 192 = 16 x 12 is no power of two, so K1, K2, K3,
# K6, K8 and K9 run their split designs there (kernels.rfft_w_design, one
# rule for the six), in the fast form (both factors multiples of 4), and
# their radix designs at M = 64 and 4096
K1_SPLIT = (48, 192)
M_NAMES = ("rfft_w", "irfft_w", "irfft_w_dual_state", "e1_rtv", "e1_rcarry", "irfft_w_dual")
# padded to 96 x 512: W = 512 = 4 x 128, the full-width kernels' small grid
SMALL_SPLIT = (48, 256)
# padded to 96 x 1536: W = 12 x 128 is no power of two, so K10-K13 run
# their split designs there (kernels.e1_carry_design, ifft_w_dual_design,
# fft_w_design, ifft_w_design: one rule) and their radix designs at 512
# and 8192; K2, K3, K6, K8 and K9 (M = 768 = 6 x 128) their split designs
# in the general form
W_SPLIT = (48, 768)
W_SPLIT_NAMES = ("ifft_w_dual", "fft_w", "ifft_w", "e1_carry")
# K5's radix design (n2 = 128, kernels.h_combine_dual_design) with its
# last lane tile guarded: H = 2 x 128, half width 40, not a multiple of
# the 32-lane tile (padded grid; the 12 MP and 768 x 1024 grids run the
# radix design on whole tiles, the 96 x 128 grid and GRIDS' 540 x 960,
# 480 x 640 and 96 x 270 the split one); K15's, K16's, K17's and K18's
# radix design (the same rule, kernels.h_pass_b_design) there at the full
# width 80
K5_GUARDED = (256, 80)
# K15's and K16's radix design at an odd lane width, where they take one
# column a thread at bf16 io too (a column pair's 4-byte load needs an even
# W)
K15_ODD_W = (256, 79)
# K4's and K14's radix design (n1 = 48, kernels.h_pass_a_design) with its
# last lane tile cut: H = 48 x 128, lane widths 40 (K4 in the v3 loop's
# cases, M = W / 2) and 80 (K4 and K14 at the full width W), neither a
# multiple of the 64-lane tile (the 12 MP grid runs the radix design on
# whole tiles, every other grid the split one); K4 and K14 in both
# directions
K4_GUARDED = (6144, 80)
K4_NAMES = ("h_passA_pair", "h_passA_pair:inverse", "h_passA")
# sensors whose padded grids take the general form of the split designs
# (csrc/lpt_dft.cuh general_form: a factor not a multiple of 4 or n1 = 1,
# a lane width not a multiple of an H kernel's tile, an odd half width),
# each run through every kernel and the solvers in phase ``grids``: the
# DiffuserCam-MirFlickr grid of the published baseline (bench.py:34
# REF_RESOLUTION; 540 x 960: H = 27 x 20, W = 32 x 30, K4's lane width
# 480), 12 MP at 1/8 (MULTICHIP_r05.json's parity grid; 768 x 1024: H =
# 6 x 128), 240 x 320 (480 x 640: W = 5 x 128) and an odd half width
# (96 x 270: M = 135 = 15 x 9, every row 2-byte unaligned)
GRIDS = ((270, 480), (380, 507), (240, 320), (48, 135))
# K12 and K13 at an odd row count: the last block of each holds one row
ODD_ROWS = 95
TOL_KERNEL = 1e-4            # f32 outputs: max |kernel - plain| / max |plain|
TOL_PSNR_DB = 0.1            # |PSNR exact - PSNR fused| at n = 10
TOL_SMALL = 1e-5             # fused vs exact, normalized, small grid and hub, n = 10
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
# the RGB and batch rungs' one-sided margin (bench.py:674-682): the
# per-plane scaled scenes sit at other phases of ADMM's oscillating PSNR
TOL_PSNR_DEEP_MODE_DB = 1.5
# v2 against v3 at f32, normalized, n = 10: the same recurrence (2e-6 in
# the JAX package at 40 x 56, tests/test_pallas_fft.py:212)
TOL_V2_V3 = 1e-4
# the full-width split solver against the exact one, normalized
# (tests/test_pallas_fft.py:54-72)
TOL_SPLIT_EXACT = 5e-2
HEADLINE = dict(io="bf16", carry_tv="i16", carry_v="i16")
F32, BF16, I16 = torch.float32, torch.bfloat16, torch.int16
NAME = {F32: "f32", BF16: "bf16", I16: "i16"}
# (io, carry_tv, carry_v, K2 out dtype) of the timed 12 MP checks
MODES = {"f32": (F32, F32, F32, F32), "headline": (BF16, I16, I16, F32)}
# every (io, carry) the CUDA code is built for, K2's out dtype bf16 with
# 2-byte carries so that all four (io, out) pairs run
COMBOS = [(io, c, c, BF16 if c != F32 else F32) for io in (F32, BF16)
          for c in (F32, BF16, I16)]
# K8 takes its TV and v carries independently: all 18 (io, tv, v), at
# the small grid (its radix design) and at both split grids (the fast and
# the general form of its split design), and at 12 MP
K8_COMBOS = [(io, tv, v, F32) for io in (F32, BF16) for tv in (F32, BF16, I16)
             for v in (F32, BF16, I16)]
K8_GRIDS = ((2 * SMALL[0], 2 * SMALL[1]), (2 * K1_SPLIT[0], 2 * K1_SPLIT[1]),
            (2 * W_SPLIT[0], 2 * W_SPLIT[1]))
PLANES = (6, 3)              # P planes over Pc constant planes, small-grid check
# the stacks of the RGB (3 planes over 3 constant planes) and batch=4 (4
# planes over 1) rungs, at 12 MP: every plane and constant plane seeded
# apart, so a kernel that read the wrong plane would disagree
PLANES_12MP = ((3, 3), (4, 1))
PLANE_KERNELS = ("rfft_w", "e1_rtv", "h_passA_pair", "h_passA_pair:inverse",
                 "h_combine_dual", "irfft_w_dual_state", "e1_rcarry", "irfft_w_dual")
# (io, carry_tv, carry_v) of the small-grid loop: each knob alone, bf16
# carries, the headline mode (as tests/test_torch_modes.py)
LOOP_MODES = [("bf16", "f32", "f32"), ("f32", "i16", "f32"), ("f32", "f32", "i16"),
              ("f32", "bf16", "bf16"), ("bf16", "i16", "i16")]
TOL_LOOP_MODES = 5e-2        # normalized, n = 20 (tests/test_pallas_fft.py:249)
# the full-width split path: its kernels in f32 and in the storage modes the
# bench's headline environment gives it (bench.py:844-846: io bf16, v int16;
# e1_carry keeps the TV carries at _CARRY_DTYPE, f32)
SPLIT_MODES = {"f32": (F32, F32, F32, F32), "bench": (BF16, F32, I16, F32)}
# K13 as the pallas loop runs it at bf16 io: bf16 in and out
# (admm_split.run_split_pallas); the bench mode's K13 row stores f32
PALLAS_K13_MODES = {"pallas_bf16": (BF16, F32, I16, BF16)}
SPLIT_BENCH = dict(io="bf16", carry_tv="f32", carry_v="i16")
# K10 in all 12 (io, carry_tv, carry_v) it is built for; K11-K13 in every
# io and K13 in every (io, out) pair
K10_COMBOS = [(io, tv, v, F32) for io in (F32, BF16) for tv in (F32, BF16)
              for v in (F32, BF16, I16)]
W_COMBOS = [(io, F32, F32, out) for io in (F32, BF16) for out in (F32, BF16)]
SPLIT_KERNELS = ("e1_carry", "ifft_w_dual", "fft_w", "ifft_w")
# K4 (both directions), K5 and K14 on the full-width loop's (n1, n2, W)
# view (split_kernel_cases)
FULL_WIDTH_H = ("h_passA_pair:full_width", "h_passA_pair:full_width_inverse",
                "h_combine_dual:full_width", "h_passA:full_width")
# the pass-level backend: io f32 or bf16, no carries
PALLAS_IO = {"f32": F32, "bf16": BF16}
# PALLAS_IO as the case builders' (io, carry_tv, carry_v, out) modes
PALLAS_MODES = {m: (io, F32, F32, F32) for m, io in PALLAS_IO.items()}
# the kernels of the pallas backend's loop (K12, K13 and the K14 and K15
# forward forms included: the pallas solve runs them; K4 stays on its
# half-spectrum path)
PALLAS_NAMES = ("fft_w", "ifft_w", "h_passA", "h_passB", "h_passB_combine", "h_passB_dual")
# every form of K15 and K17 in pallas_kernel_cases, then K16 and K18: their
# radix design (n2 = 128, kernels.h_pass_b_design) runs at 12 MP, 768 x
# 1024, K5_GUARDED and K15_ODD_W, their split design at the 96 x 512 grid
# and GRIDS' others
K15_K17_FORMS = ("h_passB", "h_passB:inverse", "h_passB:filter", "h_passB:inverse_filter",
                 "h_passB_dual")
K16_K18_FORMS = ("h_passB_combine", "h_passB_combine2")
TOL_SYNTHESIS = 1e-4         # filtered_synthesis_pallas2 vs torch.fft (tests/test_pallas_fft.py:93)
# a streaming reading above the data sheet's rate by more than 5 % is a
# clock that does not scale with the work, not a result
MAX_BYTES_PER_S = 1.05 * HBM_BYTES_PER_S
BW_PAIRS = 5                 # timing pairs of each bandwidth reading, whose median it is
# the bandwidth probe's readings that stream a plane once in and once out,
# with no other reads: P1, P2 and their library calls
STREAM_PROBES = ("pure_copy_plane", "copy_plane")
# planes on which the probes are held bit-equal besides 12 MP: P1's and
# P2's last chunk ragged after many whole ones (1000 x 8200), a plane
# smaller than one chunk (3 x 2056), one 16-byte word at 2 bytes (1 x 8)
PROBE_EDGES = ((1000, 8200), (3, 2056), (1, 8))
# P3's constant stacks besides the JAX script's ones, by c_k[0, 0] for k =
# 0 .. n - 1 (every other element NaN: P3 reads c_k[0, 0] alone): none (a
# bump of +0), negative ones (-0), a NaN, an inf, and a sum that
# overflows left to right (3e38 + 3e38 = inf, then NaN) while another
# order stays finite.  The last four make every output NaN.
P3_EDGE_CONSTS = {"none": [], "negative": [-1.5, -0.25, -3.0],
                  "nan": [1.0, float("nan"), 2.0], "inf": [1.0, float("inf")],
                  "overflow": [3e38, 3e38, -3e38]}
# values set into the probes' float planes on PROBE_EDGES and into P3's
# 12 MP edge planes: the first elements and every X_SPECIALS_STRIDE-th
X_SPECIALS = (-0.0, 0.0, math.inf, -math.inf, math.nan)
X_SPECIALS_STRIDE = 4099
MS_METHOD = ("median of 7 single calls after a warm-up, CUDA events, each call enqueued "
             "while the card spins so that the host's launch time is not counted")
SPIN_CYCLES = 2_000_000      # about 1 ms of the card's clock, for time_ms

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
    "e1_rcarry": ("K8", "lenslesspicam_tpu_torch/ops/csrc/e1_rcarry.cuh",
                  "lenslesspicam_tpu/ops/pallas_kernels2.py:1968"),
    "irfft_w_dual": ("K9", "lenslesspicam_tpu_torch/ops/csrc/irfft_w_dual.cu",
                     "lenslesspicam_tpu/ops/pallas_kernels2.py:2006"),
    "e1_carry": ("K10", "lenslesspicam_tpu_torch/ops/csrc/e1_carry.cu",
                 "lenslesspicam_tpu/ops/pallas_kernels2.py:1288"),
    "ifft_w_dual": ("K11", "lenslesspicam_tpu_torch/ops/csrc/ifft_w_dual.cu",
                    "lenslesspicam_tpu/ops/pallas_kernels2.py:1329"),
    "fft_w": ("K12", "lenslesspicam_tpu_torch/ops/csrc/fft_w.cu",
              "lenslesspicam_tpu/ops/pallas_kernels2.py:788"),
    "ifft_w": ("K13", "lenslesspicam_tpu_torch/ops/csrc/ifft_w.cu",
               "lenslesspicam_tpu/ops/pallas_kernels2.py:812"),
    "h_passA": ("K14", "lenslesspicam_tpu_torch/ops/csrc/h_pass_a.cu",
                "lenslesspicam_tpu/ops/pallas_kernels2.py:504"),
    "h_passB": ("K15", "lenslesspicam_tpu_torch/ops/csrc/h_pass_b.cu",
                "lenslesspicam_tpu/ops/pallas_kernels2.py:645"),
    "h_passB_combine": ("K16", "lenslesspicam_tpu_torch/ops/csrc/h_pass_b.cu",
                        "lenslesspicam_tpu/ops/pallas_kernels2.py:876"),
    "h_passB_dual": ("K17", "lenslesspicam_tpu_torch/ops/csrc/h_pass_b.cu",
                     "lenslesspicam_tpu/ops/pallas_kernels2.py:1143"),
    "h_passB_combine2": ("K18", "lenslesspicam_tpu_torch/ops/csrc/h_pass_b.cu",
                         "lenslesspicam_tpu/ops/pallas_kernels2.py:936"),
    "pure_copy_plane": ("P1", "lenslesspicam_tpu_torch/ops/csrc/probe_bw.cu",
                        "scripts/dev/_probe_bw.py:27"),
    "copy_plane": ("P2", "lenslesspicam_tpu_torch/ops/csrc/probe_bw.cu",
                   "scripts/dev/_probe_bw.py:36"),
    "copy_plane_consts": ("P3", "lenslesspicam_tpu_torch/ops/csrc/probe_bw.cu",
                          "scripts/dev/_probe_bw.py:65"),
}


# why a kernel row has no library_ms: no one PyTorch call computes the
# kernel's function
LIBRARY_NONE = {
    "e1_rtv": "a TV step fused with a packed real transform",
    "h_passA_pair": "a stage of a factored transform with its twiddles",
    "h_combine_dual": "two stage-2 contractions, a spectrum combine and two inverse stages",
    "irfft_w_dual_state": "two inverse transforms fused with the X/v update and a forward one",
    "e1_rcarry": "a TV step, the X/v update and two forward transforms fused",
    "e1_carry": "a TV step, the X/v update and two forward transforms fused",
    "h_passA": "a stage of a factored transform with its twiddles",
    "h_passB_combine": "a stage-2 contraction fused with a spectrum combine",
    "h_passB_dual": "two inverse stage-2 contractions, one of them filtered",
    "h_passB_combine2": "two stage-2 contractions of two spectra and their combine",
    "copy_plane_consts": "a copy plus 0 times a sum of one element of each of n constant "
                         "planes; no one call",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=7):
    """Median device time of one call, CUDA events, after a warm-up
    (MS_METHOD): each call and its events are enqueued behind a spin of
    SPIN_CYCLES, so the card starts the call as soon as the first event
    and the host's time to launch it stays outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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
HERM_OPS = 4       # per bin, the Hermitian part of a spectrum whose real inverse is asked for
CMUL_OPS = 6       # per point, a complex product (K15's filter, K17's H y)
F_OPS = 10         # per point, K16's F = R (a + conj(H) b)


def kernel_cases(ph, pw, gen, io, tv, v, k2_out, planes=None):
    """Seeded inputs, on the device of ``gen``, at the shapes the fused
    loop gives each kernel, the spectra and static planes at ``io``, the
    TV carries at ``tv``, the v carry at ``v``, K2's output at
    ``k2_out``; with ``planes`` = (P, Pc)
    a stack of P planes and of Pc constant planes (filter planes, mask)
    for each kernel that takes a plane axis.  With the operations each
    function needs, counted from the function and not from the kernels'
    design: 5 n log2 n per complex length-n FFT, UNPACK_OPS per bin of a
    packed real transform, and the elementwise algebra around them."""
    dev = gen.device
    m = pw // 2
    h1, h2 = K.factors(ph)
    p = ADMMParams()
    npl, npc = planes or (1, 1)
    lp = (npl,) if planes else ()          # leading axis of the plane operands
    lc = (npc,) if planes else ()          # and of the constants

    def rn(*s, scale=1.0, dtype=io):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    rows = npl * ph
    w_row = rows * (fft_ops(m) + UNPACK_OPS * m)     # one packed-real W transform per row
    sc_a, sc_b = K._tv_scales(p.mu2, p.mu3, p.tau)
    # K3's and K8's TV carries at their KKT scale (|a| ~ tau, |b| ~ mu3
    # |image|): unit-scale carries make a' = mu2 u - eta cancel to ~1e-4 of
    # its operands and no f32 evaluation order can keep 1e-4 relative there
    img = rn(*lp, ph, pw)
    a0, a1 = (K._store_carry(rn(*lp, ph, pw, scale=p.tau, dtype=F32), tv, sc_a)
              for _ in range(2))
    b = K._store_carry(rn(*lp, ph, pw, scale=p.mu3, dtype=F32), tv, sc_b)
    q = [rn(*lp, h1, h2, m) for _ in range(4)]
    c = [rn(*lp, h1, h2, m) for _ in range(4)] + [rn(*lc, h1, h2, m) for _ in range(3)]
    # K6 and K8 at their loop scale: data only inside the support mask and
    # v of order mu1, so v' stays inside the int16 full scale 256 mu1
    s = [rn(*lp, ph, m) for _ in range(4)] + [rn(*lp, ph, dtype=F32) for _ in range(4)]
    vc = K.encode_v(rn(*lp, ph, pw, scale=p.mu1, dtype=F32), p.mu1, v)
    mask32 = (torch.rand(*lc, ph, pw, generator=gen, device=dev) > 0.5).float()
    mask = mask32.to(io)
    dp = K.bmul(mask32, torch.rand(*lp, ph, pw, generator=gen, device=dev)).to(io)
    # an int16 plane reaching full scale both ways, and one -32768 (> 1)
    x16 = torch.randint(-20000, 20001, (ph, pw), generator=gen, device=dev,
                        dtype=torch.int16)
    x16[1, 2], x16[3, 4], x16[ph // 2, pw // 3] = 32767, -32767, -32768
    pts = rows * pw
    return {
        "rfft_w": ((rn(*lp, ph, pw),), w_row),
        "irfft_w": ((rn(ph, m), rn(ph, m), k2_out), ph * (fft_ops(m) + UNPACK_OPS * m)),
        "e1_rtv": ((img, a0, a1, b, p.mu2, p.mu3, p.tau),
                   w_row + pts * (TV_OPS + (3 * SAT_OPS if tv == I16 else 0))),
        "h_passA_pair": ((*q, ph, False), 2 * rows * m * (5.0 * math.log2(h1) + 6)),
        # the loop's second K4: T_inv, the inverse stage and 1/n
        "h_passA_pair:inverse": ((*q, ph, True), 2 * rows * m * (5.0 * math.log2(h1) + 8)),
        "h_combine_dual": ((*c, ph), rows * m * (4 * 5.0 * math.log2(h2) + COMBINE_OPS)),
        "irfft_w_dual_state": ((*s, vc, mask, dp, p.mu1),
                               3 * w_row + pts * (X_OPS + (SAT_OPS if v == I16 else 0))),
        "sat_scan_i16": ((x16,), SAT_OPS * ph * pw),
        "e1_rcarry": ((rn(*lp, ph, pw), rn(*lp, ph, pw), vc, b, a0, a1, mask, dp,
                       p.mu1, p.mu2, p.mu3, p.tau),
                      2 * w_row + pts * (TV_OPS + X_OPS)),
        "irfft_w_dual": ((*s,), 2 * w_row),
    }


def split_kernel_cases(ph, pw, gen, io, tv, v, out, planes=None):
    """The full-width kernels' inputs at the shapes the full-width loop
    gives them (K12 and K13 at the plane's; K4, K5 and K14 under
    "name:full_width", at the lane width W), as :func:`kernel_cases`:
    spectra and static planes at ``io``, the TV carries at ``tv`` and at
    their KKT scale, v at ``v`` and of order mu1, K13's output at
    ``out``; with ``planes`` = (P, Pc) stacks.  Operations: a real
    length-W transform is counted as the packed complex length-W/2 one
    and its unpack; the real part of an inverse of any spectrum adds
    HERM_OPS per bin."""
    dev = gen.device
    p = ADMMParams()
    npl, npc = planes or (1, 1)
    lp = (npl,) if planes else ()
    lc = (npc,) if planes else ()

    def rn(*s, scale=1.0, dtype=io):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    rows = npl * ph
    w_real = rows * (fft_ops(pw // 2) + UNPACK_OPS * pw // 2)
    w_inv = w_real + rows * pw * HERM_OPS
    mask32 = (torch.rand(*lc, ph, pw, generator=gen, device=dev) > 0.5).float()
    dp = K.bmul(mask32, torch.rand(*lp, ph, pw, generator=gen, device=dev)).to(io)
    vc = K.encode_v(rn(*lp, ph, pw, scale=p.mu1, dtype=F32), p.mu1, v)
    cases = {
        "e1_carry": ((rn(*lp, ph, pw), rn(*lp, ph, pw), vc, rn(*lp, ph, pw, scale=p.mu3, dtype=tv),
                      rn(*lp, ph, pw, scale=p.tau, dtype=tv), rn(*lp, ph, pw, scale=p.tau, dtype=tv),
                      mask32.to(io), dp, p.mu1, p.mu2, p.mu3, p.tau),
                     2 * w_real + rows * pw * (TV_OPS + X_OPS)),
        "ifft_w_dual": (tuple(rn(*lp, ph, pw) for _ in range(4)), 2 * w_inv),
        "fft_w": ((rn(*lp, ph, pw),), w_real),
        "ifft_w": ((rn(*lp, ph, pw), rn(*lp, ph, pw), out), w_inv),
    }
    # K4 and K5 at the lane width W the full-width loop gives them
    # (kernel_cases holds them at the v3 loop's M = W / 2), and K14 there
    # (the pallas loop's lane width) under the same key form
    h1, h2 = K.factors(ph)
    q = [rn(*lp, h1, h2, pw) for _ in range(4)]
    c = [rn(*lp, h1, h2, pw) for _ in range(4)] + [rn(*lc, h1, h2, pw) for _ in range(3)]
    cases.update({
        "h_passA_pair:full_width": ((*q, ph, False), 2 * rows * pw * (5.0 * math.log2(h1) + 6)),
        "h_passA_pair:full_width_inverse": ((*q, ph, True),
                                            2 * rows * pw * (5.0 * math.log2(h1) + 8)),
        "h_combine_dual:full_width": ((*c, ph),
                                      rows * pw * (4 * 5.0 * math.log2(h2) + COMBINE_OPS)),
        "h_passA:full_width": ((*q[:2], ph, False), rows * pw * (5.0 * math.log2(h1) + 6))})
    return cases


def pallas_kernel_cases(ph, pw, gen, io, *_, planes=None):
    """The pass-level kernels' inputs at the shapes the pallas loop gives
    them, as :func:`split_kernel_cases`: H-axis views (n1, n2, W) of a
    (ph, pw) plane at ``io``, R at its loop scale (up to 1/mu3); with
    ``planes`` = (P, Pc) stacks.  A key "name:form" is the wrapper
    ``name`` in another form than the one of the loop's forward passes
    (K14 and K15 inverse, K15 with its filter in either direction: the
    loop runs K15 forward alone, ``filtered_synthesis_pallas2`` also its
    filtered inverse); K18 takes the stage-1 planes
    of rk and v, as ``fft_h_combine2`` gives them.  Operations: 5 log2 n per
    point of a length-n stage, 6 per twiddle and per complex product,
    F_OPS per point of the combine."""
    dev = gen.device
    p = ADMMParams()
    npl, npc = planes or (1, 1)
    lp = (npl,) if planes else ()
    lc = (npc,) if planes else ()
    h1, h2 = K.factors(ph)

    def rn(*lead, scale=1.0):
        return (torch.randn(*lead, h1, h2, pw, generator=gen, device=dev) * scale).to(io)

    pts = npl * ph * pw
    s1 = pts * (5.0 * math.log2(h1) + CMUL_OPS)
    s2 = pts * 5.0 * math.log2(h2)
    rr = (torch.rand(*lc, h1, h2, pw, generator=gen, device=dev) / p.mu3).to(io)
    return {
        "h_passA": ((rn(*lp), rn(*lp), ph, False), s1),
        "h_passA:inverse": ((rn(*lp), rn(*lp), ph, True), s1 + 2 * pts),
        "h_passB": ((rn(*lp), rn(*lp), ph, False), s2),
        "h_passB:inverse": ((rn(*lp), rn(*lp), ph, True), s2),
        "h_passB:filter": ((rn(*lp), rn(*lp), ph, False, rn(*lc), rn(*lc)),
                           s2 + CMUL_OPS * pts),
        "h_passB:inverse_filter": ((rn(*lp), rn(*lp), ph, True, rn(*lc), rn(*lc)),
                                   s2 + CMUL_OPS * pts),
        "h_passB_combine": ((rn(*lp), rn(*lp), rn(*lp), rn(*lp), rn(*lc), rn(*lc), rr, ph),
                            s2 + F_OPS * pts),
        "h_passB_dual": ((rn(*lp), rn(*lp), rn(*lc), rn(*lc), ph), 2 * s2 + CMUL_OPS * pts),
        "h_passB_combine2": ((rn(*lp), rn(*lp), rn(*lp), rn(*lp), rn(*lc), rn(*lc), rr, ph),
                             2 * s2 + F_OPS * pts),
    }


def probe_kernel_cases(ph, pw, gen, io, *_, planes=None):
    """The bandwidth probe's inputs, on the device of ``gen``: a seeded
    (ph, pw) plane at ``io`` streamed in blocks of 16 rows, P3 with 40
    constant planes.  Operations: P2 one multiply per element, P3 one add
    per element and one per constant plane, P1 none.  Bytes: the plane
    read and written once, and for P3 the one f32 element c_k[0, 0] of
    each constant plane that its function reads (not the whole planes its
    inputs hold)."""
    x = torch.rand(ph, pw, generator=gen, device=gen.device).to(io)
    br, n = PB.BRS[0], PB.N_CONSTS[-1]
    plane = 2 * nbytes(x)
    return {"pure_copy_plane": ((x, br), 0, plane),
            "copy_plane": ((x, br), x.numel(), plane),
            "copy_plane_consts": ((x, br, PB.const_planes(n, gen.device)), x.numel() + n,
                                  plane + 4 * n)}


def library_call(name, args):
    """One PyTorch call computing the same function on the same inputs
    (the yardstick of ``library_ms``), or None where there is none."""
    if name == "rfft_w":      # rfft along W; torch.fft takes no bf16: f32 copy
        x = args[0].float()
        return lambda: torch.fft.rfft(x, dim=-1)
    if name == "irfft_w":     # irfft along W of a half spectrum of the same size
        z = torch.complex(args[0].float(), args[1].float())
        return lambda: torch.fft.irfft(z, n=2 * z.shape[-1], dim=-1)
    if name == "irfft_w_dual":    # irfft along W of both half spectra, one call
        z = torch.stack([torch.complex(args[0].float(), args[1].float()),
                         torch.complex(args[2].float(), args[3].float())])
        return lambda: torch.fft.irfft(z, n=2 * z.shape[-1], dim=-1)
    if name == "sat_scan_i16":
        return lambda: torch.aminmax(args[0])
    if name == "fft_w":       # complex fft along W of the real rows (f32 copy)
        x = args[0].float()
        return lambda: torch.fft.fft(x, dim=-1)
    if name == "ifft_w":      # real part of the inverse along W
        z = torch.complex(args[0].float(), args[1].float())
        return lambda: torch.fft.ifft(z, dim=-1).real
    if name == "ifft_w_dual":     # real parts of both inverses along W, one call
        z = torch.stack([torch.complex(args[0].float(), args[1].float()),
                         torch.complex(args[2].float(), args[3].float())])
        return lambda: torch.fft.ifft(z, dim=-1).real
    if name == "h_passB":     # stage 2 is the length-n2 DFT along the n2 axis (the
        # filtered forms are a product and a DFT: no one call)
        z = torch.complex(args[0].float(), args[1].float())
        return lambda: torch.fft.fft(z, dim=-2)
    if name == "h_passB:inverse":     # the unscaled inverse DFT along n2
        z = torch.complex(args[0].float(), args[1].float())
        return lambda: torch.fft.ifft(z, dim=-2, norm="forward")
    lib = probe_library(name)[1]
    if lib:
        return lambda: lib(args[0])
    return None


# a PyTorch call beside a kernel that computes a related function but not
# the kernel's own (``reference_ms``, used nowhere in the port): K4's and
# K14's stage without its twiddle
REFERENCE = {name: "torch.fft.fft(x, dim=-3) on the same complex planes (f32 copies): "
                   "cuFFT's length-n1 stage without the twiddle T, not the same function"
             for name in ("h_passA_pair", "h_passA")}


def reference_call(name, args):
    """The call of REFERENCE for the kernel ``name`` (the wrapper's name,
    any form) on its inputs, or None."""
    if name.split(":")[0] not in REFERENCE:
        return None
    planes = [torch.complex(r.float(), i.float()) for r, i in zip(args[0:4:2], args[1:4:2])
              if isinstance(r, torch.Tensor) and isinstance(i, torch.Tensor)]
    x = torch.stack(planes) if len(planes) > 1 else planes[0]
    return lambda: torch.fft.fft(x, dim=-3)


def design(name, ph, pw, itemsize=2):
    """{"design": ...} of a kernel with two designs chosen by shape (K1-K3,
    K6, K8 and K9 by M = pw / 2, K10-K13 by W = pw, one rule each; K5 and
    K15-K18 by the n2 of H = ph; K4 and K14 by its n1), and of the probes
    P1-P3 on a (ph, pw) plane of ``itemsize``-byte elements at br = 16
    (``probe_bw.design``: their bulk chunks with the chunk, an SM's
    stages and the grid's blocks), else {}; ``name`` may carry a
    ":form"."""
    name = name.split(":")[0]
    if name in PB.launch_counts():
        return PB.design(name, ph, pw, itemsize, PB.BRS[0])
    if name in M_NAMES:
        return {"design": K.rfft_w_design(pw // 2)}
    if name in W_SPLIT_NAMES:
        return {"design": K.fft_w_design(pw)}
    if name == "h_combine_dual":
        return {"design": K.h_combine_dual_design(K.factors(ph)[1])}
    if name.startswith("h_passB"):        # K15-K18
        return {"design": K.h_pass_b_design(K.factors(ph)[1])}
    if name in K4_NAMES:
        return {"design": K.h_pass_a_design(K.factors(ph)[0])}
    return {}


def check_kernels(ph, pw, timed, io, tv, v, k2_out, mode, names=None, planes=None,
                  cases=kernel_cases, ops=K):
    """Each kernel (of ``names``, default all) of the module ``ops``
    (``kernels`` or ``probe_bw``) against its plain version on the inputs
    of ``cases`` (:func:`kernel_cases`, :func:`split_kernel_cases`,
    :func:`pallas_kernel_cases` or :func:`probe_kernel_cases`); with
    ``timed`` also its time, the plain version's, the library call's (each
    by MS_METHOD) and the bound.  A case is (inputs, operations) or
    (inputs, operations, bytes moved) where the function reads less than
    its inputs hold; else the bytes are the inputs' and outputs'.  One
    JSON line per kernel; returns the rows by kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(ph)
    rows = {}
    for name, (args, flops, *moved) in cases(ph, pw, gen, io, tv, v, k2_out,
                                             planes=planes).items():
        if names is not None and name not in names:
            continue
        fn = name.split(":")[0]     # "name:form": another form of the wrapper name
        wrapper, plain = getattr(ops, fn), getattr(ops, fn + "_plain")
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
               "planes": list(planes) if planes else None,
               **design(fn, ph, pw, io.itemsize),
               "dtypes": sorted({str(t.dtype) for t in tensors((args, out))}),
               "max_abs_err": max(e[0] for e in val),
               "max_rel_err": max(e[1] for e in val),
               "max_lsb_err": max(lsb) if lsb else None,
               "max_flip_share": max(shares) if shares else None}
        if timed:
            byt = moved[0] if moved else nbytes(*tensors(args), *tensors(out))
            t_bytes = byt / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOP_PER_S * 1e3
            lib = library_call(name, args)
            row.update(ms=time_ms(lambda: wrapper(*args)), ms_method=MS_METHOD,
                       plain_ms=time_ms(lambda: plain(*args)),
                       bytes=byt, flops=flops, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=time_ms(lib) if lib else None)
            ref_call = reference_call(name, args)
            if ref_call:
                row.update(reference_ms=time_ms(ref_call), reference=REFERENCE[fn])
        emit(dict(phase="kernel", **row))
        rows[name] = row
    return rows


def round_trip(ph, pw, fwd=K.rfft_w, inv=K.irfft_w, seed=7):
    """A forward W transform and its standalone inverse on their own path
    (K1 -> K2, or K12 -> K13; no solver calls K2): ``inv(fwd(x))
    == x`` at 12 MP through the two entry points, at f32 and at bf16 io,
    each run with the launch counts set to 0 just before it and read just
    after.  Returns the counts of the bf16 run."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x0 = torch.randn(ph, pw, generator=gen, device="cuda")
    names = (fwd.__name__, inv.__name__)
    for dtype in (torch.float32, torch.bfloat16):
        x = x0.to(dtype)
        back, counts = counted(lambda: inv(*fwd(x)), zero_counts(**dict.fromkeys(names, 1)),
                               " -> ".join(names))
        err = float((back - x.float()).abs().max() / x.float().abs().max())
        if not err <= TOL_ROUND_TRIP[dtype]:
            raise AssertionError(f"{' -> '.join(names)} round trip ({dtype}) at {ph}x{pw}: "
                                 f"{err:.3e}")
        emit({"phase": "round_trip", "transforms": list(names), "grid": [ph, pw],
              "io": str(dtype), "max_rel_err": err, "tol": TOL_ROUND_TRIP[dtype],
              "launches": counts})
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


def want_counts(n, placement="v3", sat_scans=0):
    """Launches of one solve of n iterations through the kernels: v3 K1
    once, K3, 2 K4, K5, K6 per iteration; v2 K8, 2 K4, K5, K9 per
    iteration; and ``sat_scans`` K7 scans.  Whatever the number of
    planes."""
    counts = zero_counts(h_passA_pair=2 * n, h_combine_dual=n, sat_scan_i16=sat_scans)
    if placement == "v3":
        counts.update(rfft_w=1, e1_rtv=n, irfft_w_dual_state=n)
    else:
        counts.update(e1_rcarry=n, irfft_w_dual=n)
    return counts


def all_counts():
    """The launch counts of every wrapper: the solver kernels' and the
    bandwidth probe's."""
    return {**K.launch_counts(), **PB.launch_counts()}


def zero_counts(**nonzero):
    """Launch counts of a run that launches only the kernels ``nonzero``."""
    return {**dict.fromkeys(all_counts(), 0), **nonzero}


def counted(fn, want, label):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; raises unless the counts are ``want`` (or ``want(out)``
    where it is a function of ``fn``'s result)."""
    K.reset_launches()
    PB.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = all_counts()
    want = want(out) if callable(want) else want
    if counts != want:
        raise AssertionError(f"{label} launch counts {counts} != {want}")
    return out, counts


def nerr(a, b):
    return float((a - b).abs().max() / b.abs().max())


def end_to_end_headline(pre, conv, data5, scene_n, p_exact10):
    """The JAX bench's gate design (bench.py:376-435) in the headline mode
    at 12 MP, on the f32 phase's scene, PSF and precompute: exactness at
    n = 10, one-sided quality at n = 100 and 300, anti-collapse, carry
    saturation below full scale; the launch counts of the n = 10 run and
    the loop through the kernels against the loop through the plain
    versions at n = 3."""
    torch.cuda.reset_peak_memory_stats()
    n = 10
    (out10, sat10), counts = counted(
        lambda: admm_split.run_rsplit(pre, n_iter=n, return_sat=True, **HEADLINE),
        want_counts(n, sat_scans=2), "headline")
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
    loop_err = nerr(k3, p3)
    if not loop_err <= TOL_LOOP_HEADLINE:
        raise AssertionError(f"headline loop kernels vs plain: {loop_err:.3e}")
    emit({"phase": "end_to_end_headline", "mode": HEADLINE, "grid": list(SENSOR),
          "n_iter": n, "psnr_exact_db": p_exact10, "psnr_headline_db": p10,
          "tol_db": TOL_PSNR_DB, "sat_n10": sat10, "deep": deep,
          "tol_deep_db": TOL_PSNR_DEEP_DB, "tol_collapse_db": TOL_COLLAPSE_DB,
          "loop_kernels_vs_plain_n3": loop_err, "tol_loop": TOL_LOOP_HEADLINE,
          "launches": counts, "peak_mem_headline_bytes": peak})
    return counts, deep


def v2_phase(pre, fused_v3, scene_n, p_exact10):
    """The v2 placement (K8, K4, K5, K4, K9; K7 on every int16 carry every
    iteration) at 12 MP gray: f32 v2 against f32 v3 at n = 10 (the same
    recurrence), the headline v2 within TOL_PSNR_DB of exact at n = 10
    with saturation below 1, and the headline loop through the kernels
    against the plain loop at n = 3.  Not held to headline v3: v2 stores
    the forward plane at bf16 between kernels, v3 keeps it in
    registers.  Returns the launch counts of both n = 10 runs."""
    n = 10
    v2, counts_f32 = counted(lambda: admm_split.run_rsplit(pre, n_iter=n, placement="v2"),
                             want_counts(n, "v2"), "v2 f32")
    ident = nerr(v2, fused_v3)
    if not ident <= TOL_V2_V3:
        raise AssertionError(f"f32 v2 vs v3 (n={n}): {ident:.3e} > {TOL_V2_V3}")
    torch.cuda.reset_peak_memory_stats()
    (out, sat), counts = counted(
        lambda: admm_split.run_rsplit(pre, n_iter=n, return_sat=True, placement="v2",
                                      **HEADLINE),
        want_counts(n, "v2", sat_scans=4 * n), "v2 headline")
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != SENSOR or not bool(torch.isfinite(out).all()):
        raise AssertionError("v2 headline output is not finite at the sensor shape")
    p10 = psnr_db(out, scene_n)
    if not (abs(p_exact10 - p10) <= TOL_PSNR_DB and sat < 1.0):
        raise AssertionError(f"v2 headline gate (n={n}): exact {p_exact10:.3f} vs "
                             f"{p10:.3f} dB, sat {sat:.3f}")
    k3 = admm_split.run_split_rfused(pre, n_iter=3, placement="v2", **HEADLINE)
    p3 = admm_split.run_split_rfused(pre, n_iter=3, placement="v2", ops=K.PLAIN, **HEADLINE)
    loop_err = nerr(k3, p3)
    if not loop_err <= TOL_LOOP_HEADLINE:
        raise AssertionError(f"v2 headline loop kernels vs plain: {loop_err:.3e}")
    emit({"phase": "v2", "grid": list(SENSOR), "n_iter": n,
          "f32_v2_vs_v3_normalized": ident, "tol_v2_v3": TOL_V2_V3,
          "psnr_exact_db": p_exact10, "psnr_v2_headline_db": p10, "tol_db": TOL_PSNR_DB,
          "sat_n10": sat, "loop_kernels_vs_plain_n3": loop_err,
          "tol_loop": TOL_LOOP_HEADLINE, "launches_f32": counts_f32,
          "launches_headline": counts, "peak_mem_v2_headline_bytes": peak})
    return counts, counts_f32


def mode_phase(mode, scene, psf2d, conv):
    """The JAX bench's RGB or gray batch=4 rung (``certify_and_time_mode``,
    bench.py:573-700) at 12 MP in the headline mode: per-plane scaled
    copies of the certification scene, the PSF repeated per channel,
    measurements normalized per plane; the exact solver per plane with
    the gray convolver ``conv``; per plane |dPSNR| <= TOL_PSNR_DB at
    n = 10, fused >= exact - TOL_PSNR_DEEP_MODE_DB at n = 100 and 300,
    anti-collapse and saturation below 1.  The n = 10 solve's launch
    counts equal a gray solve's.  Returns the phase's record, with the
    solver's rate."""
    t0 = time.perf_counter()
    ch, b = (3, 1) if mode == "rgb" else (1, 4)
    nplanes = b * ch
    scales = np.linspace(1.0, 0.55, nplanes).astype(np.float32)
    scenes = np.stack([scene * s for s in scales]).reshape(b, ch, *SENSOR).transpose(0, 2, 3, 1)
    psf = np.repeat(psf2d[None, :, :, None], ch, axis=-1)
    fwd = FFTConvolver.from_psf(psf, pad=True, norm="backward")
    meas = fwd.convolve(torch.from_numpy(np.ascontiguousarray(scenes[:, None])).to("cuda"))
    meas = meas / meas.amax(dim=(-3, -2), keepdim=True).clamp_min(1e-9)
    del fwd
    scenes_n = torch.from_numpy(scenes / scenes.max(axis=(1, 2), keepdims=True)).to("cuda")
    planes = [(i, c) for i in range(b) for c in range(ch)]
    t1 = time.perf_counter()
    pre, info = admm_split.precompute_rsplit_general(psf, meas.cpu().numpy())
    t_pre = time.perf_counter() - t1

    # exact per plane, continued from its state: n = 10, 100, 300
    pe = {nd: [] for nd in (10, 100, 300)}
    for i, c in planes:
        d5 = meas[i, 0, :, :, c][None, None, :, :, None]
        state, done = None, 0
        for nd in (10, 100, 300):
            img, state = admm.run_state(conv, d5, n_iter=nd - done, state=state)
            done = nd
            pe[nd].append(psnr_db(img[0, 0, :, :, 0], scenes_n[i, :, :, c]))
        del state, img

    def fused(nd):
        out, sat = admm_split.run_rsplit_general(pre, info, meas, n_iter=nd, return_sat=True,
                                                 **HEADLINE)
        if tuple(out.shape) != (b, 1, *SENSOR, ch) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{mode} output is not finite at ({b}, 1, {SENSOR}, {ch})")
        return [psnr_db(out[i, 0, :, :, c], scenes_n[i, :, :, c]) for i, c in planes], sat

    torch.cuda.reset_peak_memory_stats()
    (po10, sat10), counts = counted(lambda: fused(10), want_counts(10, sat_scans=2), mode)
    peak = torch.cuda.max_memory_allocated()
    po, sats = {10: po10}, {10: sat10}
    for nd in (100, 300):
        po[nd], sats[nd] = fused(nd)
    for k in range(nplanes):
        if not abs(pe[10][k] - po[10][k]) <= TOL_PSNR_DB:
            raise AssertionError(f"{mode} exactness gate, plane {k} (n=10): exact "
                                 f"{pe[10][k]:.3f} vs {po[10][k]:.3f} dB")
        for nd in (100, 300):
            if not po[nd][k] >= pe[nd][k] - TOL_PSNR_DEEP_MODE_DB:
                raise AssertionError(f"{mode} quality gate, plane {k} (n={nd}): "
                                     f"{po[nd][k]:.3f} vs exact {pe[nd][k]:.3f} dB")
        if not po[300][k] >= po[10][k] - TOL_COLLAPSE_DB:
            raise AssertionError(f"{mode} anti-collapse gate, plane {k}: n=300 "
                                 f"{po[300][k]:.3f} vs n=10 {po[10][k]:.3f} dB")
    if not all(s < 1.0 for s in sats.values()):
        raise AssertionError(f"{mode} carry saturation {sats}")
    it_rate = rate(lambda k: admm_split.run_rsplit_general(pre, info, meas, n_iter=k,
                                                           **HEADLINE))
    rec = {"phase": mode, "mode": HEADLINE, "grid": list(SENSOR), "batch": b, "channels": ch,
           "planes": nplanes, "scales": scales.tolist(),
           "psnr_exact_db": pe, "psnr_fused_db": po, "sat": sats,
           "tol_db": TOL_PSNR_DB, "tol_deep_db": TOL_PSNR_DEEP_MODE_DB,
           "tol_collapse_db": TOL_COLLAPSE_DB, "launches": counts,
           "peak_mem_bytes": peak, "precompute_s": t_pre,
           "it_per_s": it_rate, "plane_it_per_s": it_rate["median"] * nplanes,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def want_split_counts(n):
    """Launches of an n-iteration full-width fused solve: K10, 2 K4, K5,
    K11 per iteration, whatever the number of planes."""
    return zero_counts(e1_carry=n, h_passA_pair=2 * n, h_combine_dual=n, ifft_w_dual=n)


def split_small_loop():
    """The full-width fused loop through the kernels against the loop
    through the plain versions at 48 x 256 (padded 96 x 512), n = 3, at f32
    (TOL_LOOP) and in the bench mode (TOL_LOOP_HEADLINE); the f32 loop
    against the exact solver at n = 10 (TOL_SPLIT_EXACT)."""
    rng = np.random.RandomState(13)
    psf = rng.rand(*SMALL_SPLIT).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(*SMALL_SPLIT).astype(np.float32)
    data /= data.max()
    pre = admm_split.precompute_split(psf, data)
    rec = {}
    for mode, modes, tol in (("f32", {}, TOL_LOOP), ("bench", SPLIT_BENCH, TOL_LOOP_HEADLINE)):
        k = admm_split.run_split_fused(pre, n_iter=3, **modes)
        p = admm_split.run_split_fused(pre, n_iter=3, ops=K.PLAIN, **modes)
        err = nerr(k, p)
        if not (err <= tol and bool(torch.isfinite(k).all())):
            raise AssertionError(f"split loop ({mode}) kernels vs plain at {SMALL_SPLIT}: {err:.3e}")
        rec[f"loop_{mode}_kernels_vs_plain_n3"] = err
    conv = admm.make_convolver(psf[None, :, :, None])
    ref = admm.run(conv, torch.from_numpy(data)[None, None, :, :, None].to("cuda"),
                   n_iter=10)[0, 0, :, :, 0]
    err = nerr(admm_split.run_split(pre, n_iter=10, backend="fused"), ref)
    if not err <= TOL_SPLIT_EXACT:
        raise AssertionError(f"split fused vs exact at {SMALL_SPLIT}: {err:.3e}")
    return {**rec, "fused_vs_exact_n10": err}


def split_phase(pre, t_pre, scene_n, p_exact10, p_exact100):
    """The full-width split solver at 12 MP (``run_split(backend="fused")``:
    K10, K4, K5, K4, K11) on the full-width precompute ``pre`` (which took
    ``t_pre`` s): f32 within TOL_PSNR_DB of the exact solver at n = 10; the
    bench mode (SPLIT_BENCH) within TOL_PSNR_DB at n = 10 and at least
    exact - TOL_PSNR_DEEP_DB at n = 100; the launch counts of both n = 10
    solves; the small-grid loops of :func:`split_small_loop`; the rates of
    both modes.  Returns the phase's record."""
    t0 = time.perf_counter()
    small = split_small_loop()
    n = 10

    def solve(k, **modes):
        return admm_split.run_split(pre, n_iter=k, backend="fused", **modes)

    torch.cuda.reset_peak_memory_stats()
    out, counts_f32 = counted(lambda: solve(n), want_split_counts(n), "split f32")
    peak = torch.cuda.max_memory_allocated()
    out_b, counts = counted(lambda: solve(n, **SPLIT_BENCH), want_split_counts(n), "split bench")
    psnr = {}
    for label, img in (("f32", out), ("bench", out_b)):
        if tuple(img.shape) != SENSOR or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"split {label} output is not finite at the sensor shape")
        psnr[label] = psnr_db(img, scene_n)
        if not abs(p_exact10 - psnr[label]) <= TOL_PSNR_DB:
            raise AssertionError(f"split {label} exactness gate (n={n}): exact {p_exact10:.3f} "
                                 f"vs {psnr[label]:.3f} dB")
    del out, out_b
    p100 = psnr_db(solve(100, **SPLIT_BENCH), scene_n)
    if not p100 >= p_exact100 - TOL_PSNR_DEEP_DB:
        raise AssertionError(f"split bench quality gate (n=100): {p100:.3f} dB more than "
                             f"{TOL_PSNR_DEEP_DB} dB below exact {p_exact100:.3f} dB")
    rates = {"split_fused_it_per_s": rate(solve),
             "split_bench_it_per_s": rate(lambda k: solve(k, **SPLIT_BENCH))}
    rec = {"phase": "split", "grid": list(SENSOR), "padded": list(pre.padded_shape),
           "mode_bench": SPLIT_BENCH, "n_iter": n, "psnr_exact_db": p_exact10,
           "psnr_split_f32_db": psnr["f32"], "psnr_split_bench_db": psnr["bench"],
           "tol_db": TOL_PSNR_DB, "psnr_exact_n100_db": p_exact100,
           "psnr_split_bench_n100_db": p100, "tol_deep_db": TOL_PSNR_DEEP_DB,
           "small": {"grid": list(SMALL_SPLIT), **small, "tol_loop_f32": TOL_LOOP,
                     "tol_loop_bench": TOL_LOOP_HEADLINE, "tol_exact": TOL_SPLIT_EXACT},
           "launches_f32": counts_f32, "launches_bench": counts, "peak_mem_f32_bytes": peak,
           "precompute_s": t_pre, **rates, "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def want_pallas_counts(n):
    """Launches of an n-iteration pallas solve: per iteration K12 twice,
    K14 twice, K15, K16, K17, K4 once, K13 twice, whatever the number of
    planes."""
    return zero_counts(fft_w=2 * n, h_passA=2 * n, h_passB=n, h_passB_combine=n,
                       h_passB_dual=n, h_passA_pair=n, ifft_w=2 * n)


def pallas_chains(ph, pw):
    """``fft_h`` (K14, K15) against one torch.fft.fft along H and
    ``ifft_h_dual`` (K17, K4) against two torch.fft.ifft along H, on f32
    full-width planes: one ``chain`` line each."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    vr, vi, hr, hi = (torch.randn(ph, pw, generator=gen, device="cuda") for _ in range(4))
    V, Hc = torch.complex(vr, vi), torch.complex(hr, hi)
    for name, fn, lib in (
            ("fft_h (K14, K15)", lambda: K.fft_h(vr, vi, ph),
             lambda: torch.fft.fft(V, dim=0)),
            ("ifft_h_dual (K17, K4)", lambda: K.ifft_h_dual(vr, vi, hr, hi, ph),
             lambda: (torch.fft.ifft(V, dim=0), torch.fft.ifft(Hc * V, dim=0)))):
        emit({"phase": "chain", "name": name, "grid": [ph, pw], "ms": time_ms(fn),
              "library_ms": time_ms(lib),
              "note": "library_ms: torch.fft along H (natural order) of the same function"})


def combine2_chain(ph, pw):
    """K18's composition ``fft_h_combine2`` (K14 twice, K18) against
    ``fft_h`` then ``fft_h_combine`` (K14, K15; K14, K16) on the same 12 MP
    planes (R at its loop scale) at f32 and bf16 io: their normalized
    difference within kernels.TOL_COMBINE2, the launch counts and the ms of
    each;
    one ``chain`` line per io.  Returns the launch counts of
    ``fft_h_combine2`` by io."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    planes = [torch.randn(ph, pw, generator=gen, device="cuda") for _ in range(6)]
    planes.append(torch.rand(ph, pw, generator=gen, device="cuda") / ADMMParams().mu3)
    counts = {}
    for mode, io in PALLAS_IO.items():
        rkr, rki, vr, vi, hr, hi, rr = (t.to(io) for t in planes)

        def fused():
            return K.fft_h_combine2(rkr, rki, vr, vi, hr, hi, rr, ph)

        def apart():
            return K.fft_h_combine(vr, vi, *K.fft_h(rkr, rki, ph), hr, hi, rr, ph)

        f2, counts[mode] = counted(fused, zero_counts(h_passA=2, h_passB_combine2=1),
                                   f"fft_h_combine2 ({mode})")
        f1, counts_apart = counted(apart, zero_counts(h_passA=2, h_passB=1, h_passB_combine=1),
                                   f"fft_h + fft_h_combine ({mode})")
        gap, tol = K.spectra_gap(f2, f1), K.TOL_COMBINE2[io]
        if not (gap <= tol and all(t.dtype == io and tuple(t.shape) == (ph, pw)
                                                and bool(torch.isfinite(t).all()) for t in f2)):
            raise AssertionError(f"fft_h_combine2 vs fft_h + fft_h_combine ({mode}) at "
                                 f"{ph}x{pw}: {gap:.3e} > {tol}")
        emit({"phase": "chain", "name": "fft_h_combine2 (K14, K14, K18)", "io": mode,
              "grid": [ph, pw], "ms": time_ms(fused),
              "vs": "fft_h, fft_h_combine (K14, K15, K14, K16)", "vs_ms": time_ms(apart),
              "launches": {k: c for k, c in counts[mode].items() if c},
              "vs_launches": {k: c for k, c in counts_apart.items() if c},
              "max_rel_diff": gap, "tol": tol})
        del f1, f2
    return counts


def filtered_synthesis_check(ph, pw):
    """``filtered_synthesis_pallas2`` (K12, K14, K15, K15 with the filter,
    K14, K13) on a 12 MP plane against torch.fft's ifft2(fft2(x) fft2(k)),
    within TOL_SYNTHESIS of max |ref|; its launch counts, its time and
    torch.fft's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    x = torch.rand(ph, pw, generator=gen, device="cuda")
    Hk = torch.fft.fft2(torch.rand(ph, pw, generator=gen, device="cuda"))
    ih = torch.from_numpy(sf.split_order_indices(ph)).to("cuda")
    iw = torch.from_numpy(sf.split_order_indices(pw)).to("cuda")
    Hs = Hk[ih][:, iw]
    fr, fi = Hs.real.contiguous(), Hs.imag.contiguous()
    out, counts = counted(lambda: K.filtered_synthesis_pallas2(x, fr, fi),
                          zero_counts(fft_w=1, h_passA=2, h_passB=2, ifft_w=1),
                          "filtered_synthesis_pallas2")

    def lib():
        return torch.fft.ifft2(torch.fft.fft2(x) * Hk).real

    err = nerr(out, lib())
    if not (err <= TOL_SYNTHESIS and out.dtype == F32 and tuple(out.shape) == (ph, pw)):
        raise AssertionError(f"filtered_synthesis_pallas2 vs torch.fft at {ph}x{pw}: {err:.3e}")
    rec = {"phase": "filtered_synthesis", "grid": [ph, pw], "max_rel_err": err,
           "tol": TOL_SYNTHESIS, "launches": counts,
           "ms": time_ms(lambda: K.filtered_synthesis_pallas2(x, fr, fi)),
           "library_ms": time_ms(lib)}
    emit(rec)
    return rec


def pallas_small_loop():
    """The pallas loop through the kernels against the loop through the
    plain versions at 48 x 256 (padded 96 x 512), n = 3, at f32 (TOL_LOOP)
    and bf16 io (TOL_LOOP_HEADLINE); the launch counts of an RGB stack
    (3 planes over 3) equal a gray solve's."""
    rng = np.random.RandomState(14)
    psf = rng.rand(*SMALL_SPLIT).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(*SMALL_SPLIT).astype(np.float32)
    data /= data.max()
    pre = admm_split.precompute_split(psf, data)
    rec = {}
    for io, tol in (("f32", TOL_LOOP), ("bf16", TOL_LOOP_HEADLINE)):
        k = admm_split.run_split_pallas(pre, n_iter=3, io=io)
        p = admm_split.run_split_pallas(pre, n_iter=3, ops=K.PLAIN, io=io)
        err = nerr(k, p)
        if not (err <= tol and bool(torch.isfinite(k).all())):
            raise AssertionError(f"pallas loop ({io}) kernels vs plain at {SMALL_SPLIT}: "
                                 f"{err:.3e}")
        rec[f"loop_{io}_kernels_vs_plain_n3"] = err
    rgb_psf = np.stack([psf, psf[::-1], psf[:, ::-1]], axis=-1)[None]
    rgb = np.stack([data, data[::-1], data[:, ::-1]], axis=-1)[None]
    gpre, info = admm_split.precompute_split_general(rgb_psf, rgb)
    _, rec["launches_rgb_n2"] = counted(
        lambda: admm_split.run_split_general(gpre, info, rgb, n_iter=2, backend="pallas",
                                             io="bf16"),
        want_pallas_counts(2), "pallas rgb stack")
    return rec


def split_pallas_phase(pre, scene_n, p_exact10, p_exact100):
    """The pass-level split backend at 12 MP (``run_split(backend="pallas")``)
    on the split phase's precompute: f32 and bf16 io within TOL_PSNR_DB of
    the exact solver at n = 10 with the launch counts of
    :func:`want_pallas_counts`; bf16 io at least exact - TOL_PSNR_DEEP_DB
    at n = 100; the small-grid loops of :func:`pallas_small_loop`; the
    rates of both io modes.  Returns the phase's record."""
    t0 = time.perf_counter()
    small = pallas_small_loop()
    n = 10

    def solve(k, io="f32"):
        return admm_split.run_split(pre, n_iter=k, backend="pallas", io=io)

    psnr, counts, peak = {}, {}, {}
    for io in ("f32", "bf16"):
        torch.cuda.reset_peak_memory_stats()
        img, counts[io] = counted(lambda: solve(n, io), want_pallas_counts(n), f"pallas {io}")
        peak[io] = torch.cuda.max_memory_allocated()
        if tuple(img.shape) != SENSOR or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"pallas {io} output is not finite at the sensor shape")
        psnr[io] = psnr_db(img, scene_n)
        if not abs(p_exact10 - psnr[io]) <= TOL_PSNR_DB:
            raise AssertionError(f"pallas {io} exactness gate (n={n}): exact {p_exact10:.3f} "
                                 f"vs {psnr[io]:.3f} dB")
        del img
    p100 = psnr_db(solve(100, "bf16"), scene_n)
    if not p100 >= p_exact100 - TOL_PSNR_DEEP_DB:
        raise AssertionError(f"pallas bf16 quality gate (n=100): {p100:.3f} dB more than "
                             f"{TOL_PSNR_DEEP_DB} dB below exact {p_exact100:.3f} dB")
    rates = {"split_pallas_f32_it_per_s": rate(solve),
             "split_pallas_bf16_it_per_s": rate(lambda k: solve(k, "bf16"))}
    rec = {"phase": "split_pallas", "grid": list(SENSOR), "padded": list(pre.padded_shape),
           "n_iter": n, "psnr_exact_db": p_exact10, "psnr_pallas_f32_db": psnr["f32"],
           "psnr_pallas_bf16_db": psnr["bf16"], "tol_db": TOL_PSNR_DB,
           "psnr_exact_n100_db": p_exact100, "psnr_pallas_bf16_n100_db": p100,
           "tol_deep_db": TOL_PSNR_DEEP_DB,
           "small": {"grid": list(SMALL_SPLIT), **small, "tol_loop_f32": TOL_LOOP,
                     "tol_loop_bf16": TOL_LOOP_HEADLINE},
           "launches_f32": counts["f32"], "launches_bf16": counts["bf16"],
           "peak_mem_bytes": peak, **rates, "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def bits(x):
    """The bits of a tensor, as integers of its element's width."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def probe_library(name):
    """One PyTorch call computing the probe ``name``'s function, chained as
    ``probe_bw.timed`` chains it, or None where there is none."""
    if name == "pure_copy_plane":
        return "x.clone()", lambda s: s.clone()
    if name == "copy_plane":
        return f"torch.mul(x, {PB.SCALE})", lambda s: torch.mul(s, PB.SCALE)
    return None, None


def p3_consts(c00, device):
    """A stack of len(c00) constant (128, 128) f32 planes of P3 whose
    [0, 0] elements are ``c00`` and whose other elements are NaN."""
    c = torch.full((len(c00),) + PB.CONST_PLANE, math.nan, device=device)
    c[:, 0, 0] = torch.tensor(c00, dtype=torch.float32, device=device)
    return c


def with_specials(x):
    """``x`` (a float plane) with X_SPECIALS set into its first elements and
    every X_SPECIALS_STRIDE-th one, in turn."""
    flat = x.view(-1)
    n = len(X_SPECIALS)
    vals = torch.tensor(X_SPECIALS, device=x.device).to(x.dtype)
    flat[:n] = vals[:flat.numel()]
    idx = torch.arange(0, flat.numel(), X_SPECIALS_STRIDE, device=x.device)
    flat[idx] = vals[torch.arange(len(idx), device=x.device) % n]
    return x


def same_bits(out, ref):
    """The number of NaNs of ``ref`` where ``out`` holds its dtype, its
    NaNs at the same places and the same bits elsewhere; None where it
    does not.  NaN bits may differ (the kernels' __float2bfloat16_rn and
    torch's casts encode a NaN differently)."""
    nan = torch.isnan(ref)
    if out.dtype != ref.dtype or not torch.equal(torch.isnan(out), nan) or \
            not torch.equal(bits(out)[~nan], bits(ref)[~nan]):
        return None
    return int(nan.sum())


def bw_reading(fn, x, gbytes, clock=time.perf_counter):
    """One bandwidth reading of ``fn``: BW_PAIRS calls of ``probe_bw.timed``
    with one (52 - 2 calls) pair each; the median pair decides ``ms`` and
    ``gb_per_s``, and every pair's rate is kept (``pair_gb_per_s``).  A
    median, not the best pair: one base loop slowed by the host shortens
    its difference and would decide the reading.  A pair whose full loop
    was not longer than its base loop (``timed`` raises) is dropped and
    counted (``pairs_dropped``), as ``timed`` drops it among its own pairs;
    with more than one dropped the clock does not scale, and it raises."""
    runs, dropped = [], 0
    for _ in range(BW_PAIRS):
        try:
            runs.append(PB.timed(fn, x, gbytes, reps=1, clock=clock))
        except RuntimeError:
            dropped += 1
    if dropped > 1:
        raise AssertionError(f"bw_reading: {dropped} of {BW_PAIRS} pairs did not scale with "
                             "their number of calls: the clock does not scale")
    ms = statistics.median(r["ms"] for r in runs)
    return {"ms": ms, "gb_per_s": gbytes / (ms * 1e-3),
            "pair_gb_per_s": [r["gb_per_s"] for r in runs], "pairs_dropped": dropped,
            "calls": BW_PAIRS * runs[0]["calls"]}


def bw_gate(label, pair_rates):
    """Raise when a reading's median rate is above MAX_BYTES_PER_S, or when
    two or more of its pairs are: a clock that does not scale shows in many
    pairs, one descheduled base loop in one."""
    over = [r for r in pair_rates if r * 1e9 > MAX_BYTES_PER_S]
    if statistics.median(pair_rates) * 1e9 > MAX_BYTES_PER_S or len(over) >= 2:
        raise AssertionError(f"{label}: pairs at {pair_rates} GB/s, median or {len(over)} above "
                             f"{MAX_BYTES_PER_S / 1e9:.1f}: the clock does not scale")


def bandwidth_phase(smi):
    """The bandwidth probe P1-P3 at 6144 x 8192 in every reading of the JAX
    script's three modes (``probe_bw.sweep``), and P3 at f32 (br = 16,
    n = 40) for the kernels line's f32 column: each kernel's output
    bit-equal to its plain version's (NaN to NaN, ``same_bits``), then its
    rate by ``probe_bw.timed``
    with the launch counts set to 0 just before and read just after; beside
    it the rates of its plain version and of the library call (P1
    ``x.clone()``, P2 ``torch.mul(x, 1.0001)``, P3 none).  Each reading
    names its probe's design (``probe_bw.design``: the bulk chunks with
    the chunk C, an SM's stages S and the grid's blocks G).  Before them
    every probe at every type on PROBE_EDGES, planes whose last chunk is
    ragged, with X_SPECIALS in the float ones, bit-equal to its plain
    version, P3 with the JAX script's ones and with each stack of
    P3_EDGE_CONSTS, and P3 at 12 MP on planes with X_SPECIALS with each
    stack of P3_EDGE_CONSTS.  Rates count two plane-bytes a call, as the
    JAX script does; ``bw_gate`` raises on a reading above MAX_BYTES_PER_S.
    ``measured_bytes_per_s``, the card's streaming ceiling, is the largest
    median reading of a kernel or library call of STREAM_PROBES; the line
    names the reading.  Returns
    (measured_bytes_per_s, launch counts of all timed runs, of the f32
    ones)."""
    t0 = time.perf_counter()
    configs = [*PB.sweep("pure"), *PB.sweep("mul"), *PB.sweep("consts"),
               ("copy_plane_consts", F32, 16, PB.N_CONSTS[-1])]
    readings, edges = [], []
    counts, counts_f32 = zero_counts(), zero_counts()

    def same(name, x, br, consts, what):
        n_nan = same_bits(PB.step(name, br, consts)(x), PB.step(name, br, consts, PB.PLAIN)(x))
        if n_nan is None:
            raise AssertionError(f"{name} {what}: not bit-equal to its plain version")
        return n_nan

    def edge(name, x, br, consts, case):
        rows, w = x.shape
        what = f"{x.dtype} at {rows}x{w}" + (f", constants {case}" if case else "")
        n_nan = same(name, x, br, consts, what)
        edges.append({"probe": KERNEL_INFO[name][0], "dtype": str(x.dtype).removeprefix(
            "torch."), "plane": [rows, w], "consts": case, "nan_out": n_nan,
            **PB.design(name, rows, w, x.element_size(), br)})

    p3_edges = {"ones": PB.const_planes(PB.N_CONSTS[0], "cuda"),
                **{case: p3_consts(c00, "cuda") for case, c00 in P3_EDGE_CONSTS.items()}}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(len(PROBE_EDGES))
    for (rows, w), dtype in itertools.product(PROBE_EDGES, PB.COPY_DTYPES):
        x = (torch.randn(rows, w, generator=gen, device="cuda") * 100).to(dtype)
        if dtype not in PB.FLOAT_DTYPES:      # i32: P1 alone
            edge("pure_copy_plane", x, 1, None, None)
            continue
        x = with_specials(x)
        for name in STREAM_PROBES:
            edge(name, x, 1, None, None)
        for case, consts in p3_edges.items():
            edge("copy_plane_consts", x, 1, consts, case)
    for seed, dtype in enumerate(PB.FLOAT_DTYPES):
        x = with_specials(PB.plane(dtype, "cuda", seed))
        for case, c00 in P3_EDGE_CONSTS.items():
            edge("copy_plane_consts", x, PB.BRS[0], p3_edges[case], case)
        del x
    for seed, (name, dtype, br, n) in enumerate(configs):
        x = PB.plane(dtype, "cuda", seed)
        consts = PB.const_planes(n, "cuda") if n is not None else None
        same(name, x, br, consts, f"{dtype} br={br} n={n}")
        gb = PB.plane_gbytes(x)
        label = f"{name} {dtype} br={br} n={n}"
        r, c = counted(lambda: bw_reading(PB.step(name, br, consts), x, gb),
                       lambda r: zero_counts(**{name: r["calls"]}), f"{name} {dtype} br={br}")
        plain = bw_reading(PB.step(name, br, consts, PB.PLAIN), x, gb)
        lib_name, lib = probe_library(name)
        lib_r = bw_reading(lib, x, gb) if lib else None
        for what, rd in (("kernel", r), ("plain", plain), ("library", lib_r)):
            if rd is not None:
                bw_gate(f"{label} {what}", rd["pair_gb_per_s"])
        for k in counts:
            counts[k] += c[k]
            counts_f32[k] += c[k] if dtype == F32 else 0
        readings.append({"probe": KERNEL_INFO[name][0], "name": name,
                         "dtype": str(dtype).removeprefix("torch."), "br": br, "n_consts": n,
                         **PB.design(name, *x.shape, x.element_size(), br),
                         "ms": r["ms"], "gb_per_s": r["gb_per_s"],
                         "pair_gb_per_s": r["pair_gb_per_s"], "plain_ms": plain["ms"],
                         "plain_gb_per_s": plain["gb_per_s"],
                         "plain_pair_gb_per_s": plain["pair_gb_per_s"], "library": lib_name,
                         "library_ms": lib_r["ms"] if lib_r else None,
                         "library_gb_per_s": lib_r["gb_per_s"] if lib_r else None,
                         "library_pair_gb_per_s": lib_r["pair_gb_per_s"] if lib_r else None,
                         "pairs_dropped": [rd["pairs_dropped"] for rd in (r, plain, lib_r) if rd]})
        del x, consts
    streams = [(rd[key], {"call": rd["library"] if key == "library_gb_per_s" else rd["probe"],
                          "dtype": rd["dtype"], "br": rd["br"]})
               for rd in readings if rd["name"] in STREAM_PROBES
               for key in ("gb_per_s", "library_gb_per_s")]
    ceiling, ceiling_from = max(streams, key=lambda t: t[0])
    best_p1 = max(rd["gb_per_s"] for rd in readings if rd["name"] == "pure_copy_plane")
    measured = ceiling * 1e9
    emit({"phase": "bandwidth", "grid": list(PB.PLANE),
          "method": f"bw_reading: the median of {BW_PAIRS} pairs of probe_bw.timed (52 calls - "
                    "2 calls) chained, 2 plane-bytes a call, every pair's rate kept, a "
                    "pair that does not scale dropped (at most one); the "
                    "ceiling: the largest median of the STREAM_PROBES kernel and library "
                    "readings", "readings": readings, "edges_bit_equal": edges,
          "measured_bytes_per_s": measured, "measured_from": ceiling_from,
          "best_p1_bytes_per_s": best_p1 * 1e9, "best_p1_share_of_measured": best_p1 / ceiling,
          "data_sheet_bytes_per_s": HBM_BYTES_PER_S,
          "measured_share_of_data_sheet": measured / HBM_BYTES_PER_S,
          "max_bytes_per_s": MAX_BYTES_PER_S, "launches": counts, "card": smi,
          "seconds": time.perf_counter() - t0})
    return measured, counts, counts_f32


def device_inputs_check():
    """The public entry points given CUDA tensors that require grad, held
    to the same values given as numpy arrays, bit for bit: ``ADMM(psf)``
    with ``set_data`` and ``apply`` and ``apply_admm`` (48 x 64, n = 5;
    the image must not require grad), every array of
    ``precompute_rsplit`` (48 x 64) and of ``precompute_split``
    (48 x 256)."""
    rng = np.random.RandomState(15)

    def cuda(a):
        return torch.from_numpy(a).to("cuda").requires_grad_()

    checks = {}
    psf, data = (rng.rand(1, *SMALL, 1).astype(np.float32) for _ in range(2))
    ref = ADMM(psf)
    ref.set_data(data)
    rec = ADMM(cuda(psf))
    rec.set_data(cuda(data))
    out = rec.apply(n_iter=5)
    checks["ADMM.set_data"] = torch.equal(out, ref.apply(n_iter=5)) and not out.requires_grad
    checks["apply_admm"] = torch.equal(apply_admm(cuda(psf), cuda(data), n_iter=5),
                                       apply_admm(psf, data, n_iter=5))
    for name, fn, shape, fields in (
            ("precompute_rsplit", admm_split.precompute_rsplit, SMALL, admm_split.ARRAY_FIELDS),
            ("precompute_split", admm_split.precompute_split, SMALL_SPLIT,
             admm_split.SPLIT_FIELDS)):
        p2, d2 = (rng.rand(*shape).astype(np.float32) for _ in range(2))
        a, b = fn(cuda(p2), cuda(d2)), fn(p2, d2)
        checks[name] = all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
    if not all(checks.values()):
        raise AssertionError(f"CUDA tensor inputs differ from numpy inputs: {checks}")
    emit({"phase": "device_inputs", "inputs": "CUDA tensors with requires_grad",
          "bit_equal_to_numpy_inputs": checks})


def want_grid_counts(n, solver):
    """Launches of one n-iteration solve of ``solver`` at a grid of
    :func:`grids_phase`."""
    if solver == "fused":
        return want_split_counts(n)
    if solver == "pallas":
        return want_pallas_counts(n)
    return want_counts(n, sat_scans=2 if solver == "v3_headline" else 0)


def grids_phase():
    """Every sensor of GRIDS at its padded grid, where the split designs
    run their general form: each kernel against its plain version (the
    rsplit kernels in MODES, the full-width ones in SPLIT_MODES, the
    pass-level ones in PALLAS_IO), then the cert scene through the exact
    solver and, at n = 10, finite at the sensor shape and with its launch
    counts: the fused v3 solver at f32 and the full-width ``"fused"`` and
    ``"pallas"`` solvers (f32) within TOL_PSNR_DB of the exact solver's
    PSNR; the fused v3 solver in the headline mode no more than
    TOL_PSNR_DB below it (below 0.77 MP, the JAX bench's smallest
    certified rung, the mode's int16 TV carries move PSNR at n = 10 by
    more than 0.1 dB in the plain versions too: +0.23 dB at 540 x 960), its
    PSNR beside the plain versions', and its n = 3 loop within
    TOL_LOOP_HEADLINE of the same loop through the plain versions.
    One ``grids`` line per sensor; returns the records."""
    recs = []
    n = 10
    for sensor in GRIDS:
        t0 = time.perf_counter()
        ph, pw = (padded_size(s) for s in sensor)
        for cases, modes in ((kernel_cases, MODES), (split_kernel_cases, SPLIT_MODES),
                             (pallas_kernel_cases, PALLAS_MODES)):
            for mode, dts in modes.items():
                check_kernels(ph, pw, False, *dts, f"grid,{mode}", cases=cases)
        rng = np.random.RandomState(16)
        scene, psf = cert_scene_psf(sensor, rng)
        fwd = FFTConvolver.from_psf(psf[None, :, :, None], pad=True, norm="backward")
        meas = fwd.convolve(torch.from_numpy(scene)[None, None, :, :, None].to("cuda"))
        meas = (meas / meas.max().clamp_min(1e-9))[0, 0, :, :, 0]
        scene_n = torch.from_numpy(scene / scene.max()).to("cuda")
        conv = admm.make_convolver(psf[None, :, :, None])
        p_exact = psnr_db(admm.run(conv, meas[None, None, :, :, None], n_iter=n)[0, 0, :, :, 0],
                          scene_n)
        data = meas.cpu().numpy()
        pre, spre = admm_split.precompute_rsplit(psf, data), admm_split.precompute_split(psf, data)
        solves = {"v3_f32": lambda: admm_split.run_rsplit(pre, n_iter=n),
                  "v3_headline": lambda: admm_split.run_rsplit(pre, n_iter=n, **HEADLINE),
                  "fused": lambda: admm_split.run_split(spre, n_iter=n, backend="fused"),
                  "pallas": lambda: admm_split.run_split(spre, n_iter=n, backend="pallas")}
        psnr, launches = {}, {}
        for name, solve in solves.items():
            out, counts = counted(solve, want_grid_counts(n, name), f"{name} at {ph}x{pw}")
            if tuple(out.shape) != sensor or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} at {ph}x{pw}: output not finite at {sensor}")
            psnr[name] = psnr_db(out, scene_n)
            launches[name] = {k: c for k, c in counts.items() if c}
            gap = psnr[name] - p_exact
            if not (gap >= -TOL_PSNR_DB if name == "v3_headline" else abs(gap) <= TOL_PSNR_DB):
                raise AssertionError(f"{name} at {ph}x{pw} (n={n}): {psnr[name]:.3f} dB against "
                                     f"exact {p_exact:.3f} dB")
            if name == "v3_headline":
                psnr["v3_headline_plain"] = psnr_db(admm_split.run_split_rfused(
                    pre, n_iter=n, ops=K.PLAIN, **HEADLINE), scene_n)
                loop_err = nerr(admm_split.run_split_rfused(pre, n_iter=3, **HEADLINE),
                                admm_split.run_split_rfused(pre, n_iter=3, ops=K.PLAIN,
                                                            **HEADLINE))
                if not loop_err <= TOL_LOOP_HEADLINE:
                    raise AssertionError(f"headline loop at {ph}x{pw} kernels vs plain (n=3): "
                                         f"{loop_err:.3e}")
        h, w = K.factors(ph), K.factors(pw)
        rec = {"phase": "grids", "sensor": list(sensor), "padded": [ph, pw],
               "factors": {"h": h, "w": w, "m": K.factors(pw // 2)}, "n_iter": n,
               "psnr_exact_db": p_exact, "psnr_db": psnr, "tol_db": TOL_PSNR_DB,
               "headline_loop_kernels_vs_plain_n3": loop_err, "tol_loop": TOL_LOOP_HEADLINE,
               "launches": launches, "seconds": time.perf_counter() - t0}
        emit(rec)
        recs.append(rec)
        del pre, spre, meas, conv
    return recs


# phase ``classical``: the classical solvers, the public API and the
# evaluation layer, which launch none of the port's kernels (torch.fft,
# matmul and cuDNN convolutions, as the JAX package computes them outside
# any Pallas kernel)
CLASSICAL_N, CLASSICAL_DISP = 10, 4
SPATIAL_N = 10
SPATIAL_RATE = dict(base=2, full=12, pairs=3)
# 3 MP RGB, MULTICHIP_r05.json's second case (__graft_entry__.py:188-235):
# the certification scene of seed 11 at 1536 x 2048, scaled 1, 0.75, 0.55
# per channel, padded to 3072 x 4096
SPATIAL_RGB = (1536, 2048)
SPATIAL_RGB_SCALES = (1.0, 0.75, 0.55)
# the pencil shapes one rank of a 4-way split of the 12 MP grid gives the
# kernels (no card with 4 GPUs is at hand): K1 on the stacked rk and v (2
# planes) and K9 at ph / 4 = 1536 rows, K4 and K5 at the half width / 4 =
# 1024 lanes, K12 and K13 at 1536 rows, K14 and K15 at the width / 4 = 2048
SPATIAL_SPLIT = 4
TOL_SPATIAL = 1e-4           # max |spatial - exact| / max |exact| at n = 10


def want_spatial_counts(n, backend="rpallas"):
    """Launches of an n-iteration spatial solve: rpallas per iteration K1
    on the stacked rk and v, K4 twice, K5, K9; pallas K12 twice, K14 and
    K15 four times each, K13 twice; whatever the number of planes."""
    if backend == "rpallas":
        return zero_counts(rfft_w=n, h_passA_pair=2 * n, h_combine_dual=n, irfft_w_dual=n)
    return zero_counts(fft_w=2 * n, h_passA=4 * n, h_passB=4 * n, ifft_w=2 * n)


def spatial_kernels(ph, pw, n=SPATIAL_SPLIT):
    """K1, K4, K5, K9 and K12-K15 against their plain versions at one
    rank's pencil shapes of an n-way split of the (ph, pw) grid, f32, as
    the spatial loop calls them (a stack of one plane; K1 of two)."""
    one = (1, 1)
    check_kernels(ph // n, pw, False, F32, F32, F32, F32, f"spatial{n}", names=("rfft_w",),
                  planes=(2, 1))
    check_kernels(ph // n, pw, False, F32, F32, F32, F32, f"spatial{n}",
                  names=("irfft_w_dual",), planes=one)
    check_kernels(ph, pw // n, False, F32, F32, F32, F32, f"spatial{n}", planes=one,
                  names=("h_passA_pair", "h_passA_pair:inverse", "h_combine_dual"))
    check_kernels(ph // n, pw, False, F32, F32, F32, F32, f"spatial{n}", planes=one,
                  names=("fft_w", "ifft_w"), cases=split_kernel_cases)
    check_kernels(ph, pw // n, False, F32, F32, F32, F32, f"spatial{n}", planes=one,
                  names=("h_passA", "h_passA:inverse", "h_passB", "h_passB:inverse"),
                  cases=pallas_kernel_cases)


def spatial_solve(mesh, conv, data5, scene_n, backend, exact, label):
    """One spatial solve at n = SPATIAL_N through ``backend`` against the
    exact solve: launch counts, collectives, peak memory, the gates, the
    rate of the loop (its host precompute and placement timed apart)."""
    from lenslesspicam_tpu_torch.parallel import distributed as pdist, spatial

    chosen = spatial._choose_backend(mesh, conv, backend, None)
    params = ADMMParams()
    torch.cuda.reset_peak_memory_stats()
    pdist.reset_collective_counts()
    out, counts = counted(lambda: spatial.spatial_sharded_admm(
        mesh, conv, data5, params, SPATIAL_N, backend=backend),
        want_spatial_counts(SPATIAL_N, chosen), f"{label} {backend}")
    peak = torch.cuda.max_memory_allocated()
    coll = pdist.collective_counts()
    if out.shape != exact.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label} {backend}: output not finite at {tuple(exact.shape)}")
    err = nerr(out, exact)
    p_exact, p_out = psnr_db(exact, scene_n), psnr_db(out, scene_n)
    if not (err <= TOL_SPATIAL and abs(p_exact - p_out) <= TOL_PSNR_DB):
        raise AssertionError(f"{label} {backend}: {err:.3e} of the max, PSNR {p_out:.3f} vs "
                             f"exact {p_exact:.3f} dB")
    t0 = time.perf_counter()
    inputs = (spatial._rpallas_inputs if chosen == "rpallas" else spatial._pallas_inputs)(
        mesh, conv, data5, params)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    ph, pw = conv.padded_shape[1:3]
    build = (lambda k: spatial._build_rpallas_run(mesh, ph, pw, params, k)) \
        if chosen == "rpallas" else (lambda k: spatial._build_pallas_run(mesh, ph, params, k))
    rec = {"backend": backend, "chosen": chosen, "n_iter": SPATIAL_N, "vs_exact": err,
           "psnr_exact_db": p_exact, "psnr_db": p_out, "launches": counts,
           "collectives_per_solve": coll, "peak_mem_bytes": peak,
           "host_precompute_s": t_pre,
           "loop_it_per_s": rate(lambda k: build(k)(*inputs), **SPATIAL_RATE)}
    del inputs
    return rec


def spatial_phase(psf2d, meas, scene_n, device="cuda"):
    """The row-sharded spatial ADMM (``parallel/spatial.py``) over a
    one-rank NCCL group on this card: at 12 MP gray (pad_policy "tpu",
    6144 x 8192) the rpallas, pallas and auto backends (auto must choose
    rpallas) and at 3 MP RGB rpallas, each within TOL_SPATIAL of the max
    of the exact solver and TOL_PSNR_DB of its PSNR at n = 10, with its
    launch counts, collectives, peak memory, host precompute seconds and
    the loop's it/s (n = 12 against 2, 3 pairs); the rpallas loop's
    collectives per iteration beside ``ici_traffic_model``; the on-path
    kernels at a 4-way split's pencil shapes.  Every collective goes
    through NCCL (all_to_all_single, all_gather_into_tensor, the halo's
    batch_isend_irecv to the rank itself).  ``device="cpu"`` rehearses it
    over gloo (the plain versions; ``torch.cuda`` calls patched)."""
    from lenslesspicam_tpu_torch.parallel import distributed as pdist, spatial

    t0 = time.perf_counter()
    rank, world = pdist.initialize(f"127.0.0.1:{pdist._free_port()}", 1, 0, device=device)
    backend = "nccl" if device == "cuda" else "gloo"
    try:
        if (rank, world, torch.distributed.get_backend()) != (0, 1, backend):
            raise AssertionError(f"spatial: group {rank}/{world} "
                                 f"{torch.distributed.get_backend()}")
        mesh = pdist.multihost_mesh(("sp",))
        conv = admm.make_convolver(psf2d[None, :, :, None], pad_policy="tpu", device=device)
        ph, pw = conv.padded_shape[1:3]
        data5 = meas[None, None, :, :, None]
        exact = admm.run(conv, data5, n_iter=SPATIAL_N)
        sc5 = scene_n[None, None, :, :, None]
        gray = {b: spatial_solve(mesh, conv, data5, sc5, b, exact, "spatial 12 MP")
                for b in ("rpallas", "pallas", "auto")}
        if gray["auto"]["chosen"] != "rpallas":
            raise AssertionError(f"spatial auto chose {gray['auto']['chosen']}")
        traffic = {"counted": spatial.collective_bytes_per_iter(mesh, ph, pw, n_iter=2),
                   "model": spatial.ici_traffic_model(ph, pw, pdist.axis_size(mesh, "sp"))}
        del exact

        scene, psf = cert_scene_psf(SPATIAL_RGB, np.random.RandomState(11))
        scene_rgb = np.stack([scene * s for s in SPATIAL_RGB_SCALES], axis=-1)
        psf_rgb = np.repeat(psf[None, :, :, None], 3, axis=-1)
        fwd = FFTConvolver.from_psf(psf_rgb, pad=True, norm="backward", device=device)
        meas3 = fwd.convolve(torch.from_numpy(scene_rgb[None, None]).to(device))
        meas3 = meas3 / meas3.amax(dim=(-3, -2), keepdim=True).clamp_min(1e-9)
        del fwd
        conv3 = admm.make_convolver(psf_rgb, pad_policy="tpu", device=device)
        exact3 = admm.run(conv3, meas3, n_iter=SPATIAL_N)
        sc3 = torch.from_numpy(scene_rgb / scene_rgb.max()).to(device)[None, None]
        rgb = spatial_solve(mesh, conv3, meas3, sc3, "rpallas", exact3, "spatial 3 MP RGB")
        del exact3, meas3
        spatial_kernels(ph, pw)
    finally:
        pdist.shutdown()
    rec = {"phase": "spatial", "grid": list(meas.shape), "padded": [ph, pw], "world_size": world,
           "backend": backend, "gray": gray, "traffic_per_iter": traffic,
           "rgb": {"grid": list(SPATIAL_RGB), "padded": list(conv3.padded_shape[1:3]), **rgb},
           "tol": TOL_SPATIAL, "tol_db": TOL_PSNR_DB, "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


CLASSICAL_SMALL = (32, 40, 3)        # tests/test_api.py's grid
DIFFUSERCAM = GRIDS[0]               # 270 x 480 (bench.py:34)
TOL_CHUNKED = 1e-5                   # apply(disp_iter) against one run, normalized
# the card against the CPU, max |card - cpu| / max |cpu|: iterative solvers
# and LPIPS's 13 convolutions (cuFFT / cuDNN against pocketfft / oneDNN
# sums), one-pass products and filters, and benchmark()'s metric averages
TOL_CARD_CPU = {"solver": 1e-4, "lpips": 1e-4, "one_pass": 1e-5, "benchmark": 1e-4}
GD_CLASSES = ("GradientDescent", "NesterovGradientDescent", "FISTA")


def on_device(x, label, device="cuda"):
    """``x``, after checking that each of its tensors is on ``device``."""
    for t in tensors(x):
        if t.device.type != torch.device(device).type:
            raise AssertionError(f"{label}: an output is on {t.device}, not {device}")
    return x


def classical_12mp(psf2d, meas, scene_n, device="cuda"):
    """The classical solvers through the public API at the f32 phase's
    scene and PSF: ``GradientDescent``, ``NesterovGradientDescent``,
    ``FISTA``, ``ADMM`` (with an initial estimate) and ``APGD`` (nonneg),
    each at n = CLASSICAL_N with no launch of the port's kernels, on the
    card; apply in chunks of CLASSICAL_DISP with a callback against one
    run; reconstruction_error at n = CLASSICAL_N below n = 2; PSNR and SSIM
    against the scene (compute_metrics); it/s by ``rate``, n = 2 against
    12.  Returns one record per solver.  ``device="cpu"`` rehearses it on
    a small scene (with ``torch.cuda.synchronize`` patched out)."""
    psf = psf2d[None, :, :, None]
    data = meas[:, :, None]
    target = scene_n[None, None, :, :, None]
    n = CLASSICAL_N
    recs = {}
    for name in (*GD_CLASSES, "ADMM", "APGD"):
        if name == "APGD":
            conv = apgd.make_convolver(psf, device=device)

            def solve(k, conv=conv):
                return lpt.APGD(conv, data, k)[0]
            rec_err = lpt.FISTA(psf, device=device).reconstruction_error
        else:
            kw = ({"initial_est": torch.full((1, *meas.shape, 1), float(meas.mean()),
                                             device=device)} if name == "ADMM" else {})
            r = getattr(lpt, name)(psf, device=device, **kw)
            r.set_data(data)
            solve, rec_err = r.apply, r.reconstruction_error
        out, _ = counted(lambda: on_device(solve(n), name, device), zero_counts(), name)
        if tuple(out.shape) != (1, *meas.shape, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output not finite at (1, {tuple(meas.shape)}, 1)")
        rec = {}
        if name != "APGD":      # APGD has no chunked apply, as in the JAX package
            seen = []
            chunked = solve(n, disp_iter=CLASSICAL_DISP,
                            callback=lambda img, it: seen.append((it, img.device.type)))
            rec["chunked_vs_one_run"] = nerr(chunked, out)
            rec["callbacks"] = seen
            if not (rec["chunked_vs_one_run"] <= TOL_CHUNKED
                    and [it for it, _ in seen] == [4, 8, 10]
                    and all(d == torch.device(device).type for _, d in seen)):
                raise AssertionError(f"{name}: apply(disp_iter={CLASSICAL_DISP}) against one "
                                     f"run {rec['chunked_vs_one_run']:.3e}, callbacks {seen}")
        rec["reconstruction_error"] = {2: float(rec_err(solve(2), data[None])[0]),
                                       n: float(rec_err(out, data[None])[0])}
        if not rec["reconstruction_error"][n] < rec["reconstruction_error"][2]:
            raise AssertionError(f"{name}: reconstruction_error did not fall from n = 2 to "
                                 f"n = {n}: {rec['reconstruction_error']}")
        m = compute_metrics(out[None], target)
        rec.update(psnr_db=float(m["PSNR"]), ssim=float(m["SSIM"]), mse=float(m["MSE"]),
                   it_per_s=rate(solve, base=2, full=12, pairs=3))
        recs[name] = rec
        del out
    return recs


def _t_denoise(x, level):
    return (x + torch.roll(x, 1, dims=-3) + torch.roll(x, 1, dims=-2)) / (3.0 + 1e-3 * level)


def classical_cases():
    """Every new entry point as ``fn(device) -> tensor(s)`` at the small
    grid, with its tolerance class."""
    rng = np.random.RandomState(18)
    h, w, c = CLASSICAL_SMALL
    psf = rng.rand(1, h, w, c).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(h, w, c).astype(np.float32)
    small = rng.rand(h // 2, w // 2, c).astype(np.float32)
    P, Q = rng.randn(h + 6, h), rng.randn(w + 8, w)
    mask = types.SimpleNamespace(resolution=(h + 6, w + 8))
    meas = rng.rand(h + 6, w + 8, c).astype(np.float32)
    a, b = (rng.rand(2, 1, h, w, c).astype(np.float32) for _ in range(2))
    la, lb = (rng.rand(2, 64, 64, 3).astype(np.float32) for _ in range(2))
    lp_weights = lpips.random_params(0, "vgg")
    gain = {"gain": rng.rand(c).astype(np.float32) + 0.5, "bias": rng.rand(c).astype(np.float32)}

    def t(x, d):
        return torch.from_numpy(x).to(d)

    def klass(name):
        def fn(d):
            r = getattr(lpt, name)(psf, device=d)
            r.set_data(data)
            return r.apply(n_iter=CLASSICAL_N)
        return fn

    def apgd_ds(d):
        conv, ds = apgd.make_downsampling_convolver(psf, small.shape, device=d)
        return lpt.APGD(conv, small, CLASSICAL_N, ds_factor=ds)

    def pnp(d):
        conv = FFTConvolver.from_psf(psf, pad=True, norm="backward", device=d)
        pred, params = parameterize_perturb(lambda p, x: p["gain"] * x + p["bias"],
                                            {k: t(v, d) for k, v in gain.items()}, conv,
                                            t(a[:1], d), mu=1e-2, lr=0.5, n_iter=10)
        return pred, params["gain"], params["bias"]

    return {
        **{name: ("solver", klass(name)) for name in (*GD_CLASSES, "ADMM")},
        "APGD": ("solver", lambda d: lpt.APGD(apgd.make_convolver(psf, device=d), data,
                                              CLASSICAL_N)),
        "APGD:ds_factor": ("solver", apgd_ds),
        "CodedApertureReconstruction": ("one_pass", lambda d: lpt.CodedApertureReconstruction(
            mask, (h, w), P=P, Q=Q, lmbd=1e-2, device=d).apply(meas)),
        "ssim": ("one_pass", lambda d: ssim(t(a, d)[:, 0], t(b, d)[:, 0])),
        "compute_metrics": ("one_pass", lambda d: tuple(compute_metrics(t(a, d), t(b, d))
                                                        .values())),
        "run_pnp": ("solver", lambda d: admm.run_pnp(admm.make_convolver(psf, device=d), data,
                                                     _t_denoise, n_iter=CLASSICAL_N,
                                                     use_dual=True)),
        "parameterize_perturb": ("solver", pnp),
        "LPIPS": ("lpips", lambda d: lpips.model_from_state_dict(lp_weights, "vgg", d)(
            t(la, d), t(lb, d))),
    }


def classical_benchmark(device):
    """benchmark() over 2 batches of 2 synthetic RGB pairs at the
    DiffuserCam grid, an ADMM at n = CLASSICAL_N reconstructing and as
    ``model`` (ReconstructionError), no noise."""
    rng = np.random.RandomState(19)
    scene, psf2d = cert_scene_psf(DIFFUSERCAM, rng)
    psf = np.stack([psf2d, np.roll(psf2d, 3, 0), np.roll(psf2d, 5, 1)], axis=-1)[None]
    fwd = FFTConvolver.from_psf(psf, pad=True, norm="backward", device="cpu")
    batches = []
    for i in range(2):
        lensed = np.stack([np.stack([np.roll(scene, 7 * (2 * i + j) + k, 1) * (1.0 - 0.1 * k)
                                     for k in range(3)], -1)[None]
                           for j in range(2)]).astype(np.float32)
        lensless = fwd.convolve(torch.from_numpy(lensed))
        lensless = lensless / lensless.amax(dim=(-4, -3, -2, -1), keepdim=True)
        batches.append({"lensless": lensless.numpy(), "lensed": lensed})
    model = ADMM(psf, n_iter=CLASSICAL_N, device=device)

    def reconstruct(x):
        return on_device(model.batch_apply(x), "benchmark", device)

    return benchmark(reconstruct, batches, model=model, device=device)


def classical_phase(psf2d, meas, scene_n):
    """The phase ``classical``: :func:`classical_12mp`, every entry point of
    :func:`classical_cases` on the card against the CPU (each output on
    the card), and :func:`classical_benchmark` on both, its metric dict
    within TOL_CARD_CPU["benchmark"] relative.  TF32 is off (``main``).
    Returns the phase's record."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("f32 parity needs TF32 off")
    t0 = time.perf_counter()
    solvers = classical_12mp(psf2d, meas, scene_n)
    small = {}
    for name, (kind, fn) in classical_cases().items():
        card = on_device(fn("cuda"), name)
        cpu = fn("cpu")
        err = max(nerr(x.cpu(), y) for x, y in zip(tensors(card), tensors(cpu)))
        small[name] = {"max_rel_err": err, "tol": TOL_CARD_CPU[kind]}
        if not err <= TOL_CARD_CPU[kind]:
            raise AssertionError(f"{name} at {CLASSICAL_SMALL}: card against CPU {err:.3e}")
    bench_card, bench_cpu = classical_benchmark("cuda"), classical_benchmark("cpu")
    bench_err = {k: abs(bench_card[k] - bench_cpu[k]) / abs(bench_cpu[k]) for k in bench_cpu}
    if list(bench_card) != list(bench_cpu) or \
            not max(bench_err.values()) <= TOL_CARD_CPU["benchmark"]:
        raise AssertionError(f"benchmark card {bench_card} against CPU {bench_cpu}")
    rec = {"phase": "classical", "grid": list(SENSOR), "n_iter": CLASSICAL_N,
           "disp_iter": CLASSICAL_DISP, "tol_chunked": TOL_CHUNKED, "solvers": solvers,
           "small_grid": list(CLASSICAL_SMALL), "card_vs_cpu": small,
           "benchmark": {"grid": list(DIFFUSERCAM), "batches": 2, "batch_size": 2,
                         "card": bench_card, "cpu": bench_cpu, "rel_err": bench_err,
                         "tol": TOL_CARD_CPU["benchmark"]},
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


# the learned models (phase ``learned``), which launch none of the port's
# kernels either: cuFFT for the unrolled solvers and the Wiener filters,
# cuDNN for the convolutions, as the JAX package computes them outside any
# Pallas kernel
LEARNED_NAME = "Unet4M+U5+Unet4M"    # zoo/model_dict.py:60, DiffuserCam MirFlickr (TCI)
LEARNED_BATCH = 4
LEARNED_SMALL = (64, 112, 3)
TOL_LEARNED = 1e-4                   # card against CPU, max |card - cpu| / max |cpu|
LEARNED_SEED = 21
# The Restormer pipeline is ill-conditioned wherever its post-processor's
# input is exactly zero (the unrolled solver's clamp at 0, most of the
# image on a random measurement): the Restormer's convolutions and
# layernorms are bias-free, so zero is a fixed point at which each
# layernorm multiplies a feature by up to 1 / sqrt(1e-5), and a rounding
# difference there grows to O(1) within a few blocks.  So its Restormers'
# output convolutions are seeded RESTORMER_OUTPUT_SCALE times smaller (a
# trained restorer corrects its input by a little; a seeded one by about
# +-14, which the [0, 1] clamp saturates), each stage is held on the card
# against the CPU on the CPU's own input (learned_stages), and for
# LEARNED_STAGED_SEEDS weight seeds the end-to-end error is held to the
# larger of TOL_LEARNED and 10x the CPU's own spread under a 1e-6 relative
# perturbation of the measurement.
LEARNED_STAGED = ("Transformer4M+U5+Transformer4M",)
LEARNED_STAGED_SEEDS = 3
RESTORMER_OUTPUT_SCALE = 1e-3


def learned_model(model, seed=LEARNED_SEED):
    """``model`` with seeded weights carried from a JAX-layout tree drawn
    with numpy (``convert.random_variables`` -> ``convert.state_dict``), in
    eval mode."""
    model.load_state_dict(convert.state_dict(model, convert.random_variables(model, seed)))
    return model.eval()


def staged_model(name, seed):
    """The Restormer pipeline ``name`` on the CPU with seeded weights, its
    Restormers' output convolutions RESTORMER_OUTPUT_SCALE times the draw."""
    model = learned_model(build_model(name, device="cpu"), seed)
    with torch.no_grad():
        for net in (model.pre_process_model, model.post_process_model):
            net.output.weight.mul_(RESTORMER_OUTPUT_SCALE)
    return model


def learned_inputs(hw, batch, psf_channels=3, seed=LEARNED_SEED):
    """A seeded PSF (1, H, W, psf_channels), measurement (batch, 1, H, W, 3)
    and background (a fifth of the measurement's scale), numpy float32."""
    rng = np.random.RandomState(seed)
    psf = rng.rand(1, *hw, psf_channels).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(batch, 1, *hw, 3).astype(np.float32)
    return psf, data, (0.2 * rng.rand(*data.shape)).astype(np.float32)


def learned_cases():
    """Every other learned family as ``(model on the CPU, its inputs)`` at
    LEARNED_SMALL, batch 2, seeded weights (the Restormer pipelines' by
    :func:`staged_model`); a model whose parameters are made on its first
    call (FISTA's steps, SVDeconvNet's PSF copies) has run once."""
    from lenslesspicam_tpu_torch.models.background import IntegratedBackgroundSub
    from lenslesspicam_tpu_torch.models.compensation import CompensationBranch
    from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
    from lenslesspicam_tpu_torch.models.unet import UNet, UNetRes
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM, UnrolledFISTA

    h, w, _ = LEARNED_SMALL
    psf, data, bg = learned_inputs((h, w), 2)
    psf1 = learned_inputs((h, w), 2, psf_channels=1)[0]
    nc4 = _UNET_NC["4M"]
    cpu = {"device": "cpu"}

    def unet4m(**kw):
        return UNetRes(in_nc=4, out_nc=3, nc=nc4, nb=4, **kw, **cpu)

    def admm5():
        return UnrolledADMM(n_iter=5, **cpu)

    cases = {name: (build_model(name, device="cpu"), (data, psf1 if "MWDN" in name else psf))
             for name in ("TrainInv+Unet8M", "SVDecon+UNet8M", "MWDN8M") + LEARNED_STAGED}
    cases.update({
        "UnrolledFISTA": (TrainableRecon(camera_inversion=UnrolledFISTA(n_iter=5, **cpu),
                                         **cpu), (data, psf)),
        # the compensation branch of the reference's MMCN (5 rungs for 5 iterations)
        "MMCN4M+Unet4M": (TrainableRecon(
            camera_inversion=admm5(),
            compensation_branch=CompensationBranch(nc=(24, 64, 128, 256, 400), **cpu),
            post_process=unet4m(concatenate_compensation=400), **cpu), (data, psf)),
        "IntegratedBackgroundSub": (TrainableRecon(
            camera_inversion=admm5(), pre_process=IntegratedBackgroundSub(**cpu),
            integrated_background_subtraction=True, **cpu), (data, psf, bg)),
        "direct_background_subtraction": (TrainableRecon(
            camera_inversion=admm5(), pre_process=unet4m(), post_process=unet4m(),
            direct_background_subtraction=True, **cpu), (data, psf, bg)),
        "learned_background_subtraction": (TrainableRecon(
            camera_inversion=admm5(), pre_process=unet4m(), post_process=unet4m(),
            background_network=UNetRes(in_nc=4, out_nc=3, nc=_UNET_NC["2M"], nb=4, **cpu),
            **cpu), (data, psf, bg)),
        "UNet": (UNet(in_nc=3, out_nc=3, **cpu),
                 (torch.from_numpy(data[:, 0]).permute(0, 3, 1, 2),)),
        "drunet_denoise": (UNetRes(in_nc=4, out_nc=3, **cpu), (data[:, 0], 15.0)),
    })
    with torch.no_grad():
        for name in ("UnrolledFISTA", "SVDecon+UNet8M"):
            cases[name][0](*cases[name][1])
    return {name: (staged_model(name, LEARNED_SEED + i) if name in LEARNED_STAGED else
                   learned_model(model, seed=LEARNED_SEED + i), args)
            for i, (name, (model, args)) in enumerate(cases.items())}


def learned_stages(model, args, device):
    """Max relative errors of the card against the CPU for each stage of a
    TrainableRecon with Restormer pre- and post-processors (the port's
    ``processor_block`` and camera inversion), each stage given the CPU's
    input; with the end-to-end error and the CPU's own spread under a 1e-6
    relative perturbation of the measurement."""
    data, psf = (torch.from_numpy(a) for a in args[:2])
    card = copy.deepcopy(model).to(device)
    stages = (
        ("pre", lambda m, x, p: processor_block(m.pre_process_model, m.pre_process_param, x)),
        ("inversion", lambda m, x, p: m.camera_inversion(m._make_convolver(p), x, p)),
        ("post", lambda m, x, p: processor_block(m.post_process_model, m.post_process_param,
                                                 x)))
    errs, x = {}, data
    for name, stage in stages:
        y = stage(model, x, psf)
        errs[name] = nerr(on_device(stage(card, x.to(device), psf.to(device)), name,
                                    device).cpu(), y)
        x = y
    noisy = data * (1 + 1e-6 * torch.randn(data.shape, generator=torch.Generator().manual_seed(0)))
    errs["end_to_end"] = nerr(card(data.to(device), psf.to(device)).cpu(), x)
    errs["cpu_spread_1e-6"] = nerr(model(noisy, psf), x)
    return errs


def learned_call(name, model, args, device):
    """One forward of a case on ``device``, its tensors moved there."""
    args = [torch.as_tensor(a).to(device) if isinstance(a, (np.ndarray, torch.Tensor)) else a
            for a in args]
    if name == "drunet_denoise":
        return drunet_denoise(model, *args)
    return model(*args[:2], **({"background": args[2]} if len(args) > 2 else {}))


def learned_phase(device="cuda"):
    """The phase ``learned``: the zoo's ``Unet4M+U5+Unet4M`` (pre and post
    UNetRes nc (32, 64, 116, 128), nb = 4, around a 5-iteration unrolled
    ADMM), built by ``build_model`` on carried seeded weights, serving a
    batch of LEARNED_BATCH DiffuserCam measurements (270 x 480 x 3) in
    ``eval()`` under ``torch.inference_mode()``: images/s by ``rate`` (1
    against 6 forward calls, 3 pairs), peak device memory, the output on the
    card, the card against the CPU at batch 1; ``U20`` (20 unrolled
    iterations, no processors) the same way; every other family
    (:func:`learned_cases`) on the card against the CPU.  Every counted
    run launches none of the port's kernels.  Returns the phase's record.
    ``device="cpu"`` rehearses it (with the CUDA calls patched out)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("f32 parity needs TF32 off")
    t0 = time.perf_counter()
    psf, data, _ = learned_inputs(DIFFUSERCAM, LEARNED_BATCH)
    psf_t, data_t = torch.from_numpy(psf).to(device), torch.from_numpy(data).to(device)
    serving = {}
    for name in (LEARNED_NAME, "U20"):
        model = learned_model(build_model(name, device=device))
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()   # the model, inputs, earlier phases
            out, counts = counted(lambda: on_device(model(data_t, psf_t), name, device),
                                  zero_counts(), name)
            peak = torch.cuda.max_memory_allocated()
            if tuple(out.shape) != data.shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name}: output not finite at {data.shape}")
            calls = rate(lambda k: [model(data_t, psf_t) for _ in range(k)], base=1, full=6,
                         pairs=3)
            err = nerr(model(data_t[:1], psf_t).cpu(), copy.deepcopy(model).cpu()(data[:1], psf))
        if not err <= TOL_LEARNED:
            raise AssertionError(f"{name} at {DIFFUSERCAM}: card against CPU {err:.3e}")
        serving[name] = {
            "images_per_s": {"median": calls["median"] * LEARNED_BATCH,
                             "iqr": calls["iqr"] * LEARNED_BATCH, "pairs": calls["pairs"],
                             "rates": [r * LEARNED_BATCH for r in calls["rates"]]},
            "calls_per_s": calls, "peak_mem_bytes": peak, "resident_bytes": resident,
            "forward_peak_bytes": peak - resident, "launches": counts,
            "card_vs_cpu_batch1": err, "out_device": out.device.type,
            "parameters": sum(p.numel() for p in model.parameters())}
        del model, out
    small = {}
    for i, (name, (model, args)) in enumerate(learned_cases().items()):
        card_model = copy.deepcopy(model).to(device)
        seeded = [model] + [staged_model(name, LEARNED_SEED + i + 100 * k)
                            for k in range(1, LEARNED_STAGED_SEEDS) if name in LEARNED_STAGED]
        with torch.inference_mode():
            card, _ = counted(lambda: on_device(learned_call(name, card_model, args, device),
                                                name, device), zero_counts(), name)
            small[name] = {"out_device": card.device.type}
            if name in LEARNED_STAGED:
                runs = [counted(lambda: learned_stages(m, args, device), zero_counts(), name)[0]
                        for m in seeded]
                small[name]["stages_by_seed"] = runs
                err = max(r[k] for r in runs for k in ("pre", "inversion", "post"))
                for r in runs:
                    if not r["end_to_end"] <= max(TOL_LEARNED, 10 * r["cpu_spread_1e-6"]):
                        raise AssertionError(f"{name}: end to end {r}")
            else:
                err = nerr(card.cpu(), learned_call(name, model, args, "cpu"))
        small[name]["max_rel_err"] = err
        if not err <= TOL_LEARNED:
            raise AssertionError(f"{name} at {LEARNED_SMALL}: card against CPU {err:.3e}")
        del card_model, card
    rec = {"phase": "learned", "model": LEARNED_NAME, "grid": [*DIFFUSERCAM, 3],
           "batch": LEARNED_BATCH, "method": "(6 - 1) forward calls, 3 pairs; images = calls "
                                             "x batch", "serving": serving,
           "small_grid": list(LEARNED_SMALL), "small_batch": 2, "card_vs_cpu": small,
           "tol": TOL_LEARNED, "launches": serving[LEARNED_NAME]["launches"],
           "kernels": "none of the port's: cuFFT (torch.fft) and cuDNN convolutions",
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


# --- serving from files (phases files and zoo_load) ------------------------------------

# the RPi HQ sensor's raw mosaics: 12-bit values over its black level;
# white-balance gains of the reference's captures (its configs' red_gain
# 1.9, blue_gain 1.2)
RAW_BITS, RED_GAIN, BLUE_GAIN = 12, 1.9, 1.2
# OmegaConf's dump of a reference training run of Unet4M+U5+Unet4M on
# DiffuserCam MirFlickr (the Hydra config the checkpoint folder carries);
# the unrolled schedules' start values and the processors' sizes are the
# zoo's (_UNET_NC["4M"], 4 blocks a scale)
ZOO_CONFIG = """\
seed: 0
files:
  dataset: bezzam/DiffuserCam-Lensless-Mirflickr-Dataset-NORM
  huggingface_dataset: true
  huggingface_psf: psf.tiff
  downsample: 2
  downsample_lensed: 2
  input_snr: null
  psf_snr: null
  single_channel_psf: true
  flipud: true
  flip_lensed: true
  n_files: null
  background_fp: null
  image_res: null
reconstruction:
  method: unrolled_admm
  skip_unrolled: false
  init_processors: null
  init_pre: true
  init_post: true
  unrolled_admm:
    n_iter: 5
    mu1: 0.0001
    mu2: 0.0001
    mu3: 0.0001
    tau: 0.0002
  pre_process:
    network: UnetRes
    depth: 4
    nc:
    - 32
    - 64
    - 116
    - 128
    delay: null
    freeze: null
    unfreeze: null
    train_last_layer: false
  post_process:
    network: UnetRes
    depth: 4
    nc:
    - 32
    - 64
    - 116
    - 128
    delay: null
    freeze: null
    unfreeze: null
    train_last_layer: false
  psf_network: false
  psf_residual: true
  compensation: null
  compensation_residual: true
  direct_background_subtraction: false
  learned_background_subtraction: false
  integrated_background_subtraction: false
  unetres_input_background: false
trainable_mask:
  mask_type: {mask_type}
  optimizer: Adam
  lr: 1.0e-03
  L1_strength: false
  initial_value: psf
training:
  batch_size: 4
  epoch: 25
  eval_batch_size: 10
  metric_for_best_model: null
  save_every: null
  crop_preloss: false
optimizer:
  type: Adam
  lr: 1.0e-04
  lr_step_epoch: true
  final_lr: false
  exp_decay: false
  slow_start: false
  cosine_decay_warmup: true
loss: l2
lpips: 1.0
unrolled_output_factor: false
pre_proc_aux: false
"""
TOL_PROPAGATION = 1e-5      # the card against the CPU at the same precision
TOL_SIM = 1e-5              # FarFieldSimulator without noise, the card against the CPU
PROPAGATION_GRID = (760, 1014)    # 12 MP at 1/4
PROPAGATION = dict(wv=532e-9, pitch=(4 * 1.55e-6, 4 * 1.55e-6), dz=2e-3)


def raw_mosaic(img, black=256.3):
    """A gray (H, W) image in [0, 1] as the RPi HQ sensor's raw 12-bit
    mosaic that ``data.image.bayer2rgb_cc`` with RED_GAIN and BLUE_GAIN
    turns back into a gray image: the sites it reads as red, (odd, odd),
    divided by RED_GAIN, its blue sites, (even, even), by BLUE_GAIN."""
    v = np.asarray(img, np.float64) / max(float(np.max(img)), 1e-30)
    v[1::2, 1::2] /= RED_GAIN
    v[0::2, 0::2] /= BLUE_GAIN
    return np.rint(black + v * (2 ** RAW_BITS - 1 - black)).astype(np.uint16)


def decode_png(path):
    """The pixels of an 8-bit gray / RGB / RGBA PNG whose rows all carry
    filter type 0 (what ``data.io.encode_png`` writes), read with zlib."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise AssertionError(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = head[:4]
    ch = {0: 1, 2: 3, 6: 4}[color]
    if depth != 8:
        raise AssertionError(f"{path}: bit depth {depth}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape((h, w, ch) if ch > 1 else (h, w))


def png_pixels(img):
    """The 8-bit pixels ``data.io.save_image`` writes for ``img``."""
    out = np.asarray(img, np.float32)
    out = out - out.min()
    if out.max() > 0:
        out = out / out.max()
    out = (np.clip(out, 0, 1) * 255).astype(np.uint8)
    return out[..., 0] if out.shape[-1] == 1 else out


def files_phase(psf2d, meas, scene_n, device="cuda"):
    """The phase ``files`` at 12 MP, the RPi HQ sensor's raw format: the
    f32 phase's PSF and measurement (its seeded scene convolved with that
    PSF) written as raw 12-bit mosaics (:func:`raw_mosaic`) in uint16 .npy
    files; ``data.io.load_data(bayer=True, gray=True)`` (the numpy
    demosaic, the ISP chain, the PSF's background and L2 norm) gives
    (1, 3040, 4056, 1); ``precompute_rsplit`` -> ``run_rsplit`` in the
    headline mode (v3, n = 10) with a gray headline solve's launch counts,
    within TOL_PSNR_DB of the exact solver on the same loaded arrays;
    ``save_image`` of the result decoded back to its pixels.  Host seconds
    of each step.  ``device="cpu"`` rehearses it (with the CUDA calls and
    the launch counts patched out)."""
    import tempfile

    from lenslesspicam_tpu_torch.data.io import load_data, save_image

    t_phase = time.perf_counter()
    n = 10
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        np.save(f"{d}/psf.npy", raw_mosaic(psf2d))
        np.save(f"{d}/data.npy", raw_mosaic(meas.cpu().numpy()))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        psf, data = load_data(f"{d}/psf.npy", f"{d}/data.npy", downsample=1, bayer=True,
                              red_gain=RED_GAIN, blue_gain=BLUE_GAIN, gray=True)
        t_load = time.perf_counter() - t0
        if psf.shape != (1, *SENSOR, 1) or data.shape != (1, *SENSOR, 1):
            raise AssertionError(f"load_data gave {psf.shape}, {data.shape}")
        if not (np.isfinite(psf).all() and np.isfinite(data).all() and data.max() > 0):
            raise AssertionError("load_data: not finite, or an empty measurement")
        t0 = time.perf_counter()
        data = data / data.max()
        pre = admm_split.precompute_rsplit(psf[0, :, :, 0], data[0, :, :, 0], device=device)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        (out, sat), counts = counted(
            lambda: admm_split.run_rsplit(pre, n_iter=n, return_sat=True, **HEADLINE),
            want_counts(n, sat_scans=2), "files")
        t_solve = time.perf_counter() - t0
        exact = admm.run(admm.make_convolver(psf, device=device),
                         torch.from_numpy(data[None]).to(device), n_iter=n)[0, 0, :, :, 0]
        if tuple(out.shape) != SENSOR or not bool(torch.isfinite(out).all()):
            raise AssertionError("files: the solve is not finite at the sensor shape")
        p_head, p_exact = psnr_db(out, scene_n), psnr_db(exact, scene_n)
        if not (abs(p_head - p_exact) <= TOL_PSNR_DB and sat < 1.0):
            raise AssertionError(f"files: headline {p_head:.3f} dB against exact "
                                 f"{p_exact:.3f} dB, sat {sat:.3f}")
        t0 = time.perf_counter()
        host = out.cpu().numpy()
        save_image(host, f"{d}/recon.png")
        t_save = time.perf_counter() - t0
        decoded = decode_png(f"{d}/recon.png")
        if not np.array_equal(decoded, png_pixels(host[:, :, None])):
            raise AssertionError("files: the saved PNG does not decode to the result's pixels")
        png_bytes = os.path.getsize(f"{d}/recon.png")
    rec = {"phase": "files", "grid": list(SENSOR), "format": "raw 12-bit mosaics, uint16 .npy",
           "gains": [RED_GAIN, BLUE_GAIN], "mode": HEADLINE, "n_iter": n,
           "psnr_headline_db": p_head, "psnr_exact_db": p_exact, "tol_db": TOL_PSNR_DB,
           "sat": sat, "launches": counts, "png_bytes": png_bytes,
           "png_decodes_to_pixels": True,
           "host_seconds": {"write_npy": t_write, "load_data": t_load, "precompute": t_pre,
                            "solve_n10": t_solve, "save_image": t_save},
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def zoo_checkpoint(folder, model, seed_decoy, mask_type="null", psf_best=None):
    """``model``'s weights as the reference's checkpoint folder: the Hydra
    config ZOO_CONFIG, ``recon_epochBEST`` with the unrolled schedules at the
    top level and DataParallel's ``module.`` prefixes, a decoy
    ``recon_epoch3`` of other seeded weights, and ``psf_epochBEST.npy``
    where given."""
    os.makedirs(f"{folder}/.hydra", exist_ok=True)
    with open(f"{folder}/.hydra/config.yaml", "w") as f:
        f.write(ZOO_CONFIG.replace("{mask_type}", mask_type))

    def reference(sd):
        return {"module." + (k[len("camera_inversion."):] if k.startswith("camera_inversion._")
                             else k): v.detach().cpu() for k, v in sd.items()}

    torch.save(reference(model.state_dict()), f"{folder}/recon_epochBEST")
    decoy = learned_model(build_model(LEARNED_NAME, device="cpu"), seed_decoy)
    torch.save(reference(decoy.state_dict()), f"{folder}/recon_epoch3")
    if psf_best is not None:
        np.save(f"{folder}/psf_epochBEST.npy", psf_best)


def propagation_checks(device="cuda"):
    """``angular_spectrum`` and ``fresnel_conv`` at PROPAGATION_GRID on a
    seeded complex field: complex64 on the card against complex64 on the
    CPU within TOL_PROPAGATION, and against complex128 on the CPU, where
    the float32 phase kz dz (up to 2 pi dz / wv rad, rounded to one half
    unit of float32 there in both) bounds the difference."""
    from lenslesspicam_tpu_torch.ops import propagation

    rng = np.random.RandomState(LEARNED_SEED)
    u = (rng.rand(*PROPAGATION_GRID) * np.exp(2j * np.pi * rng.rand(*PROPAGATION_GRID)))
    p = PROPAGATION
    phase_max = 2 * math.pi * p["dz"] / p["wv"]
    bound = 8 * phase_max * 2.0 ** -24
    out = {}
    for name in ("angular_spectrum", "fresnel_conv"):
        fn = getattr(propagation, name)
        card = on_device(fn(torch.from_numpy(u.astype(np.complex64)).to(device), p["wv"],
                            p["pitch"], p["dz"]), name, device).cpu()
        cpu = fn(u.astype(np.complex64), p["wv"], p["pitch"], p["dz"], device="cpu")
        c128 = fn(u, p["wv"], p["pitch"], p["dz"], device="cpu")
        if card.dtype != torch.complex64 or c128.dtype != torch.complex128:
            raise AssertionError(f"{name}: dtypes {card.dtype}, {c128.dtype}")
        err = nerr(card, cpu)
        err128 = float((card.to(torch.complex128) - c128).abs().max() / c128.abs().max())
        if not (err <= TOL_PROPAGATION and err128 <= bound):
            raise AssertionError(f"{name}: card against CPU {err:.3e}, against complex128 "
                                 f"{err128:.3e} (bound {bound:.3e})")
        out[name] = {"card_vs_cpu_c64": err, "card_vs_cpu_c128": err128}
    return {"grid": list(PROPAGATION_GRID), **p, "phase_max_rad": phase_max,
            "tol_c64": TOL_PROPAGATION, "bound_c128": bound, **out}


def simulator_check(psf, device="cuda"):
    """``FarFieldSimulator.propagate_image`` on a batch of 4 objects at the
    DiffuserCam grid with a random height and shift, the card against the
    CPU on the same draws (the simulator's draw helpers fed one seeded
    numpy draw each): without noise within TOL_SIM; with shot noise at 20
    dB within the larger of TOL_SIM and 10x the CPU's own spread under a
    1e-7 relative change of the PSF (the noise scales by sqrt(image), whose
    slope is unbounded where the convolution leaves a pixel at 0)."""
    from lenslesspicam_tpu_torch.data import simulation
    from lenslesspicam_tpu_torch.ops import noise

    rng = np.random.RandomState(LEARNED_SEED + 1)
    objs = rng.rand(4, 200, 300, 3).astype(np.float32)
    normal = rng.randn(4, *DIFFUSERCAM, 3).astype(np.float32)
    shift_draws = [int(rng.randint(0, 20)), int(rng.randint(0, 20))]
    nudged = (psf * (1 + 1e-7 * rng.randn(*psf.shape))).astype(np.float32)
    saved = simulation._uniform, simulation._randint, noise._normal

    def run(dev, snr_db, psf_):
        shifts = list(shift_draws)
        simulation._uniform = lambda g: 0.37
        simulation._randint = lambda g, high: min(shifts.pop(0), high - 1)
        noise._normal = lambda x, g: torch.from_numpy(normal).to(x.device)
        sim = simulation.FarFieldSimulator(
            object_height=(0.25, 0.35), scene2mask=0.4, mask2sensor=0.002, sensor="rpi_hq",
            psf=psf_, snr_db=snr_db, random_shift=True, quantize=False, device=dev)
        out = on_device(sim.propagate_image(objs, generator=torch.Generator(device=dev)),
                        "simulator", dev)
        if tuple(out.shape) != (4, *DIFFUSERCAM, 3):
            raise AssertionError(f"FarFieldSimulator: shape {tuple(out.shape)}")
        return out.cpu()

    rec = {"batch": 4, "grid": [*DIFFUSERCAM, 3], "tol": TOL_SIM}
    try:
        for snr_db in (None, 20):
            cpu = run("cpu", snr_db, psf)
            err = nerr(run(device, snr_db, psf), cpu)
            spread = nerr(run("cpu", snr_db, nudged), cpu)
            tol = TOL_SIM if snr_db is None else max(TOL_SIM, 10 * spread)
            if not err <= tol:
                raise AssertionError(f"FarFieldSimulator (snr {snr_db}): card against CPU "
                                     f"{err:.3e}, tolerance {tol:.3e}")
            rec[f"snr_{snr_db}"] = {"card_vs_cpu": err, "cpu_spread_1e-7": spread, "tol": tol}
    finally:
        simulation._uniform, simulation._randint, noise._normal = saved
    return rec


def zoo_load_phase(learned, device="cuda"):
    """The phase ``zoo_load``: the ``learned`` phase's seeded
    Unet4M+U5+Unet4M written as a reference checkpoint folder
    (:func:`zoo_checkpoint`) and read back by ``load_model`` onto the card;
    its outputs ``torch.equal`` to the in-memory model's on a batch of
    LEARNED_BATCH DiffuserCam measurements, the card against the CPU's
    load at batch 1, images/s and peak memory beside the ``learned``
    phase's, none of the port's kernels launched; ``benchmark`` over a
    ``MeasuredDataset`` folder of 4 .npy pairs, saving sample 0; a second
    load with a ``psf_epochBEST.npy`` override; the propagation and
    simulator checks.  ``device="cpu"`` rehearses it (with the CUDA calls
    patched out)."""
    import tempfile

    from lenslesspicam_tpu_torch.data.datasets import MeasuredDataset
    from lenslesspicam_tpu_torch.zoo.model_dict import load_model

    t0 = time.perf_counter()
    psf, data, _ = learned_inputs(DIFFUSERCAM, LEARNED_BATCH)
    psf_t, data_t = torch.from_numpy(psf).to(device), torch.from_numpy(data).to(device)
    memory = learned_model(build_model(LEARNED_NAME, device=device))
    with tempfile.TemporaryDirectory() as d:
        zoo_checkpoint(f"{d}/ckpt", memory, LEARNED_SEED + 1000)
        t1 = time.perf_counter()
        model, config = load_model(f"{d}/ckpt", device=None if device == "cuda" else device)
        t_load = time.perf_counter() - t1
        if next(model.parameters()).device.type != device or model.training:
            raise AssertionError("load_model: not on the card in eval mode")
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            out, counts = counted(lambda: on_device(model(data_t, psf_t), "zoo_load", device),
                                  zero_counts(), "zoo_load")
            peak = torch.cuda.max_memory_allocated()
            same = torch.equal(out, memory(data_t, psf_t))
            calls = rate(lambda k: [model(data_t, psf_t) for _ in range(k)], base=1, full=6,
                         pairs=3)
            cpu_model = load_model(f"{d}/ckpt", device="cpu")[0]
            err = nerr(out[:1].cpu(), cpu_model(data[:1], psf))
        if not same:
            raise AssertionError("zoo_load: the loaded model's output differs from the "
                                 "in-memory model's")
        if not err <= TOL_LEARNED:
            raise AssertionError(f"zoo_load: card against CPU {err:.3e}")

        # benchmark over a measured folder, the first reconstruction saved
        rng = np.random.RandomState(LEARNED_SEED + 2)
        for sub in ("diffuser", "lensed"):
            os.makedirs(f"{d}/measured/{sub}")
        for i in range(LEARNED_BATCH):
            np.save(f"{d}/measured/diffuser/im{i}.npy", data[i, 0])
            np.save(f"{d}/measured/lensed/im{i}.npy",
                    rng.rand(*DIFFUSERCAM, 3).astype(np.float32))
        os.makedirs(f"{d}/saved")
        with torch.inference_mode():
            metrics = benchmark(lambda x: model(x, psf_t),
                                MeasuredDataset(f"{d}/measured").batches(LEARNED_BATCH),
                                save_idx=[0], save_dir=f"{d}/saved", device=device)
        saved = sorted(os.listdir(f"{d}/saved"))
        if saved != ["recon_0.png"] or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"zoo_load benchmark: {saved}, {metrics}")
        if decode_png(f"{d}/saved/recon_0.png").shape != (*DIFFUSERCAM, 3):
            raise AssertionError("zoo_load benchmark: the saved PNG's shape")

        # a learned-PSF checkpoint: psf_epochBEST.npy overrides the PSF
        psf_best = (psf * (1.0 + 0.1 * rng.rand(*psf.shape))).astype(np.float32)
        zoo_checkpoint(f"{d}/trained_psf", memory, LEARNED_SEED + 1000, "TrainablePSF",
                       psf_best)
        loaded = load_model(f"{d}/trained_psf", device=None if device == "cuda" else device)
        if len(loaded) != 3 or not np.array_equal(loaded[2], psf_best):
            raise AssertionError("zoo_load: the psf_epochBEST.npy override")
        with torch.inference_mode():
            out_psf = loaded[0](data_t, torch.from_numpy(loaded[2]).to(device))
        if not bool(torch.isfinite(out_psf).all()):
            raise AssertionError("zoo_load: the forward on the learned PSF is not finite")
    del model, memory, cpu_model, loaded
    rec = {"phase": "zoo_load", "model": LEARNED_NAME, "grid": [*DIFFUSERCAM, 3],
           "batch": LEARNED_BATCH, "config_method": config["reconstruction"]["method"],
           "checkpoint": "recon_epochBEST (module. prefixes, top-level _mu*_p), decoy recon_epoch3",
           "load_seconds": t_load, "equal_to_in_memory": same, "card_vs_cpu_batch1": err,
           "tol": TOL_LEARNED, "launches": counts,
           "images_per_s": {"median": calls["median"] * LEARNED_BATCH,
                            "iqr": calls["iqr"] * LEARNED_BATCH, "pairs": calls["pairs"],
                            "rates": [r * LEARNED_BATCH for r in calls["rates"]]},
           "learned_images_per_s": learned["serving"][LEARNED_NAME]["images_per_s"]["median"],
           "peak_mem_bytes": peak, "forward_peak_bytes": peak - resident,
           "learned_peak_mem_bytes": learned["serving"][LEARNED_NAME]["peak_mem_bytes"],
           "benchmark": metrics, "saved": saved, "psf_override": "psf_epochBEST.npy",
           "propagation": propagation_checks(device), "simulator": simulator_check(psf, device),
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


# --- training (phases train and train_mask) ------------------------------------------

# the JAX bench's train rung (bench.py:761-830): Unet4M+U5+Unet4M's
# processors around a 5-iteration unrolled ADMM that recomputes its steps
# in the backward, a batch of 4 at the DiffuserCam grid, Adam at 1e-4 with
# a global-norm clip of 1.0 (TrainerConfig's defaults)
TRAIN_GRID = DIFFUSERCAM
TRAIN_BATCH = 4
TRAIN_NC = ((32, 64, 112, 128), (32, 64, 116, 128))     # bench.py:785-786, pre and post
TRAIN_STEPS = 10                     # after one warm-up step (bench.py:801-822)
TRAIN_SEED = 23
# the card against the CPU at batch 1 runs both models in float64: in
# float32 the seeded processors' gradients move by up to 2e-2 of their max
# under a 1e-6 change of the measurement (ReLUs flip), so no fixed float32
# bound can tell a wrong gradient from round-off; the float32 step's
# errors are printed beside it
TOL_TRAIN = {"loss": 1e-5,           # relative
             "grad": 1e-4,           # max |card - cpu| / max |cpu| of each parameter's gradient
             "update": 1e-6,         # the parameters after one update from the CPU's gradients
             "remat": 1e-5,          # remat=True against remat=False on the card, each gradient
             "vjp": 1e-5}            # filtered_synthesis's backward against plain autograd, f32
# DigiCam mask co-optimization, configs/sim_digicam_psf.yaml: the Adafruit
# LCD on the RPi HQ sensor at downsample 8 (380 x 507), a 19 x 26
# controllable region, scene2mask 0.3 m, mask2sensor 2 mm, flipud and
# deadspace on
MASK_SHAPE = (19, 26)
MASK_DOWNSAMPLE = 8
MASK_GEOMETRY = dict(scene2mask=0.3, mask2sensor=0.002, flipud=True, deadspace=True)
MASK_STEPS = 3
MASK_OBJECTS = (8, 96, 128)          # seeded RGB objects, count and size
TOL_MASK = {"psf": 1e-5, "grad": 1e-4}


def train_model(device, remat=True):
    """The train rung's TrainableRecon on ``device`` with seeded weights
    carried from a JAX-layout tree."""
    from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
    from lenslesspicam_tpu_torch.models.unet import UNetRes
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM

    model = TrainableRecon(
        UnrolledADMM(n_iter=5, remat=remat, device=device),
        pre_process=UNetRes(out_nc=3, nc=TRAIN_NC[0], nb=4, device=device),
        post_process=UNetRes(out_nc=3, nc=TRAIN_NC[1], nb=4, device=device), device=device)
    model.load_state_dict(convert.state_dict(model, convert.random_variables(model, TRAIN_SEED)))
    return model


def train_inputs():
    """The bench's seeded PSF and batch (bench.py:776-780), numpy float32."""
    rng = np.random.RandomState(0)
    psf = rng.rand(1, *TRAIN_GRID, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    shape = (TRAIN_BATCH, 1, *TRAIN_GRID, 3)
    return psf, {"lensless": rng.rand(*shape).astype(np.float32),
                 "lensed": rng.rand(*shape).astype(np.float32)}


def grad_errs(grads, ref):
    """max |g - ref| / max |ref| of each parameter (0 where both are 0)."""
    out = []
    for g, r in zip(grads, ref):
        d = float((g.detach().cpu() - r.detach().cpu()).abs().max())
        m = float(r.detach().abs().max())
        out.append(d / m if m > 0 else 0.0 if d == 0 else math.inf)
    return out


def synthesis_vjp_err(device):
    """``filtered_synthesis``'s hand-written backward against autograd of
    its plain form on the card, a complex and a real filter at the train
    rung's padded grid: the largest error of dx and dH."""
    from lenslesspicam_tpu_torch.ops.fft_conv import filtered_synthesis

    ph, pw = (padded_size(n, "ref") for n in TRAIN_GRID)
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)
    x = torch.randn(2, 1, ph, pw, 3, generator=gen, device=device)
    g = torch.randn(2, 1, ph, pw, 3, generator=gen, device=device)
    errs = []
    for H in (torch.randn(1, ph, pw // 2 + 1, 3, 2, generator=gen, device=device),
              torch.rand(1, ph, pw // 2 + 1, 1, generator=gen, device=device)):
        H = torch.view_as_complex(H) if H.shape[-1] == 2 else H
        grads = []
        for fn in (lambda a, b: filtered_synthesis(a, b, (ph, pw)),
                   lambda a, b: torch.fft.irfft2(torch.fft.rfft2(a, dim=(-3, -2)) * b,
                                                 s=(ph, pw), dim=(-3, -2))):
            a, b = x.clone().requires_grad_(), H.clone().requires_grad_()
            grads.append(torch.autograd.grad(fn(a, b), (a, b), g))
        errs += [nerr(a.cpu(), b.cpu()) for a, b in zip(*grads)]
    return max(errs)


def train_phase(device="cuda"):
    """The phase ``train``: the JAX bench's train rung (bench.py:761-830)
    through the port's ``Trainer`` on ``device``: one float64 step at batch 1
    on the card against the CPU from the same weights (loss, every gradient,
    and the parameters after both optimizers take the CPU's gradients), the
    float64 remat gradient against the one without remat on the card (the
    float32 step's card-against-CPU errors printed, not gated) and
    ``filtered_synthesis``'s backward against plain autograd on the card,
    then one warm-up step and
    TRAIN_STEPS steps threading the real optimizer state (the loss after
    them below the warm-up loss, the bench's gate), steps/s by ``rate`` (1
    against 6 steps, 3 pairs) and the peak device memory.  Every counted
    run launches none of the port's kernels.  ``device="cpu"`` rehearses it
    (with the CUDA calls patched out and TRAIN_GRID made small)."""
    from lenslesspicam_tpu_torch.train.trainer import Trainer, TrainerConfig

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("f32 parity needs TF32 off")
    t0 = time.perf_counter()
    psf, batch = train_inputs()
    one = {k: v[:1] for k, v in batch.items()}
    cfg = TrainerConfig(epochs=1, lr=1e-4)

    def trainer(model, dev):
        return Trainer(model, psf, lambda: iter([batch]), [batch], cfg, device=dev)

    one64 = {k: v.astype(np.float64) for k, v in one.items()}
    card, cpu = (trainer(train_model(dev).double(), dev) for dev in (device, "cpu"))
    loss_c, grads_c, _ = cpu.loss_and_grads(one64)
    loss_g, grads_g, _ = card.loss_and_grads(one64)
    plain = trainer(train_model(device, remat=False).double(), device)
    loss_p, grads_p, _ = plain.loss_and_grads(one64)
    cpu.apply_grads(grads_c)
    card.apply_grads([g.to(device) for g in grads_c])
    card_errs = grad_errs(grads_g, grads_c)
    names = [n for n, _ in card.named_params]
    errs = {"loss": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
            "grad": max(card_errs),
            "update": max(grad_errs([p for _, p in card.named_params],
                                    [p for _, p in cpu.named_params])),
            "remat": max(*grad_errs(grads_g, grads_p),
                         abs(float(loss_g) - float(loss_p)) / abs(float(loss_p))),
            "vjp": synthesis_vjp_err(device)}
    for k, err in errs.items():
        if not err <= TOL_TRAIN[k]:
            raise AssertionError(f"train: {k} {err:.3e} above {TOL_TRAIN[k]}")
    errs["grad_worst_param"] = names[max(range(len(names)), key=card_errs.__getitem__)]
    del card, cpu, plain, grads_c, grads_g, grads_p
    # float32, as the rung trains: printed, not gated
    errs32 = grad_errs(*(trainer(train_model(dev), dev).loss_and_grads(one)[1]
                         for dev in (device, "cpu")))
    errs["f32_not_gated"] = {"grad_max": max(errs32),
                             "params_above_1e-4": sum(e > TOL_TRAIN["grad"] for e in errs32),
                             "params": len(errs32)}

    run = trainer(train_model(device), device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    loss0 = float(run.train_step(batch))
    losses, counts = counted(lambda: [run.train_step(batch) for _ in range(TRAIN_STEPS)],
                             zero_counts(), "train")
    peak = torch.cuda.max_memory_allocated()
    loss = float(losses[-1])
    if not (math.isfinite(loss0) and math.isfinite(loss) and loss < loss0):
        raise AssertionError(f"train: the loss did not decrease ({loss0} -> {loss} over "
                             f"{TRAIN_STEPS + 1} steps)")
    steps = rate(lambda k: [run.train_step(batch) for _ in range(k)], base=1, full=6, pairs=3)
    rec = {"phase": "train", "model": f"UNetRes nc {TRAIN_NC[0]} nb 4 + UnrolledADMM n 5 remat "
                                      f"+ UNetRes nc {TRAIN_NC[1]} nb 4",
           "grid": [*TRAIN_GRID, 3], "batch": TRAIN_BATCH, "config": "Adam lr 1e-4, clip 1.0",
           "parameters": sum(p.numel() for _, p in run.named_params),
           "loss_warmup": loss0, "loss_after": loss, "steps": TRAIN_STEPS + 1,
           "losses": [float(v) for v in losses],
           "steps_per_s": steps, "method": "(6 - 1) Trainer.train_step calls, 3 pairs",
           "peak_mem_bytes": peak, "resident_bytes": resident, "card_vs_cpu_batch1": errs,
           "card_vs_cpu_dtype": "float64", "tol": TOL_TRAIN, "launches": counts,
           "kernels": "none of the port's: cuFFT (torch.fft) and cuDNN convolutions",
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def train_mask_phase(device="cuda"):
    """The phase ``train_mask``: DigiCam mask co-optimization with the
    geometry of configs/sim_digicam_psf.yaml: an ``AdafruitLCD`` with
    seeded values, its PSF and the gradient of a seeded weighting of it on
    the card against the CPU from the same values, then a 5-iteration
    unrolled ADMM trained with the mask through ``Trainer`` for MASK_STEPS
    steps on ``SimulatedDatasetTrainableMask`` batches of 4, each simulated
    through the mask's current PSF: the loss finite, the mask's values
    moved and inside [0, 1].  No kernel of the port launches.
    ``device="cpu"`` rehearses it (CUDA calls patched out)."""
    from lenslesspicam_tpu_torch.data.datasets import SimulatedDatasetTrainableMask
    from lenslesspicam_tpu_torch.data.simulation import FarFieldSimulator
    from lenslesspicam_tpu_torch.hardware.trainable_mask import AdafruitLCD
    from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM
    from lenslesspicam_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    rng = np.random.RandomState(TRAIN_SEED)
    vals = rng.rand(*MASK_SHAPE).astype(np.float32)

    def lcd(dev):
        return AdafruitLCD(vals, sensor="rpi_hq", downsample=MASK_DOWNSAMPLE, device=dev,
                           **MASK_GEOMETRY)

    card_mask, cpu_mask = lcd(device), lcd("cpu")
    psfs, grads = [], []
    for m in (card_mask, cpu_mask):
        psf = m.get_psf(m.params)
        weight = torch.from_numpy(np.random.RandomState(1).rand(*psf.shape).astype(np.float32))
        grads.append(torch.autograd.grad((psf * weight.to(psf.device)).sum(), m.params["vals"])[0])
        psfs.append(psf.detach())
    errs = {"psf": nerr(psfs[0].cpu(), psfs[1]), "grad": nerr(grads[0].cpu(), grads[1])}
    for k, err in errs.items():
        if not err <= TOL_MASK[k]:
            raise AssertionError(f"train_mask: {k} card against CPU {err:.3e}")
    del cpu_mask, grads

    n, h, w = MASK_OBJECTS
    images = [rng.rand(h, w, 3).astype(np.float32) for _ in range(n)]
    sim = FarFieldSimulator(object_height=0.3, scene2mask=MASK_GEOMETRY["scene2mask"],
                            mask2sensor=MASK_GEOMETRY["mask2sensor"], sensor="rpi_hq",
                            quantize=False, device=device)
    data = SimulatedDatasetTrainableMask(card_mask, images, sim)
    model = TrainableRecon(UnrolledADMM(n_iter=5, device=device), device=device)
    trainer = Trainer(model, data.psf, lambda: data.batches(4), [], TrainerConfig(epochs=1),
                      mask=card_mask, device=device)
    before = card_mask.params["vals"].detach().clone()

    def steps():
        losses = []
        for _ in range(MASK_STEPS):
            data.set_psf()
            losses.append(float(trainer.train_step(next(data.batches(4)))))
        return losses

    losses, counts = counted(steps, zero_counts(), "train_mask")
    after = card_mask.params["vals"].detach()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_mask: losses {losses}")
    if torch.equal(after, before) or not (float(after.min()) >= 0.0 and float(after.max()) <= 1.0):
        raise AssertionError("train_mask: the mask's values did not move or left [0, 1]")
    rec = {"phase": "train_mask", "mask": "AdafruitLCD rpi_hq downsample 8",
           "psf_grid": list(psfs[0].shape), "controllable": list(MASK_SHAPE),
           "geometry": MASK_GEOMETRY, "model": "UnrolledADMM n 5", "batch": 4,
           "steps": MASK_STEPS, "losses": losses,
           "mask_moved_max": float((after - before).abs().max()),
           "mask_range": [float(after.min()), float(after.max())],
           "card_vs_cpu": errs, "tol": TOL_MASK, "launches": counts,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


# phase ``hub``: the DigiCam multimask dataset in the Hugging Face hub's
# format (data/datasets.py HFDataset through get_dataset), served at its
# measurement grid through the fused RGB solver.  The smoke run needs
# neither the network nor huggingface_hub: the phase writes the dataset's
# mask files to a temporary folder and puts a stand-in hf_hub_download that
# returns them in sys.modules for its own run only
HUB_NAME = "digicam_mirflickr_multi"     # data/datasets.py available_datasets
HUB_GRID = GRIDS[1]                      # 380 x 507, the RPi HQ sensor at downsample 8
HUB_LENSED = (270, 360)                  # the rows' lensed images, resized by the alignment
HUB_ROWS = 8
HUB_LABELS = 4
HUB_BATCH = 4
HUB_N = 10
HUB_SEED = 25
HUB_SOURCE = ("stand-in huggingface_hub.hf_hub_download returning masks/mask_{label}.npy "
              "written by the phase (neither the network nor huggingface_hub is used)")


class HubRows:
    """The duck-type of a loaded ``datasets.Dataset`` that HFDataset reads:
    indexable dict rows and ``column_names``."""

    def __init__(self, rows):
        self.rows = rows
        self.column_names = list(rows[0])

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        return self.rows[int(idx)]


def hub_phase(device="cuda"):
    """The phase ``hub``: ``get_dataset(HUB_NAME)`` over HUB_ROWS seeded
    rows at the DigiCam grid, its registry geometry (rotate, display
    resolution, alignment) as given; each label's PSF simulated through
    ``AdafruitLCD`` on the card against the same dataset built on the CPU
    within TOL_MASK["psf"]; ``eval.benchmark`` over its batches of
    HUB_BATCH on the card, each sample solved by the fused RGB solver
    (``precompute_rsplit_general`` once per label, ``run_rsplit_general``,
    f32, v3, n = HUB_N) with the launches of one RGB solve each (K1, K3,
    2 K4, K5, K6 per iteration), the alignment's region scored against the
    lensed image; one sample against the exact solver on the same PSF
    within TOL_SMALL of its max and within TOL_PSNR_DB; ``HFSimulated`` on a batch and a
    ``HITLDatasetTrainableMask(simulate=True)`` sample from an
    ``AdafruitLCD`` on the card against the CPU within TOL_SIM.
    ``device="cpu"`` rehearses it (CUDA calls and the launch check patched
    out).  Returns the phase's record."""
    import tempfile

    from lenslesspicam_tpu_torch.data import datasets as ds_mod
    from lenslesspicam_tpu_torch.hardware.trainable_mask import AdafruitLCD

    t0 = time.perf_counter()
    rng = np.random.RandomState(HUB_SEED)
    rows = HubRows([{"lensless": (rng.rand(*HUB_GRID, 3) * 255).astype(np.uint8),
                     "lensed": (rng.rand(*HUB_LENSED, 3) * 255).astype(np.uint8),
                     "mask_label": i % HUB_LABELS} for i in range(HUB_ROWS)])
    saved = sys.modules.get("huggingface_hub")
    with tempfile.TemporaryDirectory() as folder:
        os.makedirs(os.path.join(folder, "masks"))
        for lab in range(HUB_LABELS):
            np.save(os.path.join(folder, "masks", f"mask_{lab}.npy"),
                    rng.rand(*MASK_SHAPE).astype(np.float32))
        asked = []

        def hf_hub_download(repo_id, filename, repo_type=None, **_):
            asked.append(filename)
            return os.path.join(folder, filename)

        sys.modules["huggingface_hub"] = types.SimpleNamespace(hf_hub_download=hf_hub_download)
        try:
            t1 = time.perf_counter()
            ds = ds_mod.get_dataset(HUB_NAME, split=rows, device=device)
            build_s = time.perf_counter() - t1
            ds_cpu = ds_mod.get_dataset(HUB_NAME, split=rows, device="cpu")
            sim = {dev: ds_mod.HFSimulated(
                ds.repo, split=rows, snr_db=None, display_res=ds.display_res,
                alignment=ds_mod.available_datasets[HUB_NAME]["alignment"], device=dev)
                for dev in (device, "cpu")}
        finally:
            if saved is None:
                del sys.modules["huggingface_hub"]
            else:
                sys.modules["huggingface_hub"] = saved
    if sorted(set(asked)) != [f"masks/mask_{lab}.npy" for lab in range(HUB_LABELS)]:
        raise AssertionError(f"hub: files asked of the hub {asked}")
    if ds.mask_labels != list(range(HUB_LABELS)) or not ds.rotate or ds.alignment is None:
        raise AssertionError(f"hub: labels {ds.mask_labels}, geometry {ds.alignment}")
    psf_err = {lab: nerr(torch.from_numpy(ds.psf[lab]), torch.from_numpy(ds_cpu.psf[lab]))
               for lab in ds.mask_labels}
    for lab, err in psf_err.items():
        if tuple(ds.psf[lab].shape) != (1, *HUB_GRID, 3) or not err <= TOL_MASK["psf"]:
            raise AssertionError(f"hub: PSF of label {lab} {ds.psf[lab].shape}, card against "
                                 f"CPU {err:.3e}")

    # the dataset's own rate on the host: every batch, no solve
    t1 = time.perf_counter()
    batches = list(ds.batches(HUB_BATCH))
    host_s = time.perf_counter() - t1
    if [tuple(b["lensless"].shape) for b in batches] != [(HUB_BATCH, 1, *HUB_GRID, 3)] * (
            HUB_ROWS // HUB_BATCH):
        raise AssertionError(f"hub: batches {[b['lensless'].shape for b in batches]}")

    # the fused RGB solver, one precompute per label on its PSF
    pres, pre_s, psfs_dev = {}, {}, {}
    for lab in ds.mask_labels:
        t1 = time.perf_counter()
        pres[lab] = admm_split.precompute_rsplit_general(
            ds.psf[lab], batches[0]["lensless"][:1], device=device)
        pre_s[lab] = time.perf_counter() - t1
        psfs_dev[lab] = torch.from_numpy(ds.psf[lab]).to(device)
    per_solve, solve_s = want_counts(HUB_N), []
    top, left = ds.alignment["top_left"]
    roi = (slice(top, top + ds.alignment["height"]), slice(left, left + ds.alignment["width"]))

    def label_of(psf):
        found = [lab for lab, p in psfs_dev.items() if torch.equal(psf, p)]
        if len(found) != 1:
            raise AssertionError(f"hub: a sample's PSF matches labels {found}")
        return found[0]

    def solve(lensless, lab):
        pre, info = pres[lab]
        return admm_split.run_rsplit_general(pre, info, lensless, n_iter=HUB_N)

    def reconstruct(lensless, psfs):
        outs = []
        for i in range(lensless.shape[0]):
            lab, before = label_of(psfs[i]), all_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = solve(lensless[i:i + 1], lab)
            torch.cuda.synchronize()
            solve_s.append(time.perf_counter() - t1)
            after = all_counts()
            got = {k: after[k] - before[k] for k in after}
            if device != "cpu" and got != per_solve:
                raise AssertionError(f"hub: a solve's launches {got} != {per_solve}")
            outs.append(out[..., roi[0], roi[1], :])
        return torch.cat(outs)

    want_all = {k: v * HUB_ROWS for k, v in per_solve.items()}
    metrics, counts = counted(lambda: benchmark(reconstruct, batches, device=device),
                              want_all, "hub")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"hub: metrics {metrics}")

    # one sample at n = HUB_N against the exact solver on its PSF: the whole
    # output held to TOL_SMALL of its max, and the alignment's region scored
    # against the lensed image
    b0 = batches[0]
    lab0 = int(rows[0]["mask_label"])
    data0 = torch.from_numpy(b0["lensless"][:1]).to(device)
    fused0 = solve(data0, lab0)[0, 0]
    exact0 = admm.run(admm.make_convolver(ds.psf[lab0], device=device), data0,
                      n_iter=HUB_N)[0, 0]
    target = torch.from_numpy(b0["lensed"][0, 0]).to(device)
    p_fused, p_exact = (psnr_db(x[roi[0], roi[1]], target) for x in (fused0, exact0))
    vs_exact = nerr(fused0, exact0)
    if not (bool(torch.isfinite(fused0).all()) and vs_exact <= TOL_SMALL
            and abs(p_fused - p_exact) <= TOL_PSNR_DB):
        raise AssertionError(f"hub: fused against exact {vs_exact:.3e} of the max, "
                             f"{p_fused:.3f} dB against {p_exact:.3f} dB")

    # HFSimulated on one batch, HITL simulated on one sample: card against CPU
    sim_err = nerr(torch.from_numpy(next(sim[device].batches(HUB_BATCH))["lensless"]),
                   torch.from_numpy(next(sim["cpu"].batches(HUB_BATCH))["lensless"]))
    vals = rng.rand(*MASK_SHAPE).astype(np.float32)
    base = [rng.rand(*HUB_LENSED, 3).astype(np.float32)]
    hitl = [ds_mod.HITLDatasetTrainableMask(
        AdafruitLCD(vals, sensor="rpi_hq", downsample=MASK_DOWNSAMPLE, device=dev,
                    **MASK_GEOMETRY), base, simulate=True, device=dev)[0][0]
        for dev in (device, "cpu")]
    hitl_err = nerr(torch.from_numpy(hitl[0]), torch.from_numpy(hitl[1]))
    for name, err in (("HFSimulated", sim_err), ("HITL", hitl_err)):
        if not err <= TOL_SIM:
            raise AssertionError(f"hub: {name} card against CPU {err:.3e}")

    rec = {"phase": "hub", "dataset": HUB_NAME, "source": HUB_SOURCE, "rows": HUB_ROWS,
           "grid": [*HUB_GRID, 3], "lensed": [*HUB_LENSED, 3], "labels": HUB_LABELS,
           "alignment": ds.alignment, "rotate": ds.rotate, "batch": HUB_BATCH,
           "solver": "run_rsplit_general f32 v3", "n_iter": HUB_N,
           "psf_card_vs_cpu": psf_err, "tol_psf": TOL_MASK["psf"],
           "benchmark": metrics, "fused_vs_exact_normalized": vs_exact,
           "tol_vs_exact": TOL_SMALL, "psnr_fused_db": p_fused, "psnr_exact_db": p_exact,
           "tol_db": TOL_PSNR_DB, "hf_simulated_card_vs_cpu": sim_err,
           "hitl_card_vs_cpu": hitl_err, "tol_sim": TOL_SIM, "launches": counts,
           "launches_per_solve": {k: v for k, v in per_solve.items() if v},
           "dataset_build_s": build_s,
           "dataset_samples_per_s": HUB_ROWS / host_s,
           "solve_ms": [1e3 * v for v in solve_s],
           "solve_samples_per_s": 1.0 / statistics.median(solve_s),
           "precompute_s_by_label": pre_s, "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


# phase ``cli``: the CLI apps of lenslesspicam_tpu_torch/scripts, run as a
# user runs them (their ``main`` with the JAX scripts' dotted overrides; no
# LPT_PLATFORM, so on the card).  The hub's apps read stand-in ``datasets``
# and ``huggingface_hub`` modules put in sys.modules for the phase's own run
CLI_SEED = 26
CLI_ADMM = ((1, 10), (4, 100))            # (preprocess.downsample, admm.n_iter)
CLI_PADDED = {1: (6144, 8192)}            # the exact solver's padded grid at downsample 1
CLI_HUB_ROWS = 4
CLI_HUB_RAW = (540, 960)                  # DiffuserCam's stand-in rows, downsample 2 -> 270 x 480
CLI_ZOO_N = 5                             # the stand-in zoo checkpoint: an unrolled ADMM
TOL_CLI = 1e-6                            # the admm app against the ADMM API, of the max
TOL_CLI_DB = 0.01                         # quality_baseline, the card against the CPU
CLI_SOURCE = ("synthetic 12 MP RGB pair (3040 x 4056 x 3, 16-bit PNGs, seed 26: the "
              "certification scene and three sparse PSFs, the measurement convolved on the "
              "card); stand-in hub rows and a seeded zoo checkpoint; no network")


def _cli_pair(folder, device):
    """The synthetic 12 MP RGB pair as 16-bit PNGs (OpenCV's BGR order):
    three sparse PSFs, the certification scene weighted per channel, the
    measurement convolved on ``device``; returns the files and the scene."""
    import cv2

    rng = np.random.RandomState(CLI_SEED)
    scene, _ = cert_scene_psf(SENSOR, rng)
    psf = np.stack([cert_scene_psf(SENSOR, rng)[1] for _ in range(3)], axis=-1)
    scene3 = np.stack([scene * w for w in (1.0, 0.8, 0.6)], axis=-1).astype(np.float32)
    fwd = FFTConvolver.from_psf(psf[None], pad=True, norm="backward", device=device)
    meas = fwd.convolve(torch.from_numpy(scene3)[None, None].to(device))[0, 0]
    meas = (meas / meas.max()).cpu().numpy()
    del fwd
    files = {}
    for name, img in (("psf", psf / psf.max()), ("data", meas), ("scene", scene3 / scene3.max())):
        files[name] = os.path.join(folder, f"{name}.png")
        if not cv2.imwrite(files[name], (img[..., ::-1] * 65535).round().astype(np.uint16)):
            raise AssertionError(f"cli: could not write {files[name]}")
    return files


def _cli_zoo_checkpoint(folder, config):
    """A reference checkpoint folder of a seeded unrolled ADMM
    (``zoo.load_model``'s layout: the Hydra config and the schedules at the
    state dict's top level)."""
    import yaml

    from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM

    model = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=CLI_ZOO_N, device="cpu"),
                           device="cpu")
    sd = convert.state_dict(model, convert.random_variables(model, CLI_SEED))
    sd = {k.replace("camera_inversion._", "_"): v for k, v in sd.items()}
    os.makedirs(os.path.join(folder, ".hydra"))
    with open(os.path.join(folder, ".hydra", "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    torch.save(sd, os.path.join(folder, "recon_epochBEST"))
    return folder


def cli_phase(smi="", device="cuda"):
    """The phase ``cli``: every app of ``lenslesspicam_tpu_torch.scripts``
    through its ``main``, on the card (``LPT_PLATFORM`` unset), each with
    its host seconds and peak memory:

    * ``recon.admm`` on the synthetic 12 MP RGB pair at
      ``preprocess.downsample=1`` (padded to 6144 x 8192 x 3, n = 10) and
      at the config's downsample 4 (n = 100), each held to the ``ADMM`` API
      on the same loaded arrays within TOL_CLI of the max;
      ``gradient_descent``, ``apgd`` and ``demo`` on the pair at downsample
      4 with the config's counts; ``compute_metrics_from_original`` on the
      admm app's downsample-4 result;
    * ``eval.quality_baseline``'s full sweep (3 scenes x 6 algorithms x 7
      iteration counts) on the card, each ``admm_rfused`` solve with the
      launches of ``want_counts(n)`` (K1, K3, 2 K4, K5, K6) and every other
      solve with none, the whole sweep counted; the same sweep on the CPU,
      all 126 entries present on both and each card PSNR within TOL_CLI_DB
      of the CPU's;
    * ``eval.benchmark_recon`` at configs/benchmark.yaml's defaults and
      ``recon.train_learning_based`` at configs/train.yaml with
      ``training.epoch=1``;
    * ``sim.single_file`` (the pair's scene and PSF) and
      ``sim.simulate_dataset`` (a Fresnel zone aperture) at their configs'
      sizes;
    * the hub's apps on stand-in rows: ``recon.dataset_recon`` (ADMM and a
      seeded zoo checkpoint), ``recon.diffusercam`` (ADMM and the zoo
      model) and ``recon.digicam`` (ADMM and the zoo model, from a local
      checkpoint folder).

    ``device="cpu"`` rehearses it at whatever ``SENSOR`` is set to (the
    launch checks and the card-against-CPU sweep skipped).  Returns the
    phase's record."""
    import tempfile

    import cv2

    from lenslesspicam_tpu_torch._device import as_host
    from lenslesspicam_tpu_torch.data.io import load_data
    from lenslesspicam_tpu_torch.scripts.eval import benchmark_recon as app_bench
    from lenslesspicam_tpu_torch.scripts.eval import compute_metrics_from_original as app_metrics
    from lenslesspicam_tpu_torch.scripts.eval import quality_baseline as qb
    from lenslesspicam_tpu_torch.scripts.recon import admm as app_admm
    from lenslesspicam_tpu_torch.scripts.recon import apgd as app_apgd
    from lenslesspicam_tpu_torch.scripts.recon import dataset_recon as app_dsrecon
    from lenslesspicam_tpu_torch.scripts.recon import demo as app_demo
    from lenslesspicam_tpu_torch.scripts.recon import diffusercam as app_diffusercam
    from lenslesspicam_tpu_torch.scripts.recon import digicam as app_digicam
    from lenslesspicam_tpu_torch.scripts.recon import gradient_descent as app_gd
    from lenslesspicam_tpu_torch.scripts.recon import train_learning_based as app_train
    from lenslesspicam_tpu_torch.scripts.sim import simulate_dataset as app_simds
    from lenslesspicam_tpu_torch.scripts.sim import single_file as app_single
    from lenslesspicam_tpu_torch.zoo.model_dict import model_dict

    t0 = time.perf_counter()
    on_card = device != "cpu"
    host_s, peak = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_s[name] = time.perf_counter() - t1
        peak[name] = torch.cuda.max_memory_allocated()
        return out

    saved_env = os.environ.pop("LPT_PLATFORM", None)
    if not on_card:
        os.environ["LPT_PLATFORM"] = "cpu"
    saved_mods = {m: sys.modules.get(m) for m in ("datasets", "huggingface_hub")}
    rec = {"phase": "cli", "source": CLI_SOURCE, "grid": [*SENSOR, 3]}
    try:
        with tempfile.TemporaryDirectory() as folder:
            files = run("pair", lambda: _cli_pair(folder, device))
            out = os.path.join(folder, "runs")

            # recon.admm: the app against the API on the same loaded arrays
            admm_rec = {}
            for ds, n in CLI_ADMM:
                args = [f"input.psf={files['psf']}", f"input.data={files['data']}",
                        f"preprocess.downsample={ds}", f"admm.n_iter={n}"]
                res = run(f"admm_ds{ds}", lambda: app_admm.main([*args, f"output_dir={out}"]))
                psf, data = load_data(files["psf"], files["data"], downsample=ds)
                api = lpt.ADMM(psf, device=device)
                api.set_data(data)
                ref = as_host(api.apply(n_iter=n))
                padded = list(api._convolver.padded_shape[1:3])
                del api
                err = float(np.abs(res - ref).max() / np.abs(ref).max())
                grid = [SENSOR[0] // ds, SENSOR[1] // ds, 3]
                if not (isinstance(res, np.ndarray) and list(res.shape) == [1, *grid]
                        and np.isfinite(res).all() and err <= TOL_CLI
                        and (SENSOR != (3040, 4056) or ds not in CLI_PADDED
                             or tuple(padded) == CLI_PADDED[ds])):
                    raise AssertionError(f"cli: admm at downsample {ds}: {np.shape(res)}, "
                                         f"padded {padded}, against the API {err:.3e}")
                admm_rec[f"ds{ds}"] = {"n_iter": n, "shape": list(res.shape), "padded": padded,
                                       "vs_api": err}
                if ds == 4:
                    np.save(os.path.join(folder, "recon_ds4.npy"), res[0])
            rec["admm"] = admm_rec
            rec["tol_vs_api"] = TOL_CLI

            ds4 = [f"input.psf={files['psf']}", f"input.data={files['data']}",
                   "preprocess.downsample=4", f"output_dir={out}"]
            shapes = {"gradient_descent": list(run("gradient_descent",
                                                   lambda: app_gd.main(ds4)).shape),
                      "apgd": list(run("apgd", lambda: app_apgd.main(ds4)).shape),
                      "demo": list(run("demo", lambda: app_demo.main(
                          [f"raw={files['data']}", f"camera.psf={files['psf']}",
                           "recon.downsample=4", f"output_dir={out}"])).shape)}
            scores = run("compute_metrics_from_original", lambda: app_metrics.compute_metrics(
                [f"files.recon={os.path.join(folder, 'recon_ds4.npy')}",
                 f"files.original={files['scene']}", f"output_dir={out}"]))
            rec["metrics_ds4_vs_scene"] = scores

            # eval.quality_baseline: each solve's launches, the sweep counted
            plain_reconstruct, solves = qb.reconstruct, []

            def checked(algo, psf, meas, n_iter, device=None):
                before = all_counts()
                res = plain_reconstruct(algo, psf, meas, n_iter, device)
                torch.cuda.synchronize()
                after = all_counts()
                got = {k: after[k] - before[k] for k in after}
                want = want_counts(n_iter) if algo == "admm_rfused" else zero_counts()
                if str(device) != "cpu" and got != want:
                    raise AssertionError(f"cli: quality_baseline {algo} n={n_iter} launches "
                                         f"{got} != {want}")
                solves.append(algo)
                return res

            total = zero_counts()
            for n in qb.N_ITER_SWEEP:
                for k, v in want_counts(n).items():
                    total[k] += 3 * v
            qb.reconstruct = checked
            try:
                sweep, counts = run("quality_baseline", lambda: counted(
                    lambda: qb.run_sweep(device=device), total if on_card else zero_counts(),
                    "cli quality_baseline"))
                cpu_sweep = run("quality_baseline_cpu", lambda: qb.run_sweep(device="cpu"))
            finally:
                qb.reconstruct = plain_reconstruct
            keys = {(s, a, n) for s, d in sweep.items() for a, v in d.items() for n in v}
            cpu_keys = {(s, a, n) for s, d in cpu_sweep.items() for a, v in d.items() for n in v}
            want_entries = 3 * len(qb.ALGOS) * len(qb.N_ITER_SWEEP)
            entries = len(keys)
            finite = all(math.isfinite(m[k]) for d in sweep.values() for v in d.values()
                         for m in v.values() for k in m)
            gaps = {f"{s}/{a}/{n}": abs(sweep[s][a][n]["psnr"] - cpu_sweep[s][a][n]["psnr"])
                    for s, a, n in keys & cpu_keys}
            worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
            if entries != want_entries or cpu_keys != keys or not finite or (
                    on_card and max(gaps.values()) > TOL_CLI_DB):
                raise AssertionError(f"cli: quality_baseline {entries}/{want_entries} entries, "
                                     f"CPU's {len(cpu_keys)}, finite {finite}, card against "
                                     f"CPU worst {worst}")
            rec["quality_baseline"] = {
                "entries": entries, "solves": len(solves),
                "compared": len(gaps), "psnr_card_vs_cpu_db_max": max(gaps.values()),
                "psnr_card_vs_cpu_db_worst": worst, "tol_db": TOL_CLI_DB,
                "rects_admm_rfused_psnr_db": {n: m["psnr"] for n, m in
                                              sweep["rects"]["admm_rfused"].items()}}
            rec["launches"] = counts

            # eval.benchmark_recon and recon.train_learning_based at their configs
            bench = run("benchmark_recon", lambda: app_bench.main([f"output_dir={out}"]))
            algos = ["ADMM", "FISTA", "GradientDescent", "NesterovGradientDescent"]
            if sorted(bench) != sorted(algos) or not all(
                    sorted(v) == [5, 10, 20, 50, 100, 200, 300] and all(
                        math.isfinite(x) for m in v.values() for x in m.values())
                    for v in bench.values()):
                raise AssertionError(f"cli: benchmark_recon {bench}")
            rec["benchmark_recon_psnr_db"] = {a: {n: m["PSNR"] for n, m in v.items()}
                                              for a, v in bench.items()}
            K.reset_launches()
            log = run("train_learning_based", lambda: app_train.main(
                ["training.epoch=1", f"output_dir={out}"]))
            rec["train_launches"] = {k: v for k, v in all_counts().items() if v}
            psnrs = [m["eval"]["PSNR"] for _, m in sorted(log.items())]
            if len(psnrs) != 2 or not all(math.isfinite(p) for p in psnrs):
                raise AssertionError(f"cli: train_learning_based log {log}")
            rec["train_psnr_db_by_epoch"] = psnrs

            # the simulation apps
            single = run("single_file", lambda: app_single.simulate(
                [f"files.original={files['scene']}", f"files.psf={files['psf']}",
                 f"output_dir={out}"]))
            sim_dir = run("simulate_dataset", lambda: app_simds.main(
                ["mask.type=FresnelZoneAperture", f"output_dir={out}"]))
            shapes["single_file"] = list(single.shape)
            shapes["simulate_dataset_pairs"] = len(os.listdir(os.path.join(sim_dir, "lensed")))
            if not np.isfinite(single).all() or shapes["simulate_dataset_pairs"] != 32:
                raise AssertionError(f"cli: simulation apps {shapes}")

            # the hub's apps on stand-in rows and a seeded zoo checkpoint
            rng = np.random.RandomState(CLI_SEED)
            hub_dir = os.path.join(folder, "hub")
            os.makedirs(hub_dir)
            rows = HubRows([{"lensless": (rng.rand(*CLI_HUB_RAW, 3) * 255).astype(np.uint8),
                             "lensed": (rng.rand(*CLI_HUB_RAW, 3) * 255).astype(np.uint8)}
                            for _ in range(CLI_HUB_ROWS)])
            hub_psf = (rng.rand(*CLI_HUB_RAW, 3) * 200 + 20).astype(np.uint8)
            for name in ("psf.tiff", "psf.png"):
                cv2.imwrite(os.path.join(hub_dir, name), hub_psf)
            unrolled = {"reconstruction": {
                "method": "unrolled_admm", "unrolled_admm": {"n_iter": CLI_ZOO_N},
                "pre_process": {"network": None}, "post_process": {"network": None}}}
            zoo_name = next(iter(model_dict["diffusercam"]["mirflickr"]))
            zoo = _cli_zoo_checkpoint(os.path.join(folder, "zoo"), unrolled)
            digicam_ckpt = _cli_zoo_checkpoint(os.path.join(folder, "digicam"), {
                "files": {"dataset": "owner/digicam", "huggingface_psf": "psf.png",
                          "downsample": 2},
                "alignment": {"top_left": [20, 30], "height": 200, "width": 300}, **unrolled})
            sys.modules["datasets"] = types.SimpleNamespace(
                load_dataset=lambda repo, split=None, cache_dir=None, **_: rows)
            sys.modules["huggingface_hub"] = types.SimpleNamespace(
                hf_hub_download=lambda repo_id, filename, **_: os.path.join(hub_dir, filename),
                snapshot_download=lambda repo_id, **_: zoo)
            hub_rec = {}
            for algo in ("admm", f"hf:diffusercam:mirflickr:{zoo_name}"):
                tag = "dataset_recon_" + ("admm" if algo == "admm" else "zoo")
                got = run(tag, lambda: app_dsrecon.main(
                    ["dataset=diffusercam_mirflickr", f"algo={algo}", f"output_dir={out}"]))
                hub_rec[tag] = got
            for model in ("admm", zoo_name):
                tag = "diffusercam_" + ("admm" if model == "admm" else "zoo")
                hub_rec[tag] = list(run(tag, lambda: app_diffusercam.main(
                    [f"model={model}", "n_trials=2", f"output_dir={out}"])).shape)
            for model in ("admm", "U5"):
                tag = "digicam_" + ("admm" if model == "admm" else "zoo")
                res, avg_ms = run(tag, lambda: app_digicam.main(
                    [f"model={model}", f"model_path={digicam_ckpt}", "n_trials=2",
                     f"output_dir={out}"]))
                hub_rec[tag] = {"shape": list(res.shape), "avg_ms": avg_ms}
            for tag in ("dataset_recon_admm", "dataset_recon_zoo"):
                if len(hub_rec[tag]) != CLI_HUB_ROWS or not all(
                        math.isfinite(v) for m in hub_rec[tag] for v in m.values()):
                    raise AssertionError(f"cli: {tag} {hub_rec[tag]}")
            rec["hub"] = hub_rec
            rec["shapes"] = shapes
    finally:
        for m, mod in saved_mods.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
        os.environ.pop("LPT_PLATFORM", None)
        if saved_env is not None:
            os.environ["LPT_PLATFORM"] = saved_env
    rec.update({"host_s": host_s, "peak_mem_bytes": peak,
                "card": smi, "seconds": time.perf_counter() - t0})
    emit(rec)
    return rec


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
    t_start = time.perf_counter()
    seconds = {}

    t0 = time.perf_counter()
    logs = _build.build_all()
    regs = {n: [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
            for n, r in logs.items()}
    seconds["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds["build"], "built": sorted(logs),
          "seconds_by_library": {n: r["seconds"] for n, r in logs.items()}, "ptxas": regs})
    t0 = time.perf_counter()
    ph, pw = 6144, 8192
    measured, counts_bw, counts_bw_f32 = bandwidth_phase(smi)
    probe_rows = {mode: check_kernels(ph, pw, True, io, F32, F32, F32, mode,
                                      cases=probe_kernel_cases, ops=PB)
                  for mode, io in (("f32", F32), ("headline", BF16))}
    seconds["bandwidth"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sh, sw = 2 * SMALL[0], 2 * SMALL[1]
    for io, tv, v, k2_out in COMBOS:
        check_kernels(sh, sw, False, io, tv, v, k2_out,
                      f"io={NAME[io]},carry={NAME[tv]},k2_out={NAME[k2_out]}")
    for (gh, gw), (io, tv, v, k2_out) in ((g, c) for g in K8_GRIDS for c in K8_COMBOS):
        check_kernels(gh, gw, False, io, tv, v, k2_out,
                      f"io={NAME[io]},tv={NAME[tv]},v={NAME[v]}", names=("e1_rcarry",))
    for mode, dts in MODES.items():
        check_kernels(sh, sw, False, *dts, f"planes,{mode}", names=PLANE_KERNELS,
                      planes=PLANES)
        check_kernels(2 * K1_SPLIT[0], 2 * K1_SPLIT[1], False, *dts, mode, names=M_NAMES)
        for planes in (PLANES, *PLANES_12MP):
            check_kernels(2 * K1_SPLIT[0], 2 * K1_SPLIT[1], False, *dts, f"planes,{mode}",
                          names=M_NAMES, planes=planes)
            check_kernels(2 * W_SPLIT[0], 2 * W_SPLIT[1], False, *dts, f"planes,{mode}",
                          names=M_NAMES, planes=planes)
    for io, tv, v, k2_out in COMBOS:     # K2's, K3's and K6's split designs, general form
        check_kernels(2 * W_SPLIT[0], 2 * W_SPLIT[1], False, io, tv, v, k2_out,
                      f"io={NAME[io]},carry={NAME[tv]},k2_out={NAME[k2_out]}", names=M_NAMES)
    krows = {mode: check_kernels(ph, pw, True, *dts, mode) for mode, dts in MODES.items()}
    for mode, dts in MODES.items():
        for planes in PLANES_12MP:
            check_kernels(ph, pw, False, *dts, f"planes,{mode}", names=PLANE_KERNELS,
                          planes=planes)
    for mode, dts in MODES.items():      # K5's radix design on a guarded lane tile
        for planes in (None, PLANES):
            check_kernels(*K5_GUARDED, False, *dts, f"{'planes,' if planes else ''}{mode}",
                          names=("h_combine_dual",), planes=planes)
    for mode, dts in MODES.items():      # K4's and K14's radix design on a cut lane tile,
        # both directions
        for planes in (None, PLANES):
            tag = f"{'planes,' if planes else ''}{mode}"
            check_kernels(*K4_GUARDED, False, *dts, tag, names=K4_NAMES, planes=planes)
            check_kernels(*K4_GUARDED, False, *dts, tag, names=FULL_WIDTH_H, planes=planes,
                          cases=split_kernel_cases)
            check_kernels(*K4_GUARDED, False, *dts, tag, planes=planes,
                          names=("h_passA", "h_passA:inverse"), cases=pallas_kernel_cases)
    for io, tv, v, k2_out in COMBOS:     # K2's, K3's, K6's and K9's radix designs in
        # every combination
        for planes in (None, *PLANES_12MP):
            check_kernels(ph, pw, False, io, tv, v, k2_out,
                          f"{'planes,' if planes else ''}io={NAME[io]},carry={NAME[tv]},"
                          f"k2_out={NAME[k2_out]}", planes=planes,
                          names=("irfft_w_dual_state", "irfft_w_dual") if planes else
                          tuple(n for n in M_NAMES[1:] if n != "e1_rcarry"))
    for io, tv, v, k2_out in K8_COMBOS:  # K8's radix design in all 18, alone and stacked
        for planes in (None, *PLANES_12MP):
            check_kernels(ph, pw, False, io, tv, v, k2_out,
                          f"{'planes,' if planes else ''}io={NAME[io]},tv={NAME[tv]},"
                          f"v={NAME[v]}", planes=planes, names=("e1_rcarry",))
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssh, ssw = 2 * SMALL_SPLIT[0], 2 * SMALL_SPLIT[1]
    for combos, names in ((K10_COMBOS, ("e1_carry",)), (W_COMBOS, SPLIT_KERNELS[1:])):
        for io, tv, v, out in combos:
            check_kernels(ssh, ssw, False, io, tv, v, out,
                          f"io={NAME[io]},tv={NAME[tv]},v={NAME[v]},out={NAME[out]}",
                          names=names, cases=split_kernel_cases)
    for mode, dts in SPLIT_MODES.items():
        check_kernels(ssh, ssw, False, *dts, f"planes,{mode}", planes=PLANES,
                      cases=split_kernel_cases)
        for planes in (None, PLANES):
            check_kernels(2 * W_SPLIT[0], 2 * W_SPLIT[1], False, *dts,
                          f"planes,{mode}" if planes else mode, names=W_SPLIT_NAMES,
                          planes=planes, cases=split_kernel_cases)
    for io, tv, v, out in W_COMBOS:
        for w in (ssw, pw):
            check_kernels(ODD_ROWS, w, False, io, tv, v, out,
                          f"odd_rows,io={NAME[io]},out={NAME[out]}", names=("fft_w", "ifft_w"),
                          cases=split_kernel_cases)
    split_rows = {mode: check_kernels(ph, pw, True, *dts, mode, cases=split_kernel_cases)
                  for mode, dts in SPLIT_MODES.items()}
    for mode, dts in SPLIT_MODES.items():    # K4, K5, K14 at W on the RGB and batch=4 stacks
        for planes in PLANES_12MP:
            check_kernels(ph, pw, False, *dts, f"planes,{mode}", names=FULL_WIDTH_H,
                          planes=planes, cases=split_kernel_cases)
    k13_loop_rows = {mode: check_kernels(ph, pw, True, *dts, mode, names=("ifft_w",),
                                         cases=split_kernel_cases)["ifft_w"]
                     for mode, dts in PALLAS_K13_MODES.items()}
    counts_srt = round_trip(ph, pw, K.fft_w, K.ifft_w, seed=8)
    seconds["split_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for mode, io in PALLAS_IO.items():
        check_kernels(ssh, ssw, False, io, F32, F32, F32, f"io={mode}",
                      cases=pallas_kernel_cases)
        check_kernels(ssh, ssw, False, io, F32, F32, F32, f"planes,io={mode}",
                      planes=PLANES, cases=pallas_kernel_cases)
    for mode, io in PALLAS_IO.items():   # K15-K18's radix design on a guarded lane
        # tile and at an odd lane width, every form
        for grid, planes in ((K5_GUARDED, None), (K5_GUARDED, PLANES), (K15_ODD_W, None)):
            check_kernels(*grid, False, io, F32, F32, F32,
                          f"{'planes,' if planes else ''}io={mode}",
                          names=K15_K17_FORMS + K16_K18_FORMS, planes=planes,
                          cases=pallas_kernel_cases)
    pallas_rows = {mode: check_kernels(ph, pw, True, io, F32, F32, F32, f"io={mode}",
                                       cases=pallas_kernel_cases)
                   for mode, io in PALLAS_IO.items()}
    pallas_chains(ph, pw)
    counts_c2 = combine2_chain(ph, pw)
    synthesis = filtered_synthesis_check(ph, pw)
    seconds["split_pallas_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts_rt = round_trip(ph, pw)
    chain_yardstick(ph, pw)
    small_end_to_end()
    device_inputs_check()
    seconds["small_and_round_trip"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grids_phase()
    seconds["grids"] = time.perf_counter() - t0

    # end to end at 12 MP: scene, PSF and measurement from seed 0
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    scene, psf2d = cert_scene_psf(SENSOR, rng)
    fwd = FFTConvolver.from_psf(psf2d[None, :, :, None], pad=True,
                                norm="backward")
    meas = fwd.convolve(torch.from_numpy(scene)[None, None, :, :, None].to("cuda"))
    meas = (meas / meas.max().clamp_min(1e-9))[0, 0, :, :, 0]
    scene_n = torch.from_numpy(scene / scene.max()).to("cuda")
    del fwd

    t1 = time.perf_counter()
    pre = admm_split.precompute_rsplit(psf2d, meas.cpu().numpy())
    t_pre = time.perf_counter() - t1
    conv = admm.make_convolver(psf2d[None, :, :, None])
    data5 = meas[None, None, :, :, None]

    torch.cuda.reset_peak_memory_stats()
    n = 10
    fused, counts_f32 = counted(lambda: admm_split.run_rsplit(pre, n_iter=n),
                                want_counts(n), "f32")
    peak_fused = torch.cuda.max_memory_allocated()
    exact = admm.run(conv, data5, n_iter=n)[0, 0, :, :, 0]
    if tuple(fused.shape) != SENSOR or not bool(torch.isfinite(fused).all()):
        raise AssertionError("fused output is not finite at the sensor shape")
    p_exact, p_fused = psnr_db(exact, scene_n), psnr_db(fused, scene_n)
    diff = nerr(fused, exact)
    if not abs(p_exact - p_fused) <= TOL_PSNR_DB:
        raise AssertionError(f"PSNR exact {p_exact:.3f} vs fused {p_fused:.3f} dB")
    n3 = 3
    k3 = admm_split.run_split_rfused(pre, n_iter=n3)
    p3 = admm_split.run_split_rfused(pre, n_iter=n3, ops=K.PLAIN)
    loop_err = nerr(k3, p3)
    if not loop_err <= TOL_LOOP:
        raise AssertionError(f"fused loop kernels vs plain: {loop_err:.3e}")
    emit({"phase": "end_to_end", "grid": list(SENSOR), "padded": [ph, pw],
          "n_iter": n, "psnr_exact_db": p_exact, "psnr_fused_db": p_fused,
          "tol_db": TOL_PSNR_DB, "fused_vs_exact_normalized": diff,
          "loop_kernels_vs_plain_n3": loop_err, "tol_loop": TOL_LOOP,
          "launches": counts_f32, "precompute_s": t_pre,
          "peak_mem_fused_bytes": peak_fused,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})

    counts, deep = end_to_end_headline(pre, conv, data5, scene_n, p_exact)
    seconds["gray"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts_v2, counts_v2_f32 = v2_phase(pre, fused, scene_n, p_exact)
    seconds["v2"] = time.perf_counter() - t0
    del fused, exact, k3, p3

    t0 = time.perf_counter()
    rates = {"fused_it_per_s": rate(lambda k: admm_split.run_rsplit(pre, n_iter=k)),
             "headline_it_per_s": rate(lambda k: admm_split.run_rsplit(pre, n_iter=k,
                                                                       **HEADLINE)),
             "v2_fused_it_per_s": rate(lambda k: admm_split.run_rsplit(
                 pre, n_iter=k, placement="v2")),
             "v2_headline_it_per_s": rate(lambda k: admm_split.run_rsplit(
                 pre, n_iter=k, placement="v2", **HEADLINE)),
             "exact_it_per_s": rate(lambda k: admm.run(conv, data5, n_iter=k))}
    seconds["rate_gray"] = time.perf_counter() - t0
    del pre, data5
    t1 = time.perf_counter()
    spre = admm_split.precompute_split(psf2d, meas.cpu().numpy())
    t_spre = time.perf_counter() - t1
    split = split_phase(spre, t_spre, scene_n, p_exact, deep[100]["psnr_exact_db"])
    seconds["split"] = split["seconds"]
    rates.update({k: split[k] for k in ("split_fused_it_per_s", "split_bench_it_per_s")})
    pallas = split_pallas_phase(spre, scene_n, p_exact, deep[100]["psnr_exact_db"])
    seconds["split_pallas"] = pallas["seconds"]
    rates.update({k: pallas[k] for k in ("split_pallas_f32_it_per_s",
                                         "split_pallas_bf16_it_per_s")})
    del spre

    modes = {}
    for mode in ("rgb", "batch4"):
        modes[mode] = mode_phase(mode, scene, psf2d, conv)
        seconds[mode] = modes[mode]["seconds"]
    spatial = spatial_phase(psf2d, meas, scene_n)
    seconds["spatial"] = spatial["seconds"]
    for b in ("rpallas", "pallas"):
        rates[f"spatial_{b}_loop_it_per_s"] = spatial["gray"][b]["loop_it_per_s"]
    for mode in modes:
        rates[f"{mode}_it_per_s"] = modes[mode]["it_per_s"]
        rates[f"{mode}_plane_it_per_s"] = modes[mode]["plane_it_per_s"]
    classical = classical_phase(psf2d, meas, scene_n)
    seconds["classical"] = classical["seconds"]
    learned = learned_phase()
    seconds["learned"] = learned["seconds"]
    seconds["files"] = files_phase(psf2d, meas, scene_n)["seconds"]
    seconds["zoo_load"] = zoo_load_phase(learned)["seconds"]
    train = train_phase()
    seconds["train"] = train["seconds"]
    seconds["train_mask"] = train_mask_phase()["seconds"]
    hub = hub_phase()
    seconds["hub"] = hub["seconds"]
    cli = cli_phase(smi)
    seconds["cli"] = cli["seconds"]
    rates["hub_solve_samples_per_s"] = hub["solve_samples_per_s"]
    rates.update({f"classical_{name}_it_per_s": rec["it_per_s"]
                  for name, rec in classical["solvers"].items()})
    del meas
    emit({"phase": "rate", "grid": list(SENSOR), "method": "(n=52 - n=2) pairs",
          "unit": "solver iterations per second of the whole solve; plane_it_per_s: "
                  "times the planes", **rates, "card": smi})

    # one entry per kernel: the headline mode's numbers, the f32 mode's
    # beside them; launches from the path named by "path" (K2: its round
    # trip, no solver calls it), and those of every counted main path
    # (K10, K11: the split phase's bench mode, f32 beside it; K12-K17: the
    # pallas backend at bf16 io, f32 io beside it; the numbers of K12 and
    # K13 those of the split phase's kernel rows, of K14-K18 those of the
    # bf16 and f32 io rows, K14 and K15 in their forward form; K18: its
    # composition fft_h_combine2 at bf16 io, f32 beside it; P1-P3: the
    # bandwidth phase's timed runs, the numbers its bf16 and f32 rows at
    # br = 16, P3 with 40 constant planes; K13 also under "pallas_bf16",
    # bf16 in and out as the pallas loop runs it; K4, K5 and K14 also
    # under "full_width", the split phase's rows at the lane width W, bench
    # mode and f32).  bound_measured_ms is the bound
    # at the card's measured streaming ceiling (the bandwidth phase's
    # measured_bytes_per_s) instead of the data sheet's rate
    paths = {"end_to_end_headline": counts, "v2_headline": counts_v2,
             "rgb": modes["rgb"]["launches"], "batch4": modes["batch4"]["launches"],
             "round_trip": counts_rt, "split_bench": split["launches_bench"],
             "split_round_trip": counts_srt, "split_pallas_bf16": pallas["launches_bf16"],
             "filtered_synthesis": synthesis["launches"], "fft_h_combine2": counts_c2["bf16"],
             "bandwidth": counts_bw, "learned": learned["launches"],
             "spatial": spatial["gray"]["rpallas"]["launches"],
             "spatial_pallas": spatial["gray"]["pallas"]["launches"], "hub": hub["launches"],
             "cli": cli["launches"]}
    keys = ("max_abs_err", "max_rel_err", "max_lsb_err", "max_flip_share", "ms", "ms_method",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "bytes", "flops")
    path = {name: ("round_trip" if name == "irfft_w" else
                   "v2_headline" if name in ("e1_rcarry", "irfft_w_dual") else
                   "split_bench" if name in ("e1_carry", "ifft_w_dual") else
                   "split_pallas_bf16" if name in PALLAS_NAMES else
                   "fft_h_combine2" if name == "h_passB_combine2" else
                   "bandwidth" if name in PB.launch_counts() else
                   "end_to_end_headline") for name in KERNEL_INFO}
    f32_launches = {**counts_f32, **{k: counts_v2_f32[k] for k in ("e1_rcarry", "irfft_w_dual")},
                    "irfft_w": counts_rt["irfft_w"],
                    **{k: split["launches_f32"][k] for k in ("e1_carry", "ifft_w_dual")},
                    **{k: pallas["launches_f32"][k] for k in PALLAS_NAMES},
                    "h_passB_combine2": counts_c2["f32"]["h_passB_combine2"],
                    **{k: counts_bw_f32[k] for k in PB.launch_counts()}}
    pallas_row_names = (*PALLAS_NAMES[2:], "h_passB_combine2")
    krows["headline"].update(split_rows["bench"])
    krows["f32"].update(split_rows["f32"])
    krows["headline"].update({k: pallas_rows["bf16"][k] for k in pallas_row_names})
    krows["f32"].update({k: pallas_rows["f32"][k] for k in pallas_row_names})
    for mode, rows in probe_rows.items():
        krows[mode].update(rows)
    krows.update({mode: {"ifft_w": r} for mode, r in k13_loop_rows.items()})

    def row(name, mode):
        r = krows[mode][name]
        bound_measured = max(r["bytes"] / measured, r["flops"] / F32_FLOP_PER_S) * 1e3
        return {**{k: r[k] for k in keys}, "bound_measured_ms": bound_measured,
                **{k: r[k] for k in ("reference_ms", "reference") if k in r}}

    seconds["total"] = time.perf_counter() - t_start
    emit({"phase": "seconds", **seconds})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][1],
         "replaces": KERNEL_INFO[name][2], "label": KERNEL_INFO[name][0],
         "launches": paths[path[name]][name], "path": path[name],
         "launches_by_path": {p: c[name] for p, c in paths.items()},
         **design(name, ph, pw), **row(name, "headline"), "library_none": LIBRARY_NONE.get(name),
         "f32": {"launches": f32_launches[name], **row(name, "f32")},
         **({"inverse": {"headline": row(f"{name}:inverse", "headline"),
                         "f32": row(f"{name}:inverse", "f32")}}
            if f"{name}:inverse" in krows["headline"] else {}),
         **({"full_width": {"bench": row(f"{name}:full_width", "headline"),
                            "f32": row(f"{name}:full_width", "f32")}}
            if f"{name}:full_width" in FULL_WIDTH_H else {}),
         **{mode: row(name, mode) for mode in PALLAS_K13_MODES if name in krows[mode]}}
        for name in KERNEL_INFO]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
