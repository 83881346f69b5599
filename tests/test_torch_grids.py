"""Every grid the reference solves, on the CPU.

The CUDA kernels' split designs once refused shapes that the plain
versions and the JAX package take (the JAX package falls back to Pallas
interpret mode there, ``pallas_kernels2.py`` ``rfused_mosaic_ok``): a
factor of an axis that is not a multiple of 4 or n1 = 1 (the 4 x 4
register tile of ``dft_pass``), a lane width that is not a multiple of an
H kernel's tile, a row length that is not a multiple of a 16-byte vector.
Their general form (``general_form`` in ``csrc/lpt_dft.cuh``) takes every
shape.  Held here:

- the wrappers' card path (``_on_card`` true, the launch recorded instead
  of made) takes every kernel at the grids once refused, among them the
  published baseline's 540 x 960 and the lane widths 480 and 30;
- a numpy model of ``dft_pass``'s tail tiling writes every (k, vector)
  pair once and reads only inside the stage;
- the plain solvers (v3, the full-width fused and pallas loops) match the
  JAX package's in Pallas interpret mode on small grids whose padded axes
  fall in each refused class, to the tolerances of tests/test_torch_admm.py
  (TOL_SOLVER) and tests/test_torch_split.py (TOL_F32_LOOP);
- the v3 loop in the headline mode (bf16 io, int16 carries) at the
  smallest sensor of ``chip_smoke.GRIDS``, on its scene, matches the JAX
  package's within the 2-byte loop tolerance, and its PSNR offset from the
  exact solver, which ``chip_smoke`` gates one-sided there, is the JAX
  package's within TOL_OFFSET_DB.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2
from lenslesspicam_tpu.recon import admm as jadmm
from lenslesspicam_tpu.recon import admm_split as jsplit

import chip_smoke as cs
from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.ops.fft_conv import FFTConvolver
from lenslesspicam_tpu_torch.ops.padding import padded_size
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit

from test_torch_scripts import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL_SOLVER = 1e-5          # v3 against JAX, normalized (tests/test_torch_admm.py)
TOL_F32_LOOP = 1e-5        # full width against JAX, normalized (tests/test_torch_split.py)
TOL_LOOP_HEADLINE = 2e-2   # the 2-byte loop, normalized (chip_smoke.TOL_LOOP_HEADLINE)
TOL_OFFSET_DB = 0.01       # headline PSNR minus exact PSNR, port against JAX
KT = VT = 4                # dft_pass's register tile (csrc/lpt_dft.cuh)
TAIL_LENGTHS = (1, 3, 5, 6, 9, 20, 27, 30)
# padded grids the card once refused: the published baseline's (H 27 x 20,
# W 32 x 30, lane width 480), 12 MP at 1/8 (H 6 x 128), 240 x 320 (W 5 x
# 128), the verify probe's (W 1 x 128), an odd half width (M 27) and the
# lane width 30 (M = 30)
REFUSED_GRIDS = ((540, 960), (768, 1024), (480, 640), (96, 128), (48, 54), (40, 60))
# sensors whose padded axes fall in each refused class: a factor not a
# multiple of 4 and an odd half width (48 x 54: H 8 x 6, M 27 = 9 x 3), a
# lane width not a multiple of 64 (40 x 60: M = 30, H 8 x 5), n1 = 1 (96 x
# 128: W 1 x 128)
SOLVER_SENSORS = ((24, 27), (20, 28), (48, 64))
P = tsplit.ADMMParams()


@pytest.fixture
def interpret():
    pk2._set_interpret(True)
    try:
        yield
    finally:
        pk2._set_interpret(False)


@pytest.fixture
def card_path(monkeypatch):
    """The wrappers' CUDA path on CPU tensors: ``_on_card`` keeps its dtype
    check and says yes, and each launch is recorded instead of made.
    Returns the list of (C entry, arguments)."""
    launched = []

    def on_card(name, tensors, combo, built, cols=()):
        if combo not in built:
            raise TypeError(f"{name}: no CUDA kernel for dtypes {combo}")
        return True

    monkeypatch.setattr(K, "_on_card", on_card)
    monkeypatch.setattr(K, "_launch", lambda lib, fn, sig, *args: launched.append((fn, args)))
    return launched


def test_factors_of_the_refused_lengths():
    """540, 768, 960, 640 and 128 factor as the plain versions factor
    them; the split designs take those factors on the card."""
    want = {540: (27, 20), 768: (6, 128), 960: (32, 30), 640: (5, 128), 128: (1, 128),
            480: (24, 20), 30: (6, 5)}
    for n, f in want.items():
        assert K.factors(n) == f
        assert f[0] * f[1] == n


@pytest.mark.parametrize("grid", REFUSED_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("cases,mode", [
    (cs.kernel_cases, "f32"), (cs.kernel_cases, "headline"),
    (cs.split_kernel_cases, "f32"), (cs.split_kernel_cases, "bench"),
    (cs.pallas_kernel_cases, "f32"), (cs.pallas_kernel_cases, "bf16")],
    ids=["rsplit-f32", "rsplit-headline", "split-f32", "split-bench", "pallas-f32",
         "pallas-bf16"])
def test_card_path_takes_every_grid(card_path, grid, cases, mode):
    """Every kernel's wrapper reaches its launch at the grid, on one plane
    and on a stack of 2 over 1, with the (n1, n2) the plain versions use;
    the H kernels at the lane widths M (half width) and W."""
    ph, pw = grid
    dts = {**cs.MODES, **cs.SPLIT_MODES, "bf16": (cs.BF16, cs.F32, cs.F32, cs.F32)}[mode]
    for planes in (None, (2, 1)):
        gen = torch.Generator().manual_seed(1)
        for name, (args, _) in cases(ph, pw, gen, *dts, planes=planes).items():
            fn = name.split(":")[0]
            del card_path[:]
            getattr(K, fn)(*args)
            assert len(card_path) == 1, name
            ints = [a for a in card_path[0][1] if type(a) is int]
            for n in ((ph,) if fn.startswith("h_") else
                      (pw,) if fn in ("e1_carry", "ifft_w_dual", "fft_w", "ifft_w") else
                      (pw // 2,) if fn != "sat_scan_i16" else ()):
                n1, n2 = K.factors(n)
                assert any(ints[i:i + 2] == [n1, n2] for i in range(len(ints))), (name, ints)


def test_card_path_names_the_lane_widths(card_path):
    """The H kernels take the lane widths 480 (the baseline grid's half
    width) and 30, which are not multiples of their 64- and 32-lane
    tiles."""
    for h, w in ((540, 480), (40, 30)):
        n1, n2 = K.factors(h)
        planes = [torch.zeros(n1, n2, w) for _ in range(7)]
        K.h_passA_pair(*planes[:4], h, False)
        K.h_combine_dual(*planes, h)
        K.h_passB(*planes[:2], h, True, *planes[2:4])
    assert [fn for fn, _ in card_path] == ["lpt_h_pass_a_pair", "lpt_h_combine_dual",
                                           "lpt_h_pass_b"] * 2
    # the lane width precedes (inverse, io) in K4's and K15's entries, io in K5's
    widths = [[a for a in args if type(a) is int][-2 if fn == "lpt_h_combine_dual" else -3]
              for fn, args in card_path]
    assert widths == [480] * 3 + [30] * 3


def _tail_tiling(length, nvec, tail):
    """dft_pass's tiles over (k < L, vector g < nvec): the tile counts
    (rounded up in the tail form), each tile's KT outputs and VT vectors
    g = tv + b vtiles, the indices it reads (k and g clamped in the tail
    form) and the pairs it stores (those inside the stage).  Returns the
    store count of each pair and the largest index read of k and g."""
    ktiles = -(-length // KT) if tail else length // KT
    vtiles = -(-nvec // VT) if tail else nvec // VT
    stored = np.zeros((length, nvec), int)
    read_k = read_g = 0
    for t in range(ktiles * vtiles):
        tv, k0 = t % vtiles, (t // vtiles) * KT
        for a, b in itertools.product(range(KT), range(VT)):
            k, g = k0 + a, tv + b * vtiles
            read_k = max(read_k, min(k, length - 1) if tail else k)
            read_g = max(read_g, min(g, nvec - 1) if tail else g)
            if tail and (k >= length or g >= nvec):
                continue
            stored[k, g] += 1
    return stored, read_k, read_g


@pytest.mark.parametrize("length,nvec", list(itertools.product(TAIL_LENGTHS, TAIL_LENGTHS)))
def test_tail_tiling_covers_each_pair_once(length, nvec):
    stored, read_k, read_g = _tail_tiling(length, nvec, tail=True)
    assert (stored == 1).all()
    assert read_k < length and read_g < nvec


def test_fast_tiling_is_the_tail_tiling_on_multiples_of_4():
    """Where L and nvec are multiples of 4 the fast form's tiles are the
    tail form's, and cover every pair once; elsewhere the fast form would
    drop the last L % 4 outputs (the refusal the general form lifts)."""
    for length, nvec in ((4, 4), (8, 20), (32, 128), (20, 12)):
        fast, _, _ = _tail_tiling(length, nvec, tail=False)
        assert (fast == 1).all()
        assert np.array_equal(fast, _tail_tiling(length, nvec, tail=True)[0])
    fast, _, _ = _tail_tiling(27, 20, tail=False)
    assert (fast[24:] == 0).all()


def _scene(shape, seed=3):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    return psf, rng.rand(*shape).astype(np.float32)


def _nerr(out, ref):
    return float(np.abs(out.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("sensor", SOLVER_SENSORS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_v3_solver_matches_jax(interpret, sensor):
    """The fused v3 loop (plain versions) against JAX's run_rsplit_jit in
    interpret mode at n = 10."""
    psf, data = _scene(sensor)
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    assert pre.padded_shape == tuple(padded_size(s) for s in sensor)
    ref = np.asarray(jsplit.run_rsplit_jit(jsplit.precompute_rsplit(psf, data),
                                           jsplit.ADMMParams(), 10))
    out = tsplit.run_rsplit(pre, P, 10)
    assert tuple(out.shape) == sensor and bool(torch.isfinite(out).all())
    assert _nerr(out, ref) <= TOL_SOLVER


@pytest.mark.parametrize("backend", ["fused", "pallas"])
@pytest.mark.parametrize("sensor", SOLVER_SENSORS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_full_width_solver_matches_jax(interpret, sensor, backend):
    """The full-width fused and pallas loops (plain versions) against
    JAX's run_split_jit with the same backend in interpret mode, n = 10."""
    psf, data = _scene(sensor)
    ref = np.asarray(jsplit.run_split_jit(jsplit.precompute_split(psf, data),
                                          jsplit.ADMMParams(), 10, backend=backend))
    out = tsplit.run_split(tsplit.precompute_split(psf, data, device="cpu"), P, 10,
                           backend=backend)
    assert tuple(out.shape) == sensor and bool(torch.isfinite(out).all())
    assert _nerr(out, ref) <= TOL_F32_LOOP


def test_headline_offset_at_the_smallest_grid_is_the_references(monkeypatch):
    """The v3 loop (plain versions) in the headline mode at 48 x 135 (padded
    96 x 270), n = 10, on ``chip_smoke.grids_phase``'s scene, against JAX's
    run_rsplit_jit in interpret mode with its storage globals set to the
    same mode; the PSNR offset of the headline mode from the exact solver
    is the same in both packages."""
    sensor, n = cs.GRIDS[-1], 10
    assert sensor == (48, 135)
    scene, psf = cs.cert_scene_psf(sensor, np.random.RandomState(16))
    fwd = FFTConvolver.from_psf(psf[None, :, :, None], pad=True, norm="backward", device="cpu")
    meas = fwd.convolve(torch.from_numpy(scene)[None, None, :, :, None])
    meas = (meas / meas.max()).numpy()[0, 0, :, :, 0]
    scene_n = torch.from_numpy(scene / scene.max())

    exact = tadmm.run(tadmm.make_convolver(psf[None, :, :, None], device="cpu"),
                      meas[None, None, :, :, None], n_iter=n)[0, 0, :, :, 0]
    jexact = jadmm.run_jit(jadmm.make_convolver(psf[None, :, :, None]),
                           meas[None, None, :, :, None], n_iter=n)[0, 0, :, :, 0]
    out = tsplit.run_rsplit(tsplit.precompute_rsplit(psf, meas, device="cpu"), P, n,
                            io="bf16", carry_tv="i16", carry_v="i16")
    pk2._set_interpret(True)
    for name, dtype in (("_IO_DTYPE", jnp.bfloat16), ("_CARRY_TV_DTYPE", jnp.int16),
                        ("_CARRY_V_DTYPE", jnp.int16)):
        monkeypatch.setattr(pk2, name, dtype)
    jax.clear_caches()      # no f32 trace of this shape may serve the call
    try:
        ref = np.array(jsplit.run_rsplit_jit(jsplit.precompute_rsplit(psf, meas),
                                             jsplit.ADMMParams(), n))
    finally:
        pk2._set_interpret(False)
        jax.clear_caches()
    assert tuple(out.shape) == sensor and _nerr(out, ref) <= TOL_LOOP_HEADLINE
    offset = cs.psnr_db(out, scene_n) - cs.psnr_db(exact, scene_n)
    joffset = (cs.psnr_db(torch.from_numpy(ref), scene_n)
               - cs.psnr_db(torch.from_numpy(np.array(jexact)), scene_n))
    assert abs(offset - joffset) <= TOL_OFFSET_DB, (offset, joffset)
