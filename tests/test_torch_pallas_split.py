"""The port's pass-level split backend on the CPU: K14 ``h_passA``, K15
``h_passB`` (with and without the filter, both directions), K16
``h_passB_combine`` and K17 ``h_passB_dual`` (plain versions) against their
Pallas kernels in interpret mode (K18 ``h_passB_combine2`` in
tests/test_torch_combine2.py; here in the plane-axis test), the compositions ``fft_h``, ``ifft_h``,
``fft_h_combine``, ``ifft_h_dual`` and ``filtered_synthesis_pallas2``, and
``run_split(backend="pallas")`` / ``run_split_general`` against the JAX
package's.

Tolerances: kernel and composition outputs those of
tests/test_torch_modes.py's ``_check`` (f32 within 1e-5 of the plane's max,
bf16 within one ulp, at most 1 % of a plane not bit-equal); the round trip
and the filtered synthesis those of tests/test_pallas_fft.py:76-101 (1e-4);
the solver 1e-5 normalized at f32 (tests/test_pallas_fft.py:104-125) and
5e-2 at bf16 io (ROADMAP Queue 3: the quantized loop amplifies rounding
flips), 1e-4 for the batched solver against JAX's per-plane ``vmap``.

The JAX backend reads its io dtype from ``pk2._IO_DTYPE`` at call time; the
``jax_full_modes`` fixture of tests/test_torch_split.py patches it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2
from lenslesspicam_tpu.recon import admm_split as jsplit

from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.ops import split_fft as sf
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from test_torch_modes import TDT, TOL_LOOP, _check, _nerr, _pair
from test_torch_split import TOL_F32_LOOP, TOL_GENERAL, jax_full_modes, one_thread  # noqa: F401

P = tsplit.ADMMParams()
H, W = 96, 256                 # the H axis factors as 12 x 8
N1, N2 = sf._factor(H)
VIEW = (N1, N2, W)
SCENE = (48, 256)              # padded 96 x 512


def _planes(rng, k, io, scale=1.0):
    """k (JAX, port) pairs of random (n1, n2, W) views at ``io``."""
    return [_pair(scale * rng.randn(*VIEW).astype(np.float32), io) for _ in range(k)]


def _check_all(out, ref, n):
    assert len(out) == len(ref) == n
    for a, r in zip(out, ref):
        _check(a, r)


# ---------------------------------------------------------------------------
# K14-K17 (plain versions) against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k14_h_passA_matches_pallas(jax_full_modes, io, inverse):
    jax_full_modes(io=io)
    x = _planes(np.random.RandomState(60), 2, io)
    ref = pk2.h_passA(*(j for j, _ in x), H, inverse)
    _check_all(K.h_passA(*(t for _, t in x), H, inverse), ref, 2)


@pytest.mark.parametrize("filt", [False, True], ids=["plain", "filter"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k15_h_passB_matches_pallas(jax_full_modes, io, inverse, filt):
    jax_full_modes(io=io)
    rng = np.random.RandomState(61)
    y = _planes(rng, 2, io)
    f = _planes(rng, 2, io) if filt else [(None, None)] * 2
    ref = pk2.h_passB(*(j for j, _ in y), H, inverse, *(j for j, _ in f))
    _check_all(K.h_passB(*(t for _, t in y), H, inverse, *(t for _, t in f)), ref, 2)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k16_h_passB_combine_matches_pallas(jax_full_modes, io):
    """R at its loop scale (1/mu3 at most), H and a of order 1."""
    jax_full_modes(io=io)
    rng = np.random.RandomState(62)
    ins = _planes(rng, 6, io) + [_pair(rng.rand(*VIEW).astype(np.float32) / P.mu3, io)]
    ref = pk2.h_passB_combine(*(j for j, _ in ins), H)
    _check_all(K.h_passB_combine(*(t for _, t in ins), H), ref, 2)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k17_h_passB_dual_matches_pallas(jax_full_modes, io):
    jax_full_modes(io=io)
    ins = _planes(np.random.RandomState(63), 4, io)
    ref = pk2.h_passB_dual(*(j for j, _ in ins), H)
    _check_all(K.h_passB_dual(*(t for _, t in ins), H), ref, 4)


def _stack_cases(rng, io, n=6, nc=3):
    """name -> (stacked arguments, indices of the constant arguments)."""
    def st(k):
        return torch.from_numpy(rng.randn(k, *VIEW).astype(np.float32)).to(TDT[io])

    return {
        "h_passA": ((st(n), st(n), H, True), ()),
        "h_passB": ((st(n), st(n), H, True, st(nc), st(nc)), (4, 5)),
        "h_passB_combine": ((st(n), st(n), st(n), st(n), st(nc), st(nc), st(nc), H), (4, 5, 6)),
        "h_passB_dual": ((st(n), st(n), st(nc), st(nc), H), (2, 3)),
        "h_passB_combine2": ((st(n), st(n), st(n), st(n), st(nc), st(nc), st(nc), H), (4, 5, 6)),
    }


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["h_passA", "h_passB", "h_passB_combine", "h_passB_dual",
                                  "h_passB_combine2"])
def test_pass_kernels_plane_axis_equal_per_plane_calls(one_thread, name, io):  # noqa: F811
    """A stack of 6 planes (the constants 3 deep) through the wrapper
    equals six single-plane calls, plane p with constant plane p % 3, bit
    for bit."""
    args, const = _stack_cases(np.random.RandomState(64), io)[name]
    fn = getattr(K, name)
    stacked = fn(*args)
    for p in range(6):
        one = [a[p % 3] if i in const else (a[p] if isinstance(a, torch.Tensor) else a)
               for i, a in enumerate(args)]
        for s, q in zip(stacked, fn(*one)):
            assert torch.equal(s[p], q), (name, p)


# ---------------------------------------------------------------------------
# the compositions
# ---------------------------------------------------------------------------


def _hw(rng, k, io):
    return [_pair(rng.randn(H, W).astype(np.float32), io) for _ in range(k)]


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_compositions_match_pallas(jax_full_modes, io):
    """fft_h, ifft_h with the filter, fft_h_combine and ifft_h_dual of the
    port (plain versions) against the JAX compositions in interpret mode."""
    jax_full_modes(io=io)
    rng = np.random.RandomState(65)
    v, f, a, hh = _hw(rng, 2, io), _hw(rng, 2, io), _hw(rng, 2, io), _hw(rng, 2, io)
    r = _pair(rng.rand(H, W).astype(np.float32) / P.mu3, io)
    J = [j for j, _ in v + f + a + hh + [r]]
    T = [t for _, t in v + f + a + hh + [r]]
    _check_all(K.fft_h(T[0], T[1], H), pk2.fft_h(J[0], J[1], H), 2)
    _check_all(K.ifft_h(T[0], T[1], H, T[2], T[3]), pk2.ifft_h(J[0], J[1], H, J[2], J[3]), 2)
    _check_all(K.fft_h_combine(T[0], T[1], *T[4:9], H),
               pk2.fft_h_combine(J[0], J[1], *J[4:9], H), 2)
    out = K.ifft_h_dual(T[0], T[1], T[6], T[7], H)
    ref = pk2.ifft_h_dual(J[0], J[1], J[6], J[7], H)
    _check_all([t for z in out for t in z], [j for z in ref for j in z], 4)


@pytest.mark.parametrize("shape", [(96, 256), (2, 96, 128)], ids=["plane", "stack"])
def test_fft_h_round_trip_and_filtered_synthesis(shape):
    """ifft_w(ifft_h(fft_h(fft_w(x)))) == x within 1e-4, and
    filtered_synthesis_pallas2 against numpy's ifft2(fft2(x) fft2(k))
    within 1e-4 of max |ref| (tests/test_pallas_fft.py:76-101), on a plane
    and on a stack of two over one filter plane."""
    rng = np.random.RandomState(66)
    x = rng.rand(*shape).astype(np.float32)
    h, w = shape[-2:]
    kern = rng.rand(h, w).astype(np.float32)
    tx = torch.from_numpy(x)
    hr, hi = K.fft_h(*K.fft_w(tx), h)
    back = K.ifft_w(*K.ifft_h(hr, hi, h))
    assert float((back - tx).abs().max()) <= 1e-4
    Hs = sf.spectrum_to_split(np.fft.fft2(kern).astype(np.complex64), axes=(0, 1))
    out = K.filtered_synthesis_pallas2(tx, torch.from_numpy(Hs.real.copy()),
                                       torch.from_numpy(Hs.imag.copy()))
    ref = np.real(np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(kern)))
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() < 1e-4


def test_filtered_synthesis_matches_pallas(jax_full_modes):
    jax_full_modes()
    rng = np.random.RandomState(67)
    (jx, tx), (jr, tr), (ji, ti) = _hw(rng, 3, "f32")
    ref = pk2.filtered_synthesis_pallas2(jx, jr, ji, block_rows=32)
    _check(K.filtered_synthesis_pallas2(tx, tr, ti), ref)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


def _scene(seed=14, shape=SCENE):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(*shape).astype(np.float32)
    return psf, data / data.max()


@pytest.mark.parametrize("io,tol", [("f32", TOL_F32_LOOP), ("bf16", TOL_LOOP)])
def test_run_split_pallas_matches_jax(jax_full_modes, io, tol):
    """At 48 x 256 (padded 96 x 512), n = 3: the port's pallas loop (plain
    versions) against the JAX package's pallas backend in interpret mode
    under the same io dtype."""
    jax_full_modes(io=io)
    psf, data = _scene()
    ref = np.asarray(jsplit.run_split(jsplit.precompute_split(psf, data), jsplit.ADMMParams(),
                                      3, backend="pallas"))
    pre = tsplit.precompute_split(psf, data, device="cpu")
    out = tsplit.run_split(pre, P, 3, backend="pallas", io=io)
    assert out.dtype == torch.float32 and tuple(out.shape) == SCENE
    assert bool(torch.isfinite(out).all())
    assert _nerr(out, ref) <= tol


def test_run_split_pallas_matches_torch_backend():
    """The f32 pallas loop against the port's torch backend (the JAX "jax"
    backend), n = 10 at 48 x 64."""
    psf, data = _scene(15, (48, 64))
    pre = tsplit.precompute_split(psf, data, device="cpu")
    ref = tsplit.run_split(pre, P, 10, backend="torch")
    out = tsplit.run_split(pre, P, 10, backend="pallas")
    assert _nerr(out, ref.numpy()) <= TOL_F32_LOOP


def test_run_split_general_pallas_matches_jax():
    """RGB with depth 2 and a batch of 2, depth-1 data broadcast over
    depth, n = 5: one stack through the pallas loop against JAX's
    per-plane vmap (its "jax" backend)."""
    rng = np.random.RandomState(7)
    psf = rng.rand(2, 32, 48, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(2, 1, 32, 48, 3).astype(np.float32)
    jpre, jinfo = jsplit.precompute_split_general(psf, data)
    ref = np.asarray(jsplit.run_split_general(jpre, jinfo, jnp.asarray(data), n_iter=5))
    pre, info = tsplit.precompute_split_general(psf, data, device="cpu")
    out = tsplit.run_split_general(pre, info, data, P, 5, backend="pallas")
    assert tuple(out.shape) == ref.shape == (2, 2, 32, 48, 3)
    assert _nerr(out, ref) <= TOL_GENERAL


def test_pallas_launches_per_iteration_and_cpu_counts_nothing():
    """An n-iteration pallas solve calls K12 2n, K14 2n, K15 n, K16 n, K17
    n, K4 n and K13 2n times (through a counting kernel set), for one plane
    and for a stack; the wrappers on CPU tensors count no launch."""
    psf, data = _scene(16, (48, 64))
    pre = tsplit.precompute_split(psf, data, device="cpu")
    names = ("fft_w", "h_passA", "h_passB", "h_passB_combine", "h_passB_dual",
             "h_passA_pair", "ifft_w")
    n = 3
    for p in (pre, pre._replace(data_pad=torch.stack([pre.data_pad] * 3))):
        calls = dict.fromkeys(names, 0)

        def counting(name):
            def fn(*a, **k):
                calls[name] += 1
                return getattr(K.PLAIN, name)(*a, **k)
            return fn

        counted = tsplit.run_split_pallas(p, P, n, ops=SimpleNamespace(
            **{k: counting(k) for k in names}))
        assert calls == {"fft_w": 2 * n, "h_passA": 2 * n, "h_passB": n, "h_passB_combine": n,
                         "h_passB_dual": n, "h_passA_pair": n, "ifft_w": 2 * n}
        K.reset_launches()
        out = tsplit.run_split(p, P, n, backend="pallas")
        assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
        torch.testing.assert_close(out, counted, rtol=0, atol=0)
