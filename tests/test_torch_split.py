"""The port's full-width split solver on the CPU: the split transforms
against the JAX package's ``pallas_fft`` ones, K10 ``e1_carry``, K11
``ifft_w_dual``, K12 ``fft_w`` and K13 ``ifft_w`` (plain versions) against
their Pallas kernels in interpret mode, and ``run_split`` /
``run_split_general`` against the JAX package's.

Tolerances: the split transforms those of tests/test_pallas_fft.py:10-50
(1e-3 along W, 1e-2 after H against the natural-order FFT, 2e-5
normalized for the filtered synthesis, 1e-4 for the round trip); kernel
outputs those of tests/test_torch_modes.py's ``_check`` (f32 within 1e-5
of the plane's max, bf16 within one ulp, int16 within one LSB, at most
1 % of a plane not bit-equal); the solvers 1e-5 normalized at f32
(tests/test_pallas_fft.py:104-125), 5e-2 against the exact solver
(:54-72) and in the quantized bench mode (ROADMAP Queue 3), 1e-4 for the
batched solver against JAX's per-plane ``vmap``.  K10's carries are fed at
their KKT scale (|a| ~ tau, |b| ~ mu3), v at the order of mu1.

The JAX full-width kernel stores its TV carries at ``_CARRY_DTYPE`` (not
``_CARRY_TV_DTYPE``), so the fixture here patches ``_IO_DTYPE``,
``_CARRY_DTYPE`` and ``_CARRY_V_DTYPE``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_fft as pf
from lenslesspicam_tpu.ops import pallas_kernels2 as pk2
from lenslesspicam_tpu.recon import admm_split as jsplit

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.ops import split_fft as sf
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from test_torch_modes import JDT, TDT, TOL_LOOP, _check, _loop_scene, _nerr, _pair
from test_torch_v2 import _k8_inputs

P = tsplit.ADMMParams()
TOL_F32_LOOP = 1e-5        # normalized, tests/test_pallas_fft.py:123
TOL_EXACT = 5e-2           # split vs exact, tests/test_pallas_fft.py:72
TOL_GENERAL = 1e-4         # batched solver against JAX's per-plane vmap
# (io, carry_tv, carry_v) that the bench's headline environment (bench.py:844-846)
# gives this path: e1_carry keeps its TV carries at _CARRY_DTYPE, f32
BENCH = ("bf16", "f32", "i16")


@pytest.fixture
def jax_full_modes(monkeypatch):
    """Pallas in interpret mode; returns a setter of the storage globals the
    full-width JAX kernels and solver read at call time."""
    pk2._set_interpret(True)

    def set_modes(io="f32", tv="f32", v="f32"):
        monkeypatch.setattr(pk2, "_IO_DTYPE", JDT[io])
        monkeypatch.setattr(pk2, "_CARRY_DTYPE", JDT[tv])
        monkeypatch.setattr(pk2, "_CARRY_V_DTYPE", JDT[v])

    try:
        yield set_modes
    finally:
        pk2._set_interpret(False)


@pytest.fixture
def one_thread():
    """CPU matmuls on one thread: a multithreaded BLAS may split a long
    contraction over threads by the size of the whole batch, so a stack of
    planes and one plane alone would be summed in different orders.  The
    bit-for-bit plane tests hold the algorithm, not the BLAS partition."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


# ---------------------------------------------------------------------------
# module 1: the full-width split transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(24, 32), (48, 64), (96, 128)])
def test_split_transforms_match_pallas_fft(h, w):
    rng = np.random.RandomState(0)
    x = rng.rand(h, w).astype(np.float32)
    kern = rng.rand(h, w).astype(np.float32)
    jx = jnp.asarray(x)

    jwr, jwi = pf.fft_w_split(jx)
    wr, wi = sf.fft_w_split(_t(x))
    np.testing.assert_allclose(wr.numpy(), np.asarray(jwr), atol=1e-3)
    np.testing.assert_allclose(wi.numpy(), np.asarray(jwi), atol=1e-3)
    idx_w, idx_h = sf.split_order_indices(w), sf.split_order_indices(h)
    ref_w = np.fft.fft(x, axis=1)[:, idx_w]
    np.testing.assert_allclose(wr.numpy(), ref_w.real, atol=1e-3)

    jhr, jhi = pf.fft_h_split(jwr, jwi)
    hr, hi = sf.fft_h_split(wr, wi)
    np.testing.assert_allclose(hr.numpy(), np.asarray(jhr), atol=1e-2)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), atol=1e-2)
    ref2 = np.fft.fft2(x)[np.ix_(idx_h, idx_w)]
    np.testing.assert_allclose(hr.numpy(), ref2.real, atol=1e-2)

    jbr, jbi = pf.ifft_h_split(jhr, jhi)
    br, bi = sf.ifft_h_split(hr, hi)
    np.testing.assert_allclose(br.numpy(), np.asarray(jbr), atol=1e-4)
    np.testing.assert_allclose(bi.numpy(), np.asarray(jbi), atol=1e-4)
    back = sf.ifft_w_split(br, bi)
    np.testing.assert_allclose(back.numpy(), np.asarray(pf.ifft_w_split(jbr, jbi)), atol=1e-4)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)

    Hs = sf.spectrum_to_split(np.fft.fft2(kern).astype(np.complex64), axes=(0, 1))
    fr, fi = np.ascontiguousarray(Hs.real), np.ascontiguousarray(Hs.imag)
    out = sf.filtered_synthesis_split(_t(x), _t(fr), _t(fi)).numpy()
    jout = np.asarray(pf.filtered_synthesis_split(jx, jnp.asarray(fr), jnp.asarray(fi)))
    ref = np.real(np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(kern)))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-5)
    np.testing.assert_allclose(out / scale, jout / scale, atol=2e-5)


# ---------------------------------------------------------------------------
# K10-K13 (plain versions) against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k12_fft_w_matches_pallas(jax_full_modes, io):
    jax_full_modes(io=io)
    jx, tx = _pair(np.random.RandomState(50).randn(96, 256).astype(np.float32), io)
    ref = pk2.fft_w(jx, block_rows=32)
    out = K.fft_w(tx)
    assert len(out) == len(ref) == 2
    for a, r in zip(out, ref):
        _check(a, r)


@pytest.mark.parametrize("io,out", [("f32", "f32"), ("bf16", "f32"), ("bf16", "bf16")])
def test_k13_ifft_w_matches_pallas(jax_full_modes, io, out):
    """Spectra that are not Hermitian: the output is the real part."""
    jax_full_modes(io=io)
    rng = np.random.RandomState(51)
    (jr, tr), (ji, ti) = (_pair(rng.randn(96, 256).astype(np.float32), io) for _ in range(2))
    ref = pk2.ifft_w(jr, ji, block_rows=32, out_dtype=JDT[out])
    _check(K.ifft_w(tr, ti, out_dtype=TDT[out]), ref)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k12_k13_round_trip(io):
    """ifft_w(fft_w(x)) == x: exact at f32, within the 8-bit rounding of
    the bf16 spectra at bf16; a stack of planes and an odd row count."""
    x = torch.from_numpy(np.random.RandomState(52).randn(3, 95, 256).astype(np.float32))
    xs = x.to(TDT[io])
    back = K.ifft_w(*K.fft_w(xs))
    assert back.dtype == torch.float32 and back.shape == x.shape
    err = float((back - xs.float()).abs().max() / xs.float().abs().max())
    assert err <= (1e-6 if io == "f32" else 1e-2)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_k11_ifft_w_dual_matches_pallas(jax_full_modes, io):
    jax_full_modes(io=io)
    rng = np.random.RandomState(53)
    spec = [_pair(rng.randn(96, 256).astype(np.float32), io) for _ in range(4)]
    ref = pk2.ifft_w_dual(*(j for j, _ in spec))
    out = K.ifft_w_dual(*(t for _, t in spec))
    assert len(out) == len(ref) == 2
    for a, r in zip(out, ref):
        _check(a, r)


@pytest.mark.parametrize("io,tv,v", [("f32", "f32", "f32"), BENCH, ("bf16", "bf16", "bf16")])
def test_k10_e1_carry_matches_pallas(jax_full_modes, io, tv, v):
    jax_full_modes(io=io, tv=tv, v=v)
    ins = _k8_inputs(np.random.RandomState(54), io, tv, v, shape=(48, 64))
    consts = (P.mu1, P.mu2, P.mu3, P.tau)
    ref = pk2.e1_carry(*(j for j, _ in ins), *consts)
    out = K.e1_carry(*(t for _, t in ins), *consts)
    assert len(out) == len(ref) == 8
    for a, r in zip(out, ref):
        _check(a, r)


def _full_cases(rng, io, tv, v, n=6, nc=3, ph=96, pw=256):
    """name -> (stacked arguments, indices of the constant arguments)."""
    mask = torch.from_numpy((rng.rand(nc, ph, pw) > 0.5).astype(np.float32))
    dp = torch.from_numpy(rng.rand(n, ph, pw).astype(np.float32)) * mask.repeat(n // nc, 1, 1)

    def st(scale=1.0, dtype=io, fix=None):
        x = torch.from_numpy(scale * rng.randn(n, ph, pw).astype(np.float32))
        return K._store_carry(x, TDT[dtype], fix) if dtype == "i16" else x.to(TDT[dtype])

    return {
        "e1_carry": ((st(), st(), st(P.mu1, v, K._v_scale(P.mu1)), st(P.mu3, tv), st(P.tau, tv),
                      st(P.tau, tv), mask.to(TDT[io]), dp.to(TDT[io]), P.mu1, P.mu2, P.mu3,
                      P.tau), (6,)),
        "ifft_w_dual": ((st(), st(), st(), st()), ()),
        "fft_w": ((st(),), ()),
        "ifft_w": ((st(), st()), ()),
    }


@pytest.mark.parametrize("modes", [("f32", "f32", "f32"), BENCH], ids=["f32", "bench"])
@pytest.mark.parametrize("name", ["e1_carry", "ifft_w_dual", "fft_w", "ifft_w"])
def test_full_width_plane_axis_equals_per_plane_calls(one_thread, name, modes):
    """A stack of 6 planes (the mask 3 deep) through the wrapper equals six
    2-D calls, plane p with mask plane p % 3, bit for bit."""
    args, const = _full_cases(np.random.RandomState(55), *modes)[name]
    fn = getattr(K, name)
    stacked = fn(*args)
    stacked = stacked if isinstance(stacked, tuple) else (stacked,)
    for p in range(6):
        one = [a[p % 3] if i in const else (a[p] if isinstance(a, torch.Tensor) else a)
               for i, a in enumerate(args)]
        per = fn(*one)
        per = per if isinstance(per, tuple) else (per,)
        for s, q in zip(stacked, per):
            assert torch.equal(s[p], q), (name, p)


def test_k10_has_no_int16_tv_carries():
    args = list(_full_cases(np.random.RandomState(56), "bf16", "f32", "i16")["e1_carry"][0])
    for i in (3, 4, 5):
        args[i] = args[i].to(torch.int16)
    with pytest.raises(TypeError):
        K.e1_carry(*args)


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------


def _scene(seed=11, shape=(48, 64)):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    return psf, rng.rand(*shape).astype(np.float32)


def test_precompute_split_equals_jax_and_converts():
    """The port's precompute, and the JAX one carried over with
    ``convert.split_precomp``: equal arrays, rtol = atol = 0."""
    psf, data = _scene()
    jpre = jsplit.precompute_split(psf, data)
    arrays = {f: np.asarray(getattr(jpre, f)) for f in tsplit.SPLIT_FIELDS}
    own = tsplit.precompute_split(psf, data, device="cpu")
    conv = convert.split_precomp(arrays, jpre.psf_shape, jpre.padded_shape, jpre.start,
                                 device="cpu")
    for pre in (own, conv):
        for f in tsplit.SPLIT_FIELDS:
            torch.testing.assert_close(getattr(pre, f), torch.from_numpy(arrays[f].copy()),
                                       rtol=0, atol=0)
        assert (pre.psf_shape, pre.padded_shape, pre.start) == (
            jpre.psf_shape, jpre.padded_shape, jpre.start)
    out = tsplit.run_split(conv, P, 3)
    torch.testing.assert_close(out, tsplit.run_split(own, P, 3), rtol=0, atol=0)


@pytest.mark.parametrize("backend,jbackend", [("torch", "jax"), ("fused", "fused")])
def test_run_split_matches_jax(jax_full_modes, backend, jbackend):
    """At 48 x 64, n = 10: the torch backend against JAX's "jax" one, the
    fused loop (plain versions) against JAX's fused one in interpret mode;
    the fused loop against the port's exact solver."""
    jax_full_modes()
    psf, data = _scene()
    ref = np.asarray(jsplit.run_split_jit(jsplit.precompute_split(psf, data),
                                          jsplit.ADMMParams(), 10, backend=jbackend))
    pre = tsplit.precompute_split(psf, data, device="cpu")
    out = tsplit.run_split(pre, P, 10, backend=backend)
    assert out.dtype == torch.float32 and tuple(out.shape) == (48, 64)
    assert _nerr(out, ref) <= TOL_F32_LOOP
    conv = tadmm.make_convolver(psf[None, :, :, None], device="cpu")
    exact = tadmm.run(conv, data[None, None, :, :, None], n_iter=10)[0, 0, :, :, 0]
    assert _nerr(out, exact.numpy()) <= TOL_EXACT


def test_bench_mode_matches_jax(jax_full_modes):
    """The bench's headline environment on the full-width path (io bf16,
    TV carries f32, v int16) against the JAX loop under the same globals,
    n = 20."""
    io, tv, v = BENCH
    jax_full_modes(io=io, tv=tv, v=v)
    psf, data = _loop_scene(12, (48, 64))
    ref = np.asarray(jsplit.run_split_fused(jsplit.precompute_split(psf, data),
                                            jsplit.ADMMParams(), 20))
    pre = tsplit.precompute_split(psf, data, device="cpu")
    out = tsplit.run_split(pre, P, 20, backend="fused", io=io, carry_tv=tv, carry_v=v)
    assert bool(torch.isfinite(out).all())
    assert _nerr(out, ref) <= TOL_LOOP


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_run_split_general_matches_jax(backend):
    """RGB with depth 2 and a batch of 2, depth-1 data broadcast over
    depth, n = 5: against JAX's per-plane vmap (its "jax" backend)."""
    rng = np.random.RandomState(5)
    psf = rng.rand(2, 32, 48, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(2, 1, 32, 48, 3).astype(np.float32)
    jpre, jinfo = jsplit.precompute_split_general(psf, data)
    ref = np.asarray(jsplit.run_split_general(jpre, jinfo, jnp.asarray(data), n_iter=5))
    pre, info = tsplit.precompute_split_general(psf, data, device="cpu")
    assert info == jinfo and pre.Hr.shape[0] == 6
    out = tsplit.run_split_general(pre, info, data, P, 5, backend=backend)
    assert tuple(out.shape) == ref.shape == (2, 2, 32, 48, 3)
    assert _nerr(out, ref) <= TOL_GENERAL


def test_split_general_stack_equals_per_plane_calls(one_thread):
    """The fused batched solve (one stack of 12 planes over 6 constant
    planes, bench mode) equals the gray fused solve of each plane, bit for
    bit; convert.split_general_precomp carries JAX's stacked precompute
    over exactly."""
    rng = np.random.RandomState(6)
    psf = rng.rand(2, 32, 48, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(2, 1, 32, 48, 3).astype(np.float32)
    pre, info = tsplit.precompute_split_general(psf, data, device="cpu")
    io, tv, v = BENCH
    out = tsplit.run_split_general(pre, info, data, P, 4, backend="fused", io=io,
                                   carry_tv=tv, carry_v=v)
    for b in range(2):
        for d in range(2):
            for c in range(3):
                gray = tsplit.precompute_split(psf[d, :, :, c], data[b, 0, :, :, c],
                                               device="cpu")
                ref = tsplit.run_split(gray, P, 4, backend="fused", io=io, carry_tv=tv,
                                       carry_v=v)
                assert torch.equal(out[b, d, :, :, c], ref), (b, d, c)
    jpre, jinfo = jsplit.precompute_split_general(psf, data)
    conv, cinfo = convert.split_general_precomp(
        {f: np.asarray(getattr(jpre, f)) for f in tsplit.SPLIT_FIELDS}, jinfo,
        jpre.psf_shape, jpre.padded_shape, jpre.start, device="cpu")
    assert cinfo == info
    for f in tsplit.SPLIT_FIELDS:
        torch.testing.assert_close(getattr(conv, f), getattr(pre, f), rtol=0, atol=0)


def test_fused_launches_per_iteration_and_cpu_counts_nothing():
    """An n-iteration fused solve calls K10 n times, K4 2n, K5 n, K11 n
    (through a counting kernel set); the wrappers on CPU tensors count no
    launch."""
    psf, data = _scene(3)
    pre = tsplit.precompute_split(psf, data, device="cpu")
    calls = dict.fromkeys(("e1_carry", "h_passA_pair", "h_combine_dual", "ifft_w_dual"), 0)

    def counting(name):
        def fn(*a, **k):
            calls[name] += 1
            return getattr(K.PLAIN, name)(*a, **k)
        return fn

    ops = SimpleNamespace(**{n: counting(n) for n in calls})
    n = 4
    counted = tsplit.run_split_fused(pre, P, n, ops=ops)
    assert calls == {"e1_carry": n, "h_passA_pair": 2 * n, "h_combine_dual": n,
                     "ifft_w_dual": n}
    K.reset_launches()
    out = tsplit.run_split(pre, P, n, backend="fused")
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
    torch.testing.assert_close(out, counted, rtol=0, atol=0)


def test_split_modes_and_backends_are_validated(monkeypatch):
    psf, data = _scene(4)
    pre = tsplit.precompute_split(psf, data, device="cpu")
    with pytest.raises(ValueError, match="no int16 TV carries"):
        tsplit.run_split(pre, P, 1, backend="fused", io="bf16", carry_tv="i16", carry_v="i16")
    with pytest.raises(ValueError, match="no carries"):
        tsplit.run_split(pre, P, 1, backend="pallas", io="bf16", carry_v="i16")
    with pytest.raises(ValueError):
        tsplit.run_split(pre, P, 1, backend="numpy")
    with pytest.raises(ValueError):
        tsplit.run_split(pre, P, 1, backend="jax", io="bf16")
    with pytest.raises(ValueError):
        tsplit.run_split(pre, P, 1, backend="torch", io="bf16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsplit.precompute_split(psf, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsplit.precompute_split_general(psf[None, :, :, None], data[None, :, :, None])
