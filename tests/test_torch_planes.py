"""The port's batched RGB / 3-D fused solver and the plane axis of its
kernels, on the CPU.

``run_rsplit_general`` is held to the JAX package's (nested ``vmap`` over
the Pallas kernels in interpret mode) and the exact solver to
``admm.run_jit`` at RGB, batch and depth 2; each kernel's plain version
given a stack of P = 6 planes with Pc = 3 constant planes equals six
2-D calls, plane p with constant plane p % Pc, bit for bit; the
precompute equals JAX's exactly.  Tolerances: 1e-5 normalized at f32
(tests/test_pallas_fft.py:288-309), the 5e-2 of tests/test_torch_modes.py
in the headline mode.
"""

import numpy as np
import pytest
import torch

from lenslesspicam_tpu.recon import admm as jadmm
from lenslesspicam_tpu.recon import admm_split as jsplit

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from test_torch_modes import TDT, TOL_LOOP, _nerr, jax_modes  # noqa: F401

from test_torch_scripts import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

P = tsplit.ADMMParams()
TOL_SOLVER = 1e-5          # normalized, tests/test_torch_admm.py:24
N_PLANES, N_CONST = 6, 3
F32 = ("f32", "f32", "f32")
HEADLINE = ("bf16", "i16", "i16")


def _scene(seed, psf_shape, data_shape):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*psf_shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(*data_shape).astype(np.float32)
    return psf, data / data.max()


# (PSF shape, data shape, storage modes): RGB with a batch of 2, as
# tests/test_pallas_fft.py:288-309; depth 2 with depth-1 data broadcast
# over it, in f32 and in the headline mode
GENERAL_CASES = [((1, 48, 64, 3), (2, 1, 48, 64, 3), F32),
                 ((2, 48, 64, 3), (1, 1, 48, 64, 3), F32),
                 ((2, 48, 64, 3), (1, 1, 48, 64, 3), HEADLINE)]


@pytest.mark.parametrize("psf_shape,data_shape,modes", GENERAL_CASES)
def test_rsplit_general_matches_jax(jax_modes, psf_shape, data_shape, modes):
    io, tv, v = modes
    jax_modes(io=io, tv=tv, v=v)
    psf, data = _scene(2, psf_shape, data_shape)
    jpre, jinfo = jsplit.precompute_rsplit_general(psf, data)
    ref, jsat = jsplit.run_rsplit_general(jpre, jinfo, data, jsplit.ADMMParams(), 10,
                                          return_sat=True)
    pre, info = tsplit.precompute_rsplit_general(psf, data, device="cpu")
    assert info == jinfo
    out, sat = tsplit.run_rsplit_general(pre, info, data, P, 10, return_sat=True, io=io,
                                         carry_tv=tv, carry_v=v)
    assert tuple(out.shape) == tuple(ref.shape) == (data_shape[0], psf_shape[0],
                                                    *psf_shape[1:])
    assert _nerr(out, ref) <= (TOL_SOLVER if modes == F32 else TOL_LOOP)
    if modes == F32:
        assert sat == 0.0 and float(jsat) == 0.0
    else:
        assert 0.0 < sat < 1.0 and 0.0 < float(jsat) < 1.0


@pytest.mark.parametrize("placement", ["v3", "v2"])
def test_rsplit_general_is_per_plane_gray(placement):
    """Each plane of the batched solve equals the gray solve of that
    plane alone, to 1e-5 normalized, in both placements."""
    psf, data = _scene(6, (1, 48, 64, 3), (2, 1, 48, 64, 3))
    pre, info = tsplit.precompute_rsplit_general(psf, data, device="cpu")
    out = tsplit.run_rsplit_general(pre, info, data, P, 6, placement=placement)
    for b in range(2):
        for c in range(3):
            gray = tsplit.precompute_rsplit(psf[0, :, :, c], data[b, 0, :, :, c], device="cpu")
            ref = tsplit.run_rsplit(gray, P, 6, placement=placement)
            assert _nerr(out[b, 0, :, :, c], ref.numpy()) <= TOL_SOLVER


def test_precompute_rsplit_general_equals_jax():
    """The port's precompute and the JAX one carried over with
    ``convert.rsplit_general_precomp``: equal arrays, rtol = atol = 0."""
    psf, data = _scene(8, (2, 48, 64, 3), (2, 1, 48, 64, 3))
    jpre, jinfo = jsplit.precompute_rsplit_general(psf, data)
    own, info = tsplit.precompute_rsplit_general(psf, data, device="cpu")
    conv, cinfo = convert.rsplit_general_precomp(
        {f: np.asarray(getattr(jpre, f)) for f in tsplit.ARRAY_FIELDS}, jinfo,
        jpre.psf_shape, jpre.padded_shape, jpre.start, device="cpu")
    assert info == cinfo == jinfo
    for pre in (own, conv):
        for f in tsplit.ARRAY_FIELDS:
            torch.testing.assert_close(getattr(pre, f), torch.from_numpy(
                np.array(getattr(jpre, f))), rtol=0, atol=0)
        assert (pre.psf_shape, pre.padded_shape, pre.start) == (
            jpre.psf_shape, jpre.padded_shape, jpre.start)
    assert own.Hr.shape == (6, 96, 64)


@pytest.mark.parametrize("psf_shape,data_shape", [((1, 48, 64, 3), (2, 1, 48, 64, 3)),
                                                  ((2, 48, 64, 3), (1, 2, 48, 64, 3))])
def test_exact_solver_rgb_batch_depth_matches_jax(psf_shape, data_shape):
    psf, data = _scene(9, psf_shape, data_shape)
    ref = jadmm.run_jit(jadmm.make_convolver(psf), data, n_iter=10)
    out = tadmm.run(tadmm.make_convolver(psf, device="cpu"), data, n_iter=10)
    assert tuple(out.shape) == tuple(ref.shape) == data_shape
    assert _nerr(out, ref) <= TOL_SOLVER


# ---------------------------------------------------------------------------
# the plane axis of each kernel's plain version
# ---------------------------------------------------------------------------


def _stack(rng, n, *shape, scale=1.0, dtype="f32", fix=None):
    """n seeded planes as one (n, ...) tensor in a storage dtype (int16:
    fixed point at ``fix``)."""
    x = scale * rng.randn(n, *shape).astype(np.float32)
    t = torch.from_numpy(x)
    if dtype == "i16":
        return K._store_carry(t, torch.int16, fix)
    return t.to(TDT[dtype])


def _cases(rng, io, tv, v):
    """name -> (stacked arguments, indices of the constant arguments)."""
    ph, pw, m = 96, 128, 64
    h1, h2 = K.factors(ph)
    n, nc = N_PLANES, N_CONST
    sc_a, sc_b = K._tv_scales(P.mu2, P.mu3, P.tau)
    mask = torch.from_numpy((rng.rand(nc, ph, pw) > 0.5).astype(np.float32))
    dp = torch.from_numpy(rng.rand(n, ph, pw).astype(np.float32)) * mask.repeat(2, 1, 1)
    mask, dp = mask.to(TDT[io]), dp.to(TDT[io])
    vv = _stack(rng, n, ph, pw, scale=P.mu1, dtype=v, fix=K._v_scale(P.mu1))
    tvs = [_stack(rng, n, ph, pw, scale=s, dtype=tv, fix=f)
           for s, f in ((P.tau, sc_a), (P.tau, sc_a), (P.mu3, sc_b))]
    cols = [torch.from_numpy(rng.randn(n, ph).astype(np.float32)) for _ in range(4)]
    spec = [_stack(rng, n, ph, m, dtype=io) for _ in range(4)]
    return {
        "rfft_w": ((_stack(rng, n, ph, pw, dtype=io),), ()),
        "e1_rtv": ((_stack(rng, n, ph, pw, dtype=io), *tvs, P.mu2, P.mu3, P.tau), ()),
        "h_passA_pair": ((*[_stack(rng, n, h1, h2, m, dtype=io) for _ in range(4)], ph,
                          True), ()),
        "h_combine_dual": ((*[_stack(rng, n, h1, h2, m, dtype=io) for _ in range(4)],
                            *[_stack(rng, nc, h1, h2, m, dtype=io) for _ in range(3)], ph),
                           (4, 5, 6)),
        "irfft_w_dual_state": ((*spec, *cols, vv, mask, dp, P.mu1), (9,)),
        "e1_rcarry": ((_stack(rng, n, ph, pw, dtype=io), _stack(rng, n, ph, pw, dtype=io),
                       vv, tvs[2], tvs[0], tvs[1], mask, dp, P.mu1, P.mu2, P.mu3, P.tau),
                      (6,)),
        "irfft_w_dual": ((*spec, *cols), ()),
    }


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _flat(y)]
    return [x]


@pytest.mark.parametrize("modes", [F32, HEADLINE], ids=["f32", "headline"])
@pytest.mark.parametrize("name", ["rfft_w", "e1_rtv", "h_passA_pair", "h_combine_dual",
                                  "irfft_w_dual_state", "e1_rcarry", "irfft_w_dual"])
def test_plane_axis_equals_per_plane_calls(name, modes):
    """A stack of P = 6 planes with Pc = 3 constant planes through the
    wrapper (plain version on the CPU) == six 2-D calls, plane p with
    constant plane p % 3, bit for bit; a saturation value is the max of
    the planes'."""
    args, const = _cases(np.random.RandomState(40), *modes)[name]
    fn = getattr(K, name)
    stacked = _flat(fn(*args))
    per = []
    for p in range(N_PLANES):
        one = [a[p % N_CONST] if i in const else (a[p] if isinstance(a, torch.Tensor) else a)
               for i, a in enumerate(args)]
        per.append(_flat(fn(*one)))
    assert len(stacked) == len(per[0])
    for k, out in enumerate(stacked):
        if isinstance(out, torch.Tensor) and out.dim() > 0:
            assert tuple(out.shape[:1]) == (N_PLANES,)
            for p in range(N_PLANES):
                assert torch.equal(out[p], per[p][k]), (name, k, p)
        else:
            assert float(out) == max(float(q[k]) for q in per)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_precompute_rsplit_general_without_cuda_raises(no_cuda):
    psf = np.ones((1, 48, 64, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsplit.precompute_rsplit_general(psf, psf)
    pre, _ = tsplit.precompute_rsplit_general(psf, psf, device="cpu")
    assert pre.Hr.device.type == "cpu"


def test_planes_must_repeat_the_constants():
    """P % Pc != 0 raises ValueError, in the solver and in each kernel
    that takes constants."""
    rng = np.random.RandomState(41)
    psf, data = _scene(10, (1, 48, 64, 3), (1, 1, 48, 64, 3))
    pre, _ = tsplit.precompute_rsplit_general(psf, data, device="cpu")
    bad = pre._replace(data_pad=torch.zeros(4, 96, 128))
    with pytest.raises(ValueError, match="P % Pc|repeats"):
        tsplit.run_split_rfused(bad, P, 1)
    cases = _cases(rng, *F32)
    for name, (args, const) in cases.items():
        if not const:
            continue
        cut = [a[:4] if isinstance(a, torch.Tensor) and i not in const else a
               for i, a in enumerate(args)]
        with pytest.raises(ValueError, match="P % Pc"):
            getattr(K, name)(*cut)
