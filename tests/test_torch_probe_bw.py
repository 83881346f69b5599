"""The port's bandwidth probe P1-P3 (``ops/probe_bw.py``) on the CPU.

The JAX script scripts/dev/_probe_bw.py has no interpret switch, but its
Pallas kernel bodies run as they are on numpy buffers passed in place of
refs: each plain version is held to its kernel body bit for bit, for
every dtype the script runs (P3 at its 4 and 40 constant planes), on a
(32, 256) plane.  The script is loaded from its file and stays unchanged.
``timed`` is held to a fake clock: one that moves with the work gives the
expected figure, one that does not raises.
"""

import importlib.util
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lenslesspicam_tpu_torch.ops import probe_bw as PB

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "dev" / "_probe_bw.py"
SHAPE = (32, 256)
DT = {"f32": (torch.float32, np.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
      "f16": (torch.float16, np.float16), "i32": (torch.int32, np.int32)}


@pytest.fixture(scope="module")
def jaxbw():
    spec = importlib.util.spec_from_file_location("_probe_bw_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plane(name, seed=0):
    """(numpy buffer, tensor) of the same values at dtype ``name``: normal
    values over several binades, a negative zero and, for i32, integers."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*SHAPE) * np.exp2(rng.randint(-8, 9, SHAPE))).astype(np.float32)
    x[0, 0], x[1, 1] = -0.0, 0.0
    tdt, ndt = DT[name]
    if name == "i32":
        x = (x * 1000).astype(np.int32)
    a = x.astype(ndt)
    t = torch.from_numpy(x).to(tdt)
    assert np.array_equal(_bits(t), a.view(np.int16 if a.itemsize == 2 else np.int32))
    return a, t


def _bits(t):
    return (t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)).numpy()


def _run_body(body, a, *consts):
    out = np.empty_like(a)
    body(a, *consts, out)
    return out.view(np.int16 if out.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16", "i32"])
def test_p1_plain_is_the_pallas_body(jaxbw, dtype):
    a, t = _plane(dtype, 1)
    ref = _run_body(jaxbw._pure_copy_kernel, a)
    for br in PB.BRS:
        assert np.array_equal(_bits(PB.pure_copy_plane(t, br)), ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_p2_plain_is_the_pallas_body(jaxbw, dtype):
    """One f32 multiply by 1.0001, rounded to nearest even at the dtype
    (at bf16 and f16, 1e-4 is below half an ulp: the plane comes back)."""
    a, t = _plane(dtype, 2)
    ref = _run_body(jaxbw._copy_kernel, a)
    out = PB.copy_plane(t, PB.BRS[0])
    assert out.dtype == t.dtype and np.array_equal(_bits(out), ref)
    assert np.array_equal(ref, _bits(t)) == (dtype != "f32")


@pytest.mark.parametrize("n", PB.N_CONSTS)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_p3_plain_is_the_pallas_body(jaxbw, dtype, n):
    """o = x + 0 * sum c[0, 0]: the plane itself for finite constants (a
    negative zero becomes positive in both)."""
    a, t = _plane(dtype, 3)
    consts = np.random.RandomState(4).rand(n, 128, 128).astype(np.float32)
    ref = _run_body(jaxbw._copy_kernel_consts, a, *consts)
    out = PB.copy_plane_consts(t, PB.BRS[1], torch.from_numpy(consts))
    assert np.array_equal(_bits(out), ref)
    assert torch.equal(out, t)


# c_k[0, 0] of the edge constant stacks (the other elements NaN: the
# function reads c_k[0, 0] alone): a bump of -0, NaN from a NaN, from an
# inf, and from a left-to-right sum that overflows (3e38 + 3e38 = inf) where
# another order stays finite; and none, a bump of +0
EDGE_CONSTS = {"negative": [-1.5, -0.25, -3.0], "nan": [1.0, np.nan, 2.0],
               "inf": [1.0, np.inf], "overflow": [3e38, 3e38, -3e38], "none": []}
X_SPECIALS = [-0.0, 0.0, np.inf, -np.inf, np.nan]


@pytest.mark.parametrize("case", list(EDGE_CONSTS))
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_p3_plain_is_the_pallas_body_at_the_edges(jaxbw, dtype, case):
    """The Pallas body and the plain version on the edge constants, x with
    +-0, +-inf and NaN: bit for bit but NaN to NaN.  A negative sum keeps a
    -0 of x; with no constant the bump is +0 and a -0 comes out +0; a NaN,
    an inf or an overflowing sum makes every output NaN."""
    rng = np.random.RandomState(6)
    x = (rng.randn(*SHAPE) * 100).astype(np.float32)
    x.flat[:5] = X_SPECIALS
    x.flat[7::61] = np.resize(X_SPECIALS, x.flat[7::61].shape)
    tdt, ndt = DT[dtype]
    t = torch.from_numpy(x).to(tdt)
    a = x.astype(ndt)
    consts = np.full((len(EDGE_CONSTS[case]), 128, 128), np.nan, np.float32)
    consts[:, 0, 0] = EDGE_CONSTS[case]
    with np.errstate(over="ignore", invalid="ignore"):
        ref = np.empty_like(a)
        jaxbw._copy_kernel_consts(a, *consts, ref)
    out = PB.copy_plane_consts(t, PB.BRS[0], torch.from_numpy(consts))
    assert out.dtype == t.dtype
    nan = np.isnan(ref.astype(np.float32))
    assert np.array_equal(torch.isnan(out).numpy(), nan)
    rbits = ref.view(np.int16 if ref.itemsize == 2 else np.int32)
    assert np.array_equal(_bits(out)[~nan], rbits[~nan])
    if case in ("negative", "none"):
        neg0 = (x == 0) & np.signbit(x)
        assert neg0.any() and np.signbit(out.float().numpy()[neg0]).all() == (case == "negative")
        assert nan.sum() == np.isnan(x).sum()
    else:
        assert nan.all()


def test_sweep_is_the_scripts_sweep():
    """mul: P2 at f32, bf16, f16; pure: P1 at those and i32; consts: P3 at
    bf16 with 4 and 40 constant planes; each at br = 16 and 32
    (_probe_bw.py:78-116)."""
    assert PB.sweep("mul") == [("copy_plane", d, br, None)
                               for d in (torch.float32, torch.bfloat16, torch.float16)
                               for br in (16, 32)]
    assert [c[1] for c in PB.sweep("pure")][::2] == [torch.float32, torch.bfloat16,
                                                      torch.float16, torch.int32]
    assert PB.sweep("consts") == [("copy_plane_consts", torch.bfloat16, br, n)
                                  for n in (4, 40) for br in (16, 32)]
    assert PB.PLANE == (6144, 8192)
    with pytest.raises(ValueError):
        PB.sweep("add")


def test_timed_with_a_scaling_clock_and_without():
    """A clock that advances 1 ms per call gives 1 ms a call and gbytes /
    1e-3 GB/s, with the calls chained output into input; a clock that
    does not move with the work (a fixed step per reading) raises."""
    calls = []

    def fn(s):
        calls.append(s)
        return s + 1

    r = PB.timed(fn, torch.zeros(4), 2.0, clock=lambda: len(calls) * 1e-3)
    assert r["ms"] == pytest.approx(1.0) and r["gb_per_s"] == pytest.approx(2000.0)
    assert len(calls) == r["calls"] == 2 + 3 * (52 + 2)
    assert [float(s[0]) for s in calls[:4]] == [0.0, 1.0, 0.0, 1.0]
    steps = itertools.count()
    with pytest.raises(RuntimeError, match="scaled"):
        PB.timed(fn, torch.zeros(4), 2.0, clock=lambda: next(steps) * 1e-3)


def test_wrappers_check_their_inputs_and_count_nothing_on_the_cpu():
    _, t = _plane("bf16")
    _, i = _plane("i32")
    PB.reset_launches()
    with pytest.raises(TypeError):
        PB.copy_plane(i, 16)
    with pytest.raises(ValueError):
        PB.pure_copy_plane(t, 24)                 # 32 rows are not blocks of 24
    with pytest.raises(ValueError):
        PB.pure_copy_plane(t[0], 16)              # not a plane
    with pytest.raises(ValueError):
        PB.copy_plane_consts(t, 16, torch.ones(2, 64, 128))
    with pytest.raises(TypeError):
        PB.copy_plane_consts(t, 16, torch.ones(2, 128, 128, dtype=torch.float64))
    assert torch.equal(PB.pure_copy_plane(i, 16), i)
    assert torch.equal(PB.copy_plane_consts(t, 16, PB.const_planes(0, "cpu")), t)
    assert PB.launch_counts() == dict.fromkeys(PB.launch_counts(), 0)
    assert set(vars(PB.KERNELS)) == set(vars(PB.PLAIN)) == set(PB.launch_counts())
