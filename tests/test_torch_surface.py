"""The JAX package's public surface in the port, on the CPU.

The four compiled solver entries of the JAX package (``recon/admm.py``
``run_state_jit`` and ``run_jit``, ``recon/admm_split.py``
``run_rsplit_jit`` and ``run_split_jit``) exist in the port with the JAX
signatures and defaults, and are held to their JAX counterparts on the same
seeded inputs, ``n_iter`` given as an int and as a 0-d tensor.  Then every
public top-level name of each of the 47 modules that the two packages share
by path (the JAX module's own functions, classes and values, not what it
imports) exists in the port's module, under its own name or, for a few,
under another (RENAMED); and the JAX package's modules that the port does
not have by path are exactly the three that it has under another
(JAX_ONLY).

Tolerances: 1e-5 normalized for the exact and the fused half-spectrum
solver (``tests/test_torch_admm.py``'s TOL_SOLVER; the Pallas kernels in
interpret mode on the JAX side) and for the full-width solver
(``tests/test_torch_split.py``'s TOL_F32_LOOP).
"""

import importlib
import inspect
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2
from lenslesspicam_tpu.recon import admm as jadmm
from lenslesspicam_tpu.recon import admm_split as jsplit

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit

TOL_SOLVER = 1e-5
N_ITER = 10
SHAPE = (48, 64)


def _scene(seed):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*SHAPE).astype(np.float32)
    psf /= np.linalg.norm(psf)
    return psf, rng.rand(*SHAPE).astype(np.float32)


def _nerr(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-9)


def _n(kind, n):
    """``n`` iterations as the caller gives them: an int or a 0-d tensor."""
    return n if kind == "int" else torch.tensor(n)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode, at f32 storage."""
    pk2._set_interpret(True)
    for name in ("_IO_DTYPE", "_CARRY_DTYPE", "_CARRY_V_DTYPE"):
        monkeypatch.setattr(pk2, name, jnp.float32)
    try:
        yield
    finally:
        pk2._set_interpret(False)


ENTRIES = [("admm", "run_state_jit"), ("admm", "run_jit"),
           ("admm_split", "run_rsplit_jit"), ("admm_split", "run_split_jit")]


@pytest.mark.parametrize("module,name", ENTRIES)
def test_jit_entries_have_the_jax_signatures(module, name):
    """The same parameters in the same order, of the same kinds, with
    equal defaults (the ADMMParams default compares as its four floats)."""
    jp = inspect.signature(getattr(importlib.import_module(
        f"lenslesspicam_tpu.recon.{module}"), name)).parameters
    tp = inspect.signature(getattr(importlib.import_module(
        f"lenslesspicam_tpu_torch.recon.{module}"), name)).parameters
    assert list(tp) == list(jp)
    for p in jp:
        assert tp[p].kind == jp[p].kind, p
        assert (tp[p].default is inspect.Parameter.empty) == (
            jp[p].default is inspect.Parameter.empty), p
        if jp[p].default is not inspect.Parameter.empty:
            assert tp[p].default == jp[p].default, p


@pytest.mark.parametrize("kind", ["int", "tensor"])
def test_run_jit_matches_jax(kind):
    """The exact solver at 48 x 64, n = 10, default parameters."""
    psf, data = _scene(12)
    ref = jadmm.run_jit(jadmm.make_convolver(psf[None, :, :, None]),
                        data[None, None, :, :, None], n_iter=N_ITER)
    out = tadmm.run_jit(tadmm.make_convolver(psf[None, :, :, None], device="cpu"),
                        data[None, None, :, :, None], n_iter=_n(kind, N_ITER))
    assert out.shape == ref.shape
    assert _nerr(out, ref) <= TOL_SOLVER


@pytest.mark.parametrize("kind", ["int", "tensor"])
def test_run_state_jit_continues_from_a_state(kind):
    """Five JAX iterations, their state converted, five more in the port ==
    the JAX entry's five more from the same state (image and every state
    field); in the port, 5 + 5 from a fresh state == ``run_jit`` at 10,
    bit for bit."""
    psf, data = _scene(3)
    d5 = data[None, None, :, :, None]
    params = jadmm.ADMMParams()
    conv = jadmm.make_convolver(psf[None, :, :, None])
    _, st5 = jadmm.run_state_jit(conv, d5, params, jnp.asarray(5),
                                 jadmm.init_state(conv, 1, None, params))
    ref, st10 = jadmm.run_state_jit(conv, d5, params, jnp.asarray(5), st5)

    tconv = tadmm.make_convolver(psf[None, :, :, None], device="cpu")
    tparams = convert.admm_params(params)
    tstate = convert.admm_state({f: np.asarray(getattr(st5, f)) for f in st5._fields},
                                device="cpu")
    out, tst10 = tadmm.run_state_jit(tconv, d5, tparams, _n(kind, 5), tstate)
    assert _nerr(out, ref) <= TOL_SOLVER
    for f in st10._fields:
        assert _nerr(getattr(tst10, f), getattr(st10, f)) <= TOL_SOLVER, f

    _, own5 = tadmm.run_state_jit(tconv, d5, tparams, _n(kind, 5), None)
    own10, _ = tadmm.run_state_jit(tconv, d5, tparams, _n(kind, 5), own5)
    torch.testing.assert_close(own10, tadmm.run_jit(tconv, d5, tparams, N_ITER),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["int", "tensor"])
def test_run_rsplit_jit_matches_jax(interpret, kind):
    """The fused half-spectrum solver (the plain versions on the CPU)
    against JAX's entry with its Pallas kernels in interpret mode, at 48 x
    64, n = 10; with ``return_sat`` both report the JAX entry's saturation,
    0 at f32 storage."""
    psf, data = _scene(12)
    ref, jsat = jsplit.run_rsplit_jit(jsplit.precompute_rsplit(psf, data),
                                      jsplit.ADMMParams(), N_ITER, return_sat=True)
    pre = tsplit.precompute_rsplit(psf, data, device="cpu")
    out = tsplit.run_rsplit_jit(pre, tsplit.ADMMParams(), _n(kind, N_ITER))
    assert tuple(out.shape) == SHAPE
    assert _nerr(out, ref) <= TOL_SOLVER
    out_sat, sat = tsplit.run_rsplit_jit(pre, n_iter=_n(kind, N_ITER), return_sat=True)
    torch.testing.assert_close(out_sat, out, rtol=0, atol=0)
    assert sat == float(jsat) == 0.0


@pytest.mark.parametrize("kind", ["int", "tensor"])
@pytest.mark.parametrize("backend", ["jax", "fused"])
def test_run_split_jit_matches_jax(interpret, backend, kind):
    """The full-width solver at 48 x 64, n = 10: the default ``"jax"``
    backend, and the fused loop (plain versions) against JAX's fused one
    in interpret mode."""
    psf, data = _scene(12)
    ref = jsplit.run_split_jit(jsplit.precompute_split(psf, data), jsplit.ADMMParams(),
                               N_ITER, backend=backend)
    pre = tsplit.precompute_split(psf, data, device="cpu")
    out = tsplit.run_split_jit(pre, tsplit.ADMMParams(), _n(kind, N_ITER), backend=backend)
    assert out.dtype == torch.float32 and tuple(out.shape) == SHAPE
    assert _nerr(out, ref) <= TOL_SOLVER
    if backend == "jax":
        torch.testing.assert_close(tsplit.run_split_jit(pre, n_iter=N_ITER), out,
                                   rtol=0, atol=0)


# the modules of lenslesspicam_tpu that the port has at the same path
SHARED = ("data.datasets", "data.image", "data.io", "data.simulation", "eval.benchmark",
          "eval.lpips", "eval.metric", "eval.metrics", "eval.pnp", "hardware.aperture",
          "hardware.constants", "hardware.fabrication", "hardware.mask", "hardware.remote",
          "hardware.sensor", "hardware.slm",
          "hardware.trainable_mask", "models.background", "models.compensation",
          "models.inversion", "models.multi_wiener", "models.restormer",
          "models.trainable_recon", "models.unet", "models.unrolled", "ops.fft_conv",
          "ops.noise", "ops.padding", "ops.propagation", "ops.tv",
          "parallel.distributed", "parallel.sharding", "parallel.spatial", "recon.admm",
          "recon.admm_split",
          "recon.apgd", "recon.base", "recon.gd", "recon.mirflickr", "recon.tikhonov",
          "train.loggers", "train.steps", "train.trainer", "utils.config", "utils.plot",
          "utils.tracing", "zoo.model_dict")
# the modules of lenslesspicam_tpu that the port has under another path: the
# Pallas kernels are CUDA kernels behind ops/kernels.py and ops/split_fft.py,
# and the conversion of the reference's torch state dicts is the port's own
# loading of them under the modules' names (zoo/model_dict.py)
JAX_ONLY = {"ops.pallas_fft": "ops.split_fft", "ops.pallas_kernels2": "ops.kernels",
            "zoo.convert": "zoo.model_dict"}
# public names whose counterpart has another name in the port: the JAX
# package's audits of compiled HLO and its count of TPU matmul calls read, in
# the port, the counted collectives and the kernel launches
RENAMED = {"models.trainable_recon": {"ProcessorBlock": "processor_block"},
           "parallel.spatial": {"hlo_collective_bytes_per_iter": "collective_bytes_per_iter"},
           "parallel.distributed": {"hlo_dcn_psum_bytes": "allreduce_bytes"},
           "utils.tracing": {"fused_admm_matmuls_per_iter": "fused_admm_launches_per_iter"}}


def _public(mod):
    """The public top-level names that ``mod`` defines: no module, nothing
    whose ``__module__`` is another module's (imports, typing forms)."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", mod.__name__) == mod.__name__}


def _module_paths(pkg):
    """The non-package module paths of ``pkg``, dotted, under the package."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / pkg
    return {".".join(p.relative_to(root).with_suffix("").parts)
            for p in root.rglob("*.py") if p.name != "__init__.py"}


def test_shared_modules_are_every_module_of_both():
    """SHARED is every non-package module path that both packages have."""
    assert set(SHARED) == _module_paths("lenslesspicam_tpu") & _module_paths(
        "lenslesspicam_tpu_torch")
    assert len(SHARED) == 47 and set(RENAMED) <= set(SHARED)


def test_jax_only_modules_are_the_kernels_and_the_conversion():
    """Every module path of the JAX package that the port lacks is a key of
    JAX_ONLY, and each one's counterpart is a module of the port: a JAX
    module that the port neither has nor maps fails here by name."""
    jax_only = _module_paths("lenslesspicam_tpu") - _module_paths("lenslesspicam_tpu_torch")
    assert sorted(jax_only) == sorted(JAX_ONLY)
    for counterpart in JAX_ONLY.values():
        importlib.import_module(f"lenslesspicam_tpu_torch.{counterpart}")


@pytest.mark.parametrize("path", SHARED)
def test_port_module_has_every_public_jax_name(path):
    """Each public name of the JAX module is in the port's, under its own
    name or its RENAMED one; each renamed name is still a public JAX name
    the port lacks (a stale entry fails)."""
    jmod = importlib.import_module(f"lenslesspicam_tpu.{path}")
    tmod = importlib.import_module(f"lenslesspicam_tpu_torch.{path}")
    public = _public(jmod)
    renamed = RENAMED.get(path, {})
    for name in renamed:
        assert name in public and not hasattr(tmod, name), name
    missing = sorted(n for n in public if not hasattr(tmod, renamed.get(n, n)))
    assert missing == []


# --- signatures ----------------------------------------------------------------------
#
# Every public function, class and method that both packages have takes the
# JAX parameter names, in the same order, of the same kinds, with the same
# defaults.  The differences allowed everywhere: flax's ``parent`` / ``name``
# (a flax module's dataclass fields), ``key`` -> ``generator`` (a jax.random
# key -> a torch.Generator), an added ``device=`` and ``jnp.float32`` ->
# ``torch.float32`` as a default; the RENAMED names are other functions and
# are not compared.  The port's other differences are listed by name below;
# each entry must still be a difference (a stale one fails).

# parameters the port adds: the storage modes that the JAX package sets as
# module globals (pk2._IO_DTYPE, ...), the kernels' ops table, torch layers'
# input widths (flax infers them on the first call), the process group of a
# collective (JAX's run inside shard_map over a named axis), and a few options
PORT_ONLY = {
    "eval.metric.lpips": ("net",),
    "hardware.trainable_mask.TrainableMask.make_optimizer": ("params",),
    "models.background.IntegratedBackgroundSub": ("in_nc",),
    "models.multi_wiener.DoubleConv": ("in_ch",),
    "models.multi_wiener.Down": ("in_ch",),
    "models.multi_wiener.Up": ("in_ch",),
    "models.restormer.LayerNorm2d": ("dim",),
    "models.restormer.Restormer": ("in_channels",),
    "models.unet.UNet": ("in_nc",),
    "models.unet.UNetRes": ("in_nc",),
    "ops.propagation.spherical_wavefront": ("dtype",),
    "parallel.spatial.filtered_synthesis_sharded": ("group",),
    "parallel.spatial.finite_diff_adj_sharded": ("group",),
    "parallel.spatial.finite_diff_sharded": ("group",),
    "parallel.spatial.roll_down_sharded": ("group",),
    "parallel.spatial.roll_up_sharded": ("group",),
    "recon.admm.run_state": ("initial_est",),
    "recon.admm_split.run_rsplit_general": ("placement", "io", "carry_tv", "carry_v",
                                            "sat_every"),
    "recon.admm_split.run_split": ("io", "carry_tv", "carry_v"),
    "recon.admm_split.run_split_fused": ("ops", "io", "carry_tv", "carry_v"),
    "recon.admm_split.run_split_general": ("io", "carry_tv", "carry_v"),
    "recon.admm_split.run_split_rfused": ("ops", "io", "carry_tv", "carry_v", "sat_every",
                                          "placement"),
    "train.trainer.make_optimizer": ("module",),
}
# JAX parameters that carry a flax module's variables: the torch module holds them
JAX_ONLY_PARAMS = {"models.restormer.restormer_fn": ("variables",),
                   "models.unet.drunet_denoise": ("params",)}
# the port's own parameter lists: LPIPS weights drawn from a seed (flax's init
# traces an image shape), saved from a state dict, and the roofline against
# the H100's data sheet (the JAX one reads a TPU's HBM rate and matmul issue)
CHANGED = {"eval.lpips.random_params": ("seed", "net"),
           "eval.lpips.save_params_npz": ("state_dict", "path"),
           "utils.tracing.roofline_report": ("shape", "iters_per_s", "channels", "hbm_bw",
                                             "half_spectrum", "flop_rate")}


def _shared_callables(path):
    """(qualified name, JAX object, port object, flax module?) for every
    public function and class of the module and each public method of its
    classes that the JAX class defines (a flax module's dataclass fields
    are parameters, not methods)."""
    import dataclasses

    import flax.linen as nn

    jmod = importlib.import_module(f"lenslesspicam_tpu.{path}")
    tmod = importlib.import_module(f"lenslesspicam_tpu_torch.{path}")
    out = []
    for name in sorted(_public(jmod) - set(RENAMED.get(path, {}))):
        jv, tv = getattr(jmod, name), getattr(tmod, name)
        if inspect.isclass(jv):
            flax_mod = issubclass(jv, nn.Module)
            out.append((f"{path}.{name}", jv, tv, flax_mod))
            fields = {f.name for f in dataclasses.fields(jv)} if dataclasses.is_dataclass(jv) \
                else set()
            for m, mv in vars(jv).items():
                if m.startswith("_") or m in fields or isinstance(mv, property):
                    continue
                if callable(mv) or isinstance(mv, (staticmethod, classmethod)):
                    out.append((f"{path}.{name}.{m}", getattr(jv, m), getattr(tv, m), False))
        elif callable(jv):
            out.append((f"{path}.{name}", jv, tv, False))
    return out


def _same_default(jd, td):
    """A JAX default and the port's are the same value: jnp.float32 is
    torch.float32, and two callables are the same function by name or by
    their values on a small array."""
    if jd is inspect.Parameter.empty or td is inspect.Parameter.empty:
        return jd is td
    if jd is jnp.float32:
        return td is torch.float32
    if callable(jd) and callable(td) and not inspect.isclass(jd):
        if getattr(jd, "__name__", None) == getattr(td, "__name__", None) != "<lambda>":
            return True
        x = np.array([-1.5, 0.0, 2.0], np.float32)
        try:
            return np.array_equal(np.asarray(jd(x)), td(torch.from_numpy(x)).numpy())
        except Exception:
            return False
    return type(jd).__name__ == type(td).__name__ and repr(jd) == repr(td)


def _signature(qual, fn, side, flax_mod=False, jax_names=()):
    """The normalized (name, kind, default) list of ``fn``'s parameters;
    the port's ``device`` is dropped where the JAX function has none."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except ValueError:      # a builtin's constructor (a dict subclass): no signature
        return None
    if side == "jax":
        drop = set(JAX_ONLY_PARAMS.get(qual, ())) | ({"parent", "name"} if flax_mod else set())
        return [("generator" if p.name == "key" else p.name, p.kind, p.default)
                for p in params if p.name not in drop]
    drop = set(PORT_ONLY.get(qual, ())) | ({"device"} - set(jax_names))
    return [(p.name, p.kind, p.default) for p in params if p.name not in drop]


def _same_signature(js, ts):
    if js is None or ts is None:
        return js is ts
    return len(js) == len(ts) and all(
        jn == tn and jk == tk and _same_default(jd, td)
        for (jn, jk, jd), (tn, tk, td) in zip(js, ts))


def test_signature_exceptions_name_shared_callables():
    """Every entry of PORT_ONLY and JAX_ONLY_PARAMS names a shared callable
    and parameters that its side has and the other lacks; every CHANGED
    entry names a shared callable."""
    found = {q: (j, t) for path in SHARED for q, j, t, _ in _shared_callables(path)}
    for table, side in ((PORT_ONLY, 1), (JAX_ONLY_PARAMS, 0)):
        for qual, names in table.items():
            assert qual in found, qual
            have = inspect.signature(found[qual][side]).parameters
            other = inspect.signature(found[qual][1 - side]).parameters
            assert set(names) <= set(have) and not set(names) & set(other), (qual, names)
    assert set(CHANGED) <= set(found)


@pytest.mark.parametrize("path", SHARED)
def test_port_signatures_are_the_jax_signatures(path):
    """Each public function, class and method of the JAX module that the
    port shares takes, in the port, the JAX parameters in the same order,
    of the same kinds, with the same defaults, but for the differences
    allowed above; a CHANGED entry takes its listed parameters, and still
    differs from JAX's."""
    wrong = []
    for qual, jv, tv, flax_mod in _shared_callables(path):
        js = _signature(qual, jv, "jax", flax_mod)
        ts = _signature(qual, tv, "port", jax_names=[n for n, _, _ in js or ()])
        if qual in CHANGED:
            assert tuple(n for n, _, _ in ts) == CHANGED[qual], qual
            assert not _same_signature(js, ts), f"{qual} is no longer CHANGED"
        elif not _same_signature(js, ts):
            wrong.append((qual, [(n, d) for n, _, d in js], [(n, d) for n, _, d in ts]))
    assert wrong == []


# --- chip_smoke.py's bandwidth readings -------------------------------------------------

def _pair_clock(ms_per_call):
    """A stand-in clock for ``probe_bw.timed`` with one pair a call: each
    pair reads (t0, t1, t2) so that its (52 - 2)-call difference is the
    given time per call."""
    times = []
    for d in ms_per_call:
        times += [0.0, 52 * d * 1e-3, 54 * d * 1e-3]
    return iter(times).__next__


@pytest.mark.parametrize("ms,median_ms,raises", [
    ([1.0, 1.1, 0.9, 1.05, 0.95], 1.0, False),
    ([1.0, 0.01, 0.9, 1.05, 0.95], 0.95, False),     # one descheduled base loop
    ([1.0, 0.01, 0.02, 1.05, 0.95], 0.95, True),     # two pairs over the gate
    ([0.01, 0.02, 0.03, 1.05, 0.95], 0.03, True),    # the median over the gate
])
def test_bandwidth_reading_is_the_median_of_its_pairs(ms, median_ms, raises):
    """``chip_smoke.bw_reading`` takes the median of BW_PAIRS pairs of
    ``probe_bw.timed`` (a stand-in clock in place of the card's), keeps
    every pair's rate, and ``bw_gate`` raises on a median above
    MAX_BYTES_PER_S or on two pairs above it, not on one."""
    import chip_smoke as cs

    gbytes = 2.0     # 2 GB a call: 1 ms is 2000 GB/s, 0.03 ms over the 3517.5 GB/s gate
    rd = cs.bw_reading(lambda s: s, torch.zeros(4), gbytes, clock=_pair_clock(ms))
    assert cs.BW_PAIRS == len(ms) == len(rd["pair_gb_per_s"])
    assert rd["ms"] == pytest.approx(median_ms) and rd["calls"] == 5 * (2 + 52 + 2)
    assert rd["gb_per_s"] == pytest.approx(gbytes / (median_ms * 1e-3))
    assert rd["pair_gb_per_s"] == pytest.approx([gbytes / (d * 1e-3) for d in ms])
    if raises:
        with pytest.raises(AssertionError, match="clock does not scale"):
            cs.bw_gate("probe", rd["pair_gb_per_s"])
    else:
        cs.bw_gate("probe", rd["pair_gb_per_s"])


@pytest.mark.parametrize("ms,median_ms,dropped", [
    ([1.0, 0.0, 0.9, 1.05, 0.95], 0.975, 1),         # one pair's loops took the same time
    ([1.0, 0.0, -0.5, 1.05, 0.95], None, 2),        # two pairs did not scale
])
def test_bandwidth_reading_drops_a_pair_that_does_not_scale(ms, median_ms, dropped):
    """A pair whose full loop was not longer than its base loop is no
    reading: ``chip_smoke.bw_reading`` drops it and counts it, takes the
    median of the others and every call made, and raises when more than
    one of its BW_PAIRS pairs does not scale (a stand-in clock in place of
    the card's)."""
    import chip_smoke as cs

    gbytes = 2.0
    if median_ms is None:
        with pytest.raises(AssertionError, match="clock does not scale"):
            cs.bw_reading(lambda s: s, torch.zeros(4), gbytes, clock=_pair_clock(ms))
        return
    rd = cs.bw_reading(lambda s: s, torch.zeros(4), gbytes, clock=_pair_clock(ms))
    assert rd["pairs_dropped"] == dropped and rd["calls"] == 5 * (2 + 52 + 2)
    assert rd["ms"] == pytest.approx(median_ms)
    assert rd["pair_gb_per_s"] == pytest.approx([gbytes / (d * 1e-3) for d in ms if d > 0])
    cs.bw_gate("probe", rd["pair_gb_per_s"])
