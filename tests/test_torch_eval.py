"""The port's evaluation layer and its host utilities against the JAX
package on the CPU: SSIM and ``compute_metrics``, the plot helpers, the
image resize and gray conversion, the virtual sensor, the numpy metric API
and ``extract``, Parameterize-and-Perturb, the benchmark harness and LPIPS
(weights carried over by ``convert.lpips_state_dict``, the .npz fixture
files and torch checkpoints).

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances are max |port - JAX| / max |JAX| unless said otherwise:

- SSIM, ``compute_metrics``, the resizes, LPIPS: 1e-5;
- ``extract``'s rotation: 1e-4 in the interior (OpenCV's warp in the JAX
  package, bilinear in float64 in the port);
- ``parameterize_perturb`` (10 SGD steps) and ``benchmark``: 1e-4;
- ``VirtualSensor.capture``: one quantization level, at most 1 % of the
  pixels differing (the last step truncates to integers, so a 1e-7 change
  can flip a level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lenslesspicam_tpu.data import image as jimage
from lenslesspicam_tpu.eval import benchmark as jbench
from lenslesspicam_tpu.eval import lpips as jlpips
from lenslesspicam_tpu.eval import metric as jmetric
from lenslesspicam_tpu.eval import metrics as jmetrics
from lenslesspicam_tpu.eval import pnp as jpnp
from lenslesspicam_tpu.hardware import sensor as jsensor
from lenslesspicam_tpu.ops.fft_conv import FFTConvolver as JConv
from lenslesspicam_tpu.recon.base import ADMM as JADMM

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.data import image as timage
from lenslesspicam_tpu_torch.eval import benchmark as tbench
from lenslesspicam_tpu_torch.eval import lpips as tlpips
from lenslesspicam_tpu_torch.eval import metric as tmetric
from lenslesspicam_tpu_torch.eval import metrics as tmetrics
from lenslesspicam_tpu_torch.eval import pnp as tpnp
from lenslesspicam_tpu_torch.hardware import sensor as tsensor
from lenslesspicam_tpu_torch.ops.fft_conv import FFTConvolver as TConv
from lenslesspicam_tpu_torch.recon.base import ADMM as TADMM
from lenslesspicam_tpu_torch.utils import plot as tplot

from test_torch_scripts import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = "cpu"
TOL_EXACT = 1e-5
TOL_ROTATE = 1e-4
TOL_SOLVER = 1e-4


def _rel(out, ref):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_tf32():
    """f32 parity: no TF32 in the convolutions (a no-op on the CPU)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


# --- module 3: SSIM and compute_metrics ---------------------------------------

@pytest.mark.parametrize("shape", [(2, 24, 30, 3), (1, 33, 27, 1), (3, 2, 16, 16, 2)])
def test_ssim_matches_jax(shape):
    a, b = _rand(*shape, seed=1), _rand(*shape, seed=2)
    b = 0.7 * a + 0.3 * b
    out = tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == shape[:-3]
    assert _rel(out, jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))) <= TOL_EXACT
    kw = dict(data_range=2.0, kernel_size=7, sigma=1.0)
    assert _rel(tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b), **kw),
                jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), **kw)) <= TOL_EXACT


@pytest.mark.parametrize("shape", [(2, 1, 24, 30, 3), (2, 3, 24, 30, 1), (2, 24, 30, 3)])
@pytest.mark.parametrize("normalize", [True, False])
def test_compute_metrics_matches_jax(shape, normalize):
    a, b = _rand(*shape, seed=3) * 2.0, _rand(*shape, seed=4)
    out = tmetrics.compute_metrics(torch.from_numpy(a), torch.from_numpy(b), normalize)
    ref = jmetrics.compute_metrics(jnp.asarray(a), jnp.asarray(b), normalize)
    assert list(out) == list(ref)
    for k in ref:
        assert _rel(out[k], ref[k]) <= TOL_EXACT, k


# --- module 6: plot ----------------------------------------------------------------

def test_plot_helpers():
    x = _rand(20, 30, seed=5)
    assert _rel(tplot.gamma_correction(x, 2.2), jimage.gamma_correction(x, 2.2)) == 0
    import matplotlib

    matplotlib.use("Agg")
    for img in (torch.from_numpy(_rand(2, 12, 16, 3)), _rand(1, 12, 16, 1), _rand(12, 16, 3)):
        ax = tplot.plot_image(img, gamma=2.2)
        assert ax.get_images()[0].get_array().shape[:2] == (12, 16 * (2 if len(img) == 2 else 1))
        matplotlib.pyplot.close(ax.figure)


# --- module 11: image utilities ----------------------------------------------------

@pytest.mark.parametrize("shape,new", [((1, 30, 40, 3), (17, 23)), ((2, 30, 40, 1), (64, 90)),
                                       ((1, 7, 9, 2), (20, 5)), ((1, 30, 40, 3), (30, 13))])
def test_resize_matches_jax(shape, new):
    img = _rand(*shape, seed=6) * 3.0 - 1.0
    target = (shape[0],) + new + (shape[-1],)
    out = timage.resize(img, shape=target)
    assert out.dtype == img.dtype
    assert _rel(out, jimage.resize(img, shape=target)) <= TOL_EXACT
    assert _rel(timage.resize(img, factor=2), jimage.resize(img, factor=2)) <= TOL_EXACT
    assert timage.resize(img, shape=shape) is img


def test_rgb2gray_matches_jax():
    rgb = _rand(2, 10, 12, 3, seed=7)
    for keep in (True, False):
        assert _rel(timage.rgb2gray(rgb, keepchanneldim=keep),
                    jimage.rgb2gray(rgb, keepchanneldim=keep)) == 0
    w = [0.2, 0.3, 0.5]
    assert _rel(timage.rgb2gray(rgb, w), jimage.rgb2gray(rgb, w)) == 0


# --- module 12: the virtual sensor ----------------------------------------------------

@pytest.mark.parametrize("name,downsample,scene_shape,bit_depth", [
    ("rpi_hq", 40, (150, 130, 3), None), ("basler_287", 6, (50, 90, 3), 12),
    ("rpi_gs", 16, (30, 40), 10), ("rpi_v2", 32, (200, 300, 3), None)])
def test_sensor_capture_matches_jax(name, downsample, scene_shape, bit_depth):
    t = tsensor.VirtualSensor.from_name(name, downsample=downsample)
    j = jsensor.VirtualSensor.from_name(name, downsample=downsample)
    for attr in ("resolution", "pixel_size", "pitch", "size", "image_shape"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr))
    scene = _rand(*scene_shape, seed=8)
    out, ref = t.capture(scene, bit_depth=bit_depth), j.capture(scene, bit_depth=bit_depth)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    d = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and (d != 0).mean() <= 0.01
    np.random.seed(9)
    a = t.capture()
    np.random.seed(9)
    assert np.array_equal(a, j.capture())


def test_sensor_surface():
    assert tsensor.SensorOptions.values() == jsensor.SensorOptions.values()
    assert set(tsensor.sensor_dict) == set(jsensor.sensor_dict)
    with pytest.raises(FileNotFoundError, match="scene.png"):
        tsensor.VirtualSensor.from_name("rpi_hq", downsample=40).capture("scene.png")
    with pytest.raises(ValueError):
        tsensor.VirtualSensor.from_name("rpi_hq").downsample(1)
    with pytest.raises(ValueError, match="not supported"):
        tsensor.VirtualSensor.from_name("nope")


# --- module 14: the numpy metric API ------------------------------------------------

def test_metric_api_matches_jax():
    true, est = _rand(24, 30, 3, seed=10), _rand(24, 30, 3, seed=11) * 3.0
    for fn in ("mse", "psnr"):
        for normalize in (True, False):
            assert abs(getattr(tmetric, fn)(true, est, normalize)
                       - getattr(jmetric, fn)(true, est, normalize)) <= \
                TOL_EXACT * abs(getattr(jmetric, fn)(true, est, normalize))
    for t, e in ((true, est), (true[..., 0], est[..., 0])):
        assert abs(tmetric.ssim(t, e, device=CPU) - jmetric.ssim(t, e)) <= TOL_EXACT
    with pytest.raises(RuntimeError, match="weights"):
        tmetric.lpips(true, est, device=CPU)


@pytest.mark.parametrize("rotation", [0, 7.5, -30.0])
def test_extract_matches_jax(rotation):
    est = _rand(60, 80, 3, seed=12)
    original = _rand(45, 50, 3, seed=13)
    out, orig = tmetric.extract(est, original, (10, 50), (15, 70), rotation=rotation)
    ref, ref_orig = jmetric.extract(est, original, (10, 50), (15, 70), rotation=rotation)
    assert out.shape == ref.shape == (40, 55, 3)
    assert np.abs(out[2:-2, 2:-2] - ref[2:-2, 2:-2]).max() <= TOL_ROTATE
    assert _rel(orig, ref_orig) <= TOL_EXACT


# --- module 15: Parameterize-and-Perturb ----------------------------------------------

def test_parameterize_perturb_matches_jax():
    """A per-channel gain and bias model written in both frameworks, 10
    SGD steps from the same parameters."""
    rng = np.random.RandomState(14)
    psf = rng.rand(1, 24, 32, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    lensless = rng.rand(1, 1, 24, 32, 3).astype(np.float32)
    params0 = {"gain": rng.rand(3).astype(np.float32) + 0.5,
               "bias": rng.rand(3).astype(np.float32) * 0.1}
    jfwd = JConv.from_psf(psf, pad=True, norm="backward")
    tfwd = TConv.from_psf(psf, pad=True, norm="backward", device=CPU)

    def apply_fn(p, d):
        return p["gain"] * d + p["bias"]

    kw = dict(mu=1e-2, lr=0.5, n_iter=10)
    jpred, jparams = jpnp.parameterize_perturb(
        apply_fn, {k: jnp.asarray(v) for k, v in params0.items()}, jfwd,
        jnp.asarray(lensless), **kw)
    tpred, tparams = tpnp.parameterize_perturb(
        apply_fn, {k: torch.from_numpy(v) for k, v in params0.items()}, tfwd,
        torch.from_numpy(lensless), **kw)
    assert _rel(tpred, jpred) <= TOL_SOLVER
    for k in params0:
        assert _rel(tparams[k], jparams[k]) <= TOL_SOLVER
        assert np.abs(np.asarray(jparams[k]) - params0[k]).max() > 1e-3   # the steps move


# --- module 16: benchmark ---------------------------------------------------------------

def test_benchmark_matches_jax():
    rng = np.random.RandomState(15)
    psf = rng.rand(1, 24, 32, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    batches = [{"lensless": rng.rand(2, 1, 24, 32, 3).astype(np.float32),
                "lensed": rng.rand(2, 1, 24, 32, 3).astype(np.float32)}]
    jm, tm = JADMM(psf, n_iter=5), TADMM(psf, n_iter=5, device=CPU)

    def jrec(x):
        pred = jm.batch_apply(x)
        return pred, 0.9 * pred, x, None

    def trec(x):
        pred = tm.batch_apply(x)
        return pred, 0.9 * pred, x, None

    crop = {"vertical": (2, 22), "horizontal": (3, 30)}
    extra = {"mean_pred": lambda p, y, t: p.mean(axis=tuple(range(1, p.ndim)))
             if isinstance(p, jax.Array) else p.mean(dim=tuple(range(1, p.ndim)))}
    ref = jbench.benchmark(jrec, batches, crop=crop, model=jm, unrolled_output_factor=True,
                           pre_process_aux=True, extra_metrics=extra)
    out = tbench.benchmark(trec, batches, crop=crop, model=tm, unrolled_output_factor=True,
                           pre_process_aux=True, extra_metrics=extra, device=CPU)
    assert list(out) == list(ref)
    for k in ref:
        assert abs(out[k] - ref[k]) <= TOL_SOLVER * abs(ref[k]), (k, out[k], ref[k])


def test_benchmark_noise_lpips_and_refusals(tmp_path, monkeypatch):
    rng = np.random.RandomState(16)
    batches = [{"lensless": rng.rand(2, 1, 32, 32, 1).astype(np.float32),
                "lensed": rng.rand(2, 1, 32, 32, 1).astype(np.float32)}]
    path = tlpips.make_standin_weights(str(tmp_path / "vgg.npz"))
    monkeypatch.setenv("LPT_LPIPS_WEIGHTS", path)
    monkeypatch.delenv("LPT_LPIPS_ALEX_WEIGHTS", raising=False)
    seen = []

    def rec(x):
        seen.append(x)
        return x

    res = tbench.benchmark(rec, batches, snr=10.0, device=CPU,
                           generator=torch.Generator().manual_seed(0))
    assert set(res) == {"MSE", "PSNR", "SSIM", "LPIPS_Vgg"}
    assert not torch.equal(seen[0], torch.from_numpy(batches[0]["lensless"]))
    again = tbench.benchmark(rec, batches, snr=10.0, device=CPU,
                             generator=torch.Generator().manual_seed(0))
    assert again == res
    with pytest.raises(ValueError, match="'data' dim"):
        tbench.benchmark(rec, batches, mesh=object(), device=CPU)
    (tmp_path / "saved").mkdir()
    saved = tbench.benchmark(rec, batches, save_idx=[0], save_dir=str(tmp_path / "saved"),
                             device=CPU)
    assert saved == tbench.benchmark(rec, batches, device=CPU)
    assert [p.name for p in (tmp_path / "saved").iterdir()] == ["recon_0.png"]
    with pytest.raises(ValueError, match="pnp requires"):
        tbench.benchmark(rec, batches, pnp={"mu": 1.0}, device=CPU)


# --- module 17: LPIPS ----------------------------------------------------------------------

_JAX_LPIPS = {}


def _jax_lpips(net):
    """The JAX package's random_params(PRNGKey(0)) and a jitted apply, built
    once per net (its eager init takes seconds)."""
    if net not in _JAX_LPIPS:
        variables = jax.jit(lambda k: jlpips.random_params(k, net=net))(jax.random.PRNGKey(0))
        _JAX_LPIPS[net] = (jax.tree_util.tree_map(np.asarray, variables),
                           jax.jit(jlpips.LPIPS(net=net).apply))
    return _JAX_LPIPS[net]


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_through_convert_matches_jax(net):
    variables, apply = _jax_lpips(net)
    a, b = _rand(2, 64, 64, 3, seed=17), _rand(2, 64, 64, 3, seed=18)
    ref = apply(variables, a, b)
    sd = convert.lpips_state_dict(variables)
    model = tlpips.model_from_state_dict(sd, net, CPU)
    out = model(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (2,) and _rel(out, ref) <= TOL_EXACT
    assert float(model(torch.from_numpy(a), torch.from_numpy(a)).max()) < 1e-5
    # the metric API: both images divided by their max first, as
    # eval/metric.py's lpips does in the JAX package
    val = tmetric.lpips(b[0], 2.0 * a[0], lpips_variables=sd, net=net, device=CPU)
    ref = apply(variables, a[:1] / a[0].max(), b[:1] / b[0].max())
    assert abs(val - float(ref[0])) <= TOL_EXACT * float(ref[0])


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_fixture_files_serve_both_packages(tmp_path, net):
    """A .npz fixture written by either package loads in the other and
    gives the same distances; the port's random_params is seeded and has
    the JAX package's tree."""
    variables, apply = _jax_lpips(net)
    a, b = _rand(1, 64, 64, 3, seed=19), _rand(1, 64, 64, 3, seed=20)
    sd = tlpips.random_params(3, net)
    again = tlpips.random_params(3, net)
    assert all(torch.equal(v, again[k]) for k, v in sd.items())
    tpath = tlpips.make_standin_weights(str(tmp_path / "port.npz"), net, seed=3)
    jvars = jlpips.load_params_npz(tpath)
    assert jax.tree_util.tree_structure(jvars) == jax.tree_util.tree_structure(variables)
    assert _rel(tlpips.model_from_state_dict(sd, net, CPU)(torch.from_numpy(a),
                                                          torch.from_numpy(b)),
                apply(jvars, a, b)) <= TOL_EXACT
    jpath = str(tmp_path / "jax.npz")
    jlpips.save_params_npz(variables, jpath)
    fn = tlpips.metric_from_weights(jpath, net, CPU)
    gray = [np.repeat(x[..., :1], 3, axis=-1) for x in (a, b)]     # as the metric repeats
    assert _rel(fn(torch.from_numpy(a[..., :1]), torch.from_numpy(b[..., :1])),
                apply(variables, *gray)) <= TOL_EXACT


def test_lpips_torch_checkpoint_matches_jax(tmp_path, monkeypatch):
    """A checkpoint in the lpips package's key layout (torchvision
    ``features.N`` trunk, ``lin<i>.model.1.weight`` heads) loads in both."""
    rng = np.random.RandomState(21)
    sd = {}
    for name, cin, cout, k, *_ in tlpips.conv_plan("vgg"):
        idx = tlpips.torchvision_feature_index("vgg")[name]
        sd[f"net.features.{idx}.weight"] = torch.tensor(
            rng.randn(cout, cin, k, k).astype(np.float32) * 0.1)
        sd[f"net.features.{idx}.bias"] = torch.tensor(rng.randn(cout).astype(np.float32) * 0.1)
    for i, (ch, _) in enumerate(tlpips._VGG_STAGES):
        sd[f"lin{i}.model.1.weight"] = torch.tensor(
            np.abs(rng.randn(1, ch, 1, 1)).astype(np.float32) * 0.05)
    path = str(tmp_path / "lpips_vgg.pt")
    torch.save(sd, path)
    a, b = _rand(1, 64, 64, 3, seed=22), _rand(1, 64, 64, 3, seed=23)
    ref = _jax_lpips("vgg")[1](jlpips.load_torch_lpips(path), a, b)
    monkeypatch.setenv("LPT_LPIPS_WEIGHTS", path)
    monkeypatch.setenv("LPT_LPIPS_ALEX_WEIGHTS", "")
    vgg_fn, alex_fn = tlpips.metrics_from_env(CPU)
    assert alex_fn is None
    assert _rel(vgg_fn(torch.from_numpy(a), torch.from_numpy(b)), ref) <= TOL_EXACT
    with pytest.raises(KeyError, match="features"):
        tlpips.load_torch_lpips(path, net="alex")
