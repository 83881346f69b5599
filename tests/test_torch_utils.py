"""The port's ``utils`` (config, tracing, plot) against the JAX package's.

- ``utils.config``: the port's copy gives the JAX module's results on the
  same YAML files, overrides and defaults, and ``config_main``'s run
  folder and snapshot;
- ``utils.tracing``: the byte models equal the JAX package's (also under
  its storage knobs); ``roofline_report`` on the same inputs equals JAX's
  bytes, and its bandwidth term JAX's at the same rate, apart from its
  documented H100 defaults; its operation count is the sum of
  ``chip_smoke.py``'s per-kernel counts, and its launches per iteration
  ``chip_smoke.py``'s launch counts; ``trace`` writes a Chrome trace and
  ``time_fn`` times; every call of ``trace`` in the port and its tools
  names its ``log_dir`` (the default, JAX's ``/tmp/lpt_trace``, is shared
  by every process of the host);
- ``utils.plot`` under Agg: the histograms, cross sections,
  autocorrelations and training curves of the JAX functions.
"""

import json
import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lenslesspicam_tpu.utils import config as jconfig  # noqa: E402
from lenslesspicam_tpu.utils import plot as jplot  # noqa: E402
from lenslesspicam_tpu.utils import tracing as jtracing  # noqa: E402
from lenslesspicam_tpu_torch.utils import config as tconfig  # noqa: E402
from lenslesspicam_tpu_torch.utils import plot as tplot  # noqa: E402
from lenslesspicam_tpu_torch.utils import tracing as ttracing  # noqa: E402

YAML = """\
input:
  psf: psf.png
  data: raw.png
admm:
  n_iter: 5
  mu: [1.0e-6, 1.0e-5]
preprocess:
  downsample: 4
  flip: false
"""
OVERRIDES = ["admm.n_iter=20", "preprocess.flip=true", "new.key.deep=[1, 2]", "name=x"]


def _defaults():    # fresh: load_config merges the YAML into the nested dicts it is given
    return {"admm": {"n_iter": 100, "tau": 1e-4}, "output_dir": "out", "camera": {"gain": 1}}


# --- utils.config ------------------------------------------------------------------------


def test_config_loads_like_jax(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(YAML)
    for mod in (jconfig, tconfig):
        assert mod.parse_overrides(OVERRIDES) == jconfig.parse_overrides(OVERRIDES)
    ref = jconfig.load_config(str(path), jconfig.parse_overrides(OVERRIDES), _defaults())
    out = tconfig.load_config(str(path), tconfig.parse_overrides(OVERRIDES), _defaults())
    assert out == ref and out.admm.n_iter == 20 and out.get_path("new.key.deep") == [1, 2]
    assert out.get_path("admm.missing", 7) == ref.get_path("admm.missing", 7) == 7
    with pytest.raises(AttributeError):
        out.nothing
    with pytest.raises(ValueError):
        tconfig.parse_overrides(["no_equals"])


def test_apply_defaults_like_jax():
    def cfg(mod):
        c = mod.DotDict({"camera": None, "admm": {"n_iter": 3}})
        return mod.apply_defaults(c, _defaults())

    assert cfg(tconfig) == cfg(jconfig)
    assert cfg(tconfig)["admm"] == {"n_iter": 3, "tau": 1e-4}


def test_config_main_run_dir_and_snapshot(tmp_path):
    (tmp_path / "base.yaml").write_text(YAML)
    (tmp_path / "other.yaml").write_text("a: 1\n")
    seen = {}
    for name, mod in (("jax", jconfig), ("torch", tconfig)):
        out_dir = str(tmp_path / f"runs_{name}")

        @mod.config_main(str(tmp_path / "base.yaml"))
        def main(cfg):
            return cfg

        cfg = main(["-cn", "other", f"output_dir={out_dir}", "b=2"])
        with open(os.path.join(cfg.run_dir, "config.yaml")) as f:
            snap = f.read()
        seen[name] = ({k: v for k, v in cfg.items() if k not in ("run_dir", "output_dir")},
                      snap.replace(out_dir, "OUT"),
                      os.path.relpath(cfg.run_dir, out_dir).count(os.sep))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == {"a": 1, "b": 2}


# --- utils.tracing -----------------------------------------------------------------------

GRIDS = ((1, 6144, 8192), (3, 768, 1024), (1, 96, 128))
KNOBS = [{}, {"LPT_RFUSED_V3": "0"}, {"LPT_CARRY_IO": "bf16"},
         {"LPT_CARRY_TV": "i16", "LPT_CARRY_V": "bf16"}]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(k) or "default")
def test_byte_models_equal_jax(monkeypatch, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    for shape in GRIDS:
        for ch in (1, 3):
            assert ttracing.admm_bytes_per_iter(shape, ch) == \
                jtracing.admm_bytes_per_iter(shape, ch)
            for io in (2, 4):
                for half in (True, False):
                    assert ttracing.fused_admm_bytes_per_iter(shape, io, half, ch) == \
                        jtracing.fused_admm_bytes_per_iter(shape, io, half, ch)


@pytest.mark.parametrize("io", ["f32", "bf16"])
def test_roofline_report_on_the_h100(monkeypatch, io):
    """JAX's bytes on the same inputs; the bandwidth term JAX's with both of
    its dtype rates set to the H100's 3.35 TB/s; the operations the sum of
    chip_smoke's per-kernel counts; the bound the larger term."""
    if io == "bf16":
        monkeypatch.setenv("LPT_SPLIT_IO", "bf16")
    monkeypatch.setenv("LPT_BW_2B", "3.35e12")
    monkeypatch.setenv("LPT_BW_4B", "3.35e12")
    for shape, ch in (((3040, 4056), 1), ((48, 64), 3)):
        ref = jtracing.roofline_report(shape, iters_per_s=400.0, channels=ch)
        out = ttracing.roofline_report(shape, iters_per_s=400.0, channels=ch)
        for k in ("padded_shape", "bytes_per_iter", "bytes_2B", "bytes_4B",
                  "achieved_iters_per_s"):
            assert out[k] == ref[k], k
        assert out["sol_iters_per_s"] == pytest.approx(ref["sol_iters_per_s"], rel=1e-12)
        assert out["fraction_of_sol"] == pytest.approx(ref["fraction_of_sol"], rel=1e-12)
        ph, pw = out["padded_shape"]
        assert out["flops_per_iter"] == ch * ttracing.fused_admm_flops_per_iter(ph, pw)
        t = max(out["bytes_per_iter"] / 3.35e12, out["flops_per_iter"] / 67e12)
        assert out["combined_bound_iters_per_s"] == pytest.approx(1 / t, rel=1e-12)
        assert out["bound_by"] == "bytes" and out["launches_per_iter"] == 5
    assert ttracing.roofline_report(hbm_bw=1e12)["sol_iters_per_s"] == pytest.approx(
        1e12 / ttracing.roofline_report()["bytes_per_iter"])


@pytest.mark.parametrize("half", [True, False])
def test_flops_are_chip_smokes_kernel_counts(half):
    """The iteration's operations: chip_smoke.kernel_cases' K3, K4 forward
    and inverse, K5, K6 (v3), or split_kernel_cases' K10, K4 both ways at
    W, K5 at W, K11 (full width), at f32."""
    ph, pw = 96, 128
    gen = torch.Generator().manual_seed(0)
    f32 = torch.float32
    if half:
        cases = cs.kernel_cases(ph, pw, gen, f32, f32, f32, f32)
        names = ("e1_rtv", "h_passA_pair", "h_passA_pair:inverse", "h_combine_dual",
                 "irfft_w_dual_state")
    else:
        cases = cs.split_kernel_cases(ph, pw, gen, f32, f32, f32, f32)
        names = ("e1_carry", "h_passA_pair:full_width", "h_passA_pair:full_width_inverse",
                 "h_combine_dual:full_width", "ifft_w_dual")
    want = sum(cases[n][1] for n in names)
    assert ttracing.fused_admm_flops_per_iter(ph, pw, half) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("placement", ["v3", "v2", "spatial", "spatial_pallas"])
def test_launches_per_iter_are_chip_smokes_counts(placement):
    """One iteration's launches as chip_smoke.py reckons them (v3's K1,
    once before the loop, aside)."""
    want = {"v3": lambda: cs.want_counts(1), "v2": lambda: cs.want_counts(1, "v2"),
            "spatial": lambda: cs.want_spatial_counts(1, "rpallas"),
            "spatial_pallas": lambda: cs.want_spatial_counts(1, "pallas")}[placement]()
    if placement == "v3":
        want["rfft_w"] = 0
    got = ttracing.fused_admm_launches_per_iter(6144, 8192, placement)
    assert got == {k: v for k, v in want.items() if v}
    with pytest.raises(ValueError):
        ttracing.fused_admm_launches_per_iter(6144, 8192, "v4")


def test_trace_writes_a_chrome_trace_and_time_fn_times(tmp_path):
    x = torch.rand(64, 64)
    with ttracing.trace(str(tmp_path / "tr")) as d:
        torch.fft.rfft2(x)
    (path,) = (tmp_path / "tr").iterdir()
    assert d == str(tmp_path / "tr") and path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "lpt.trace" for e in events)
    calls = []
    t = ttracing.time_fn(lambda a: calls.append(a) or torch.fft.rfft2(a), x, repeats=3)
    assert 0.0 < t < 10.0 and len(calls) == 4


def test_port_tools_give_trace_a_log_dir():
    """No caller in the port, ``chip_smoke.py``, ``profile_solver.py`` or
    ``ab_kernels.py`` leans on ``trace``'s fixed default directory."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = [*sorted((root / "lenslesspicam_tpu_torch").rglob("*.py")),
             *(root / name for name in ("chip_smoke.py", "profile_solver.py", "ab_kernels.py"))]
    bare = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", None)
            if name == "trace" and not node.args and not any(
                    k.arg == "log_dir" for k in node.keywords):
                bare.append(f"{path.relative_to(root)}:{node.lineno}")
    assert len(files) > 80 and bare == []


# --- utils.plot --------------------------------------------------------------------------


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _bars(ax):
    return [(p.get_x(), p.get_height()) for p in ax.patches]


@pytest.mark.parametrize("shape,nbits", [((20, 30, 3), None), ((20, 30, 1), 8),
                                         ((20, 30), None)])
def test_pixel_histogram_like_jax(shape, nbits):
    img = _img(shape) * (255 if nbits else 1)
    ref = jplot.pixel_histogram(img, nbits=nbits)
    out = tplot.pixel_histogram(torch.from_numpy(img), nbits=nbits)
    assert _bars(out) == _bars(ref) and out.get_yscale() == ref.get_yscale() == "log"
    plt.close("all")


def test_plot_cross_section_like_jax(capsys):
    yy, xx = np.mgrid[-20:21, -30:31]
    psf = np.exp(-(yy ** 2 + xx ** 2) / 40.0).astype(np.float32)
    for kw in ({}, {"plot_db_drop": 3, "plot_width": 20}, {"log_scale": False, "row": 5}):
        _, ref = jplot.plot_cross_section(psf, **kw)
        jout = capsys.readouterr().out
        ax, out = tplot.plot_cross_section(torch.from_numpy(psf), **kw)
        assert capsys.readouterr().out == jout
        np.testing.assert_array_equal(out, ref)
        if "plot_db_drop" in kw:
            assert "-3dB width" in ax.get_xlabel() and "width" in jout
    plt.close("all")


def test_autocorrelations_like_jax():
    img = _img((24, 32, 3), 1)
    _, ref = jplot.plot_autocorr2d(img)
    _, out = tplot.plot_autocorr2d(torch.from_numpy(img))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    ref_axes, out_axes = jplot.plot_autocorr_rgb(img), tplot.plot_autocorr_rgb(img)
    for a, b in zip(out_axes, ref_axes):
        assert a.get_title() == b.get_title()
        np.testing.assert_allclose(a.images[0].get_array(), b.images[0].get_array(),
                                   rtol=1e-6, atol=1e-7)
    plt.close("all")


def test_compare_models_like_jax(tmp_path):
    paths = []
    for i in range(2):
        run = tmp_path / f"run{i}"
        run.mkdir()
        metrics = {str(e): {"eval": {"PSNR": 20.0 + i + e, "SSIM": 0.5}} for e in (2, 0, 1)}
        (run / "metrics.json").write_text(json.dumps(metrics))
        paths.append(str(run))
    paths[1] = os.path.join(paths[1], "metrics.json")
    ref = jplot.compare_models(paths, labels=["a", "b"])
    out = tplot.compare_models(paths, labels=["a", "b"])
    for a, b in zip(out.get_lines(), ref.get_lines()):
        np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())
        assert a.get_label() == b.get_label()
    assert out.get_ylabel() == "PSNR"
    plt.close("all")
