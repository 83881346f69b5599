"""The port's CLI apps (``lenslesspicam_tpu_torch/scripts``) against the
JAX package's scripts of the same paths, in-process on the CPU
(``LPT_PLATFORM=cpu``), on the same seeded inputs at the sizes of
``tests/test_scripts.py`` (64 x 96 x 3 PNGs, ``downsample=2``, 5
iterations); each app's run directory under ``tmp_path``.  This file holds
the reconstruction apps ``admm``, ``gradient_descent``, ``apgd`` and
``demo``, the simulation apps and what every app shares; the evaluation
apps are in ``tests/test_torch_scripts_eval.py``, the trainer's and the
hub's in ``tests/test_torch_scripts_models.py``, which take their helpers
and tolerances from here.

Tolerances:

- ``admm`` and ``quality_baseline``'s ``admm`` / ``admm_rfused`` /
  ``admm_split``: 1e-5 of the max (``tests/test_torch_admm.py``'s);
- the GD family and APGD: 1e-4 (``tests/test_torch_classical.py``'s);
- the metrics that ``benchmark_recon``, ``compute_metrics_from_original``
  and ``dataset_recon`` return or print: each within 1e-4 relative;
- ``quality_baseline.run_sweep``: PSNR within 0.01 dB;
- the simulation apps (their noise drawn as the JAX package draws it,
  ``ops.noise._normal`` patched to ``jax.random.normal(PRNGKey(0))``):
  1e-5 for the simulated pairs, 1e-4 for what ADMM makes of them;
- a saved 8-bit PNG: within one level.

Also here: ``python -m`` of the ``admm`` app with the JAX script's
overrides and printed lines, the YAML or defaults each app reads, an AST
scan for imports of JAX, and the apps' refusal to run without a card
unless ``LPT_PLATFORM=cpu``.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lenslesspicam_tpu_torch.ops import noise as tnoise
from lenslesspicam_tpu_torch.scripts import _common
from lenslesspicam_tpu_torch.scripts.eval import benchmark_recon as t_bench
from lenslesspicam_tpu_torch.scripts.eval import compute_metrics_from_original as t_metrics
from lenslesspicam_tpu_torch.scripts.eval import quality_baseline as t_qb
from lenslesspicam_tpu_torch.scripts.recon import admm as t_admm
from lenslesspicam_tpu_torch.scripts.recon import apgd as t_apgd
from lenslesspicam_tpu_torch.scripts.recon import dataset_recon as t_dsrecon
from lenslesspicam_tpu_torch.scripts.recon import demo as t_demo
from lenslesspicam_tpu_torch.scripts.recon import diffusercam as t_diffusercam
from lenslesspicam_tpu_torch.scripts.recon import digicam as t_digicam
from lenslesspicam_tpu_torch.scripts.recon import gradient_descent as t_gd
from lenslesspicam_tpu_torch.scripts.recon import train_learning_based as t_train
from lenslesspicam_tpu_torch.scripts.sim import simulate_dataset as t_simds
from lenslesspicam_tpu_torch.scripts.sim import single_file as t_single

from scripts.eval import benchmark_recon as j_bench
from scripts.eval import compute_metrics_from_original as j_metrics
from scripts.eval import quality_baseline as j_qb
from scripts.recon import admm as j_admm
from scripts.recon import apgd as j_apgd
from scripts.recon import dataset_recon as j_dsrecon
from scripts.recon import demo as j_demo
from scripts.recon import diffusercam as j_diffusercam
from scripts.recon import digicam as j_digicam
from scripts.recon import gradient_descent as j_gd
from scripts.recon import train_learning_based as j_train
from scripts.sim import simulate_dataset as j_simds
from scripts.sim import single_file as j_single

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL_ADMM = 1e-5
TOL_GD = 1e-4
TOL_METRIC = 1e-4
TOL_PSNR_DB = 0.01
TOL_SIM = 1e-5
TOL_SIM_RECON = 1e-4
TOL_LEARNED = 1e-4

# (port module, JAX module, name of the entry point) of every app
APPS = {
    "recon.admm": (t_admm, j_admm, "main"),
    "recon.gradient_descent": (t_gd, j_gd, "main"),
    "recon.apgd": (t_apgd, j_apgd, "main"),
    "recon.dataset_recon": (t_dsrecon, j_dsrecon, "main"),
    "recon.diffusercam": (t_diffusercam, j_diffusercam, "main"),
    "recon.digicam": (t_digicam, j_digicam, "main"),
    "recon.demo": (t_demo, j_demo, "main"),
    "recon.train_learning_based": (t_train, j_train, "main"),
    "eval.benchmark_recon": (t_bench, j_bench, "main"),
    "eval.compute_metrics_from_original": (t_metrics, j_metrics, "compute_metrics"),
    "eval.quality_baseline": (t_qb, j_qb, "main"),
    "sim.simulate_dataset": (t_simds, j_simds, "main"),
    "sim.single_file": (t_single, j_single, "simulate"),
}


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's normal draw is the JAX simulator's keyless one,
    ``jax.random.normal(PRNGKey(0))``."""
    monkeypatch.setattr(tnoise, "_normal", lambda x, g: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), tuple(x.shape), jnp.float32))))


@pytest.fixture
def pngs(tmp_path):
    """tests/test_scripts.py's inputs: a 64 x 96 x 3 PSF and measurement."""
    rng = np.random.RandomState(0)
    psf = (rng.rand(64, 96, 3) * 200 + 20).astype(np.uint8)
    data = (rng.rand(64, 96, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "psf.png"), psf)
    cv2.imwrite(str(tmp_path / "data.png"), data)
    return str(tmp_path / "psf.png"), str(tmp_path / "data.png")


def _nerr(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _run(main, args, out):
    return main([*args, f"output_dir={out}"])


def _both(tmp_path, name, args):
    """The JAX app's and the port's results of ``args``, each in a run
    directory of its own."""
    port, jax_app, entry = APPS[name]
    ref = _run(getattr(jax_app, entry), args, tmp_path / "jax")
    out = _run(getattr(port, entry), args, tmp_path / "port")
    return out, ref


def _shape_of_lines(text, tmp_path):
    """The printed lines with their numbers and run paths blanked."""
    text = text.replace(str(tmp_path / "jax"), "<run>").replace(str(tmp_path / "port"), "<run>")
    return [re.sub(r"[-+]?\d[\d.]*(e[-+]?\d+)?", "#", ln) for ln in text.splitlines()]


def _saved(root, name):
    found = sorted(Path(root).rglob(name))
    assert found, f"no {name} under {root}"
    return found[-1]


def _png_levels(a, b):
    """The largest difference of two saved 8-bit images, in levels."""
    x, y = (cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(int) for p in (a, b))
    assert x.shape == y.shape
    return int(np.abs(x - y).max())


# --- recon: admm, gradient descent, apgd -----------------------------------------------

RECON = ["preprocess.downsample=2"]


def test_admm_app_matches_jax(pngs, tmp_path, capsys):
    """The numpy (depth, H, W, C) float32 result, and the same printed
    lines."""
    args = [f"input.psf={pngs[0]}", f"input.data={pngs[1]}", *RECON, "admm.n_iter=5"]
    ref = _run(j_admm.main, args, tmp_path / "jax")
    jax_out = capsys.readouterr().out
    out = _run(t_admm.main, args, tmp_path / "port")
    port_out = capsys.readouterr().out
    assert isinstance(out, np.ndarray) and out.dtype == ref.dtype == np.float32
    assert out.shape == ref.shape == (1, 32, 48, 3)
    assert _nerr(out, ref) <= TOL_ADMM
    assert _shape_of_lines(port_out, tmp_path) == _shape_of_lines(jax_out, tmp_path)
    assert _png_levels(_saved(tmp_path / "port", "reconstruction.png"),
                       _saved(tmp_path / "jax", "reconstruction.png")) <= 1


@pytest.mark.parametrize("method", ["vanilla", "nesterov", "fista"])
def test_gradient_descent_app_matches_jax(pngs, tmp_path, method):
    out, ref = _both(tmp_path, "recon.gradient_descent",
                     [f"input.psf={pngs[0]}", f"input.data={pngs[1]}", *RECON,
                      f"gradient_descent.method={method}", "gradient_descent.n_iter=5"])
    assert isinstance(out, np.ndarray) and _nerr(out, ref) <= TOL_GD


def test_apgd_app_matches_jax(pngs, tmp_path):
    out, ref = _both(tmp_path, "recon.apgd",
                     [f"input.psf={pngs[0]}", f"input.data={pngs[1]}", *RECON, "apgd.n_iter=5"])
    assert out.shape == ref.shape == (1, 1, 32, 48, 3)
    assert _nerr(out, ref) <= TOL_GD


def test_admm_app_runs_as_a_module(pngs, tmp_path):
    """``python -m lenslesspicam_tpu_torch.scripts.recon.admm`` with the JAX
    script's overrides."""
    env = dict(os.environ, LPT_PLATFORM="cpu", PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "lenslesspicam_tpu_torch.scripts.recon.admm",
         f"input.psf={pngs[0]}", f"input.data={pngs[1]}", *RECON, "admm.n_iter=5",
         f"output_dir={tmp_path}/out"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "recon     :" in res.stdout and "(5 iterations)" in res.stdout
    assert _saved(tmp_path / "out", "reconstruction.png").is_file()


# --- sim ----------------------------------------------------------------------------------

def test_single_file_app_matches_jax(pngs, tmp_path, jax_noise):
    out, ref = _both(tmp_path, "sim.single_file",
                     [f"files.original={pngs[1]}", f"files.psf={pngs[0]}",
                      "simulation.downsample=1", "admm.n_iter=5"])
    assert out.shape == ref.shape and _nerr(out, ref) <= TOL_SIM_RECON
    for name in ("image_plane.png", "object_plane.png"):
        assert _png_levels(_saved(tmp_path / "port", name), _saved(tmp_path / "jax", name)) <= 1


def test_simulate_dataset_app_matches_jax(tmp_path, jax_noise):
    out, ref = _both(tmp_path, "sim.simulate_dataset",
                     ["n_files=3", "mask.type=FresnelZoneAperture", "mask.downsample=16"])
    names = sorted(str(p.relative_to(ref)) for p in Path(ref).rglob("*.npy"))
    assert names == sorted(str(p.relative_to(out)) for p in Path(out).rglob("*.npy"))
    assert len(names) == 7
    for name in names:
        assert _nerr(np.load(Path(out) / name), np.load(Path(ref) / name)) <= TOL_SIM, name


# --- recon: demo -------------------------------------------------------------

def test_demo_app_matches_jax(pngs, tmp_path):
    out, _ = _both(tmp_path, "recon.demo",
                   [f"raw={pngs[1]}", f"camera.psf={pngs[0]}", "recon.downsample=2",
                    "recon.admm.n_iter=5", "postproc.crop_hor=[0.1,0.9]"])
    assert out.shape == (32, 39, 3)
    assert _png_levels(_saved(tmp_path / "port", "reconstructed.png"),
                       _saved(tmp_path / "jax", "reconstructed.png")) <= 1


# --- the surface --------------------------------------------------------------------------

def test_every_app_is_here():
    """The apps of this file are the modules of the port's scripts package
    (``_common`` and ``_pretrained`` are helpers)."""
    root = REPO / "lenslesspicam_tpu_torch" / "scripts"
    mods = {".".join(p.relative_to(root).with_suffix("").parts) for p in root.rglob("*.py")
            if p.name != "__init__.py"}
    assert mods == set(APPS) | {"_common", "recon._pretrained"}


@pytest.mark.parametrize("name", APPS)
def test_app_reads_the_jax_config(name):
    """An app reads the YAML of its JAX script, or its ``_DEFAULTS``."""
    port, jax_app, _ = APPS[name]
    if hasattr(jax_app, "_CONFIG"):
        assert os.path.realpath(port._CONFIG) == os.path.realpath(jax_app._CONFIG)
        assert os.path.isfile(port._CONFIG)
    elif hasattr(jax_app, "_DEFAULTS"):
        assert port._DEFAULTS == jax_app._DEFAULTS
    else:                                   # quality_baseline: argparse, no config
        assert name == "eval.quality_baseline"


def test_no_app_imports_jax():
    """No module of the scripts package imports jax, flax or the JAX
    package (an AST scan, relative imports resolved)."""
    root = REPO / "lenslesspicam_tpu_torch" / "scripts"
    bad = []
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "lenslesspicam_tpu")]
    assert bad == []


def test_app_device_follows_lpt_platform(monkeypatch):
    assert _common.app_device() == torch.device(CPU)
    assert _common.app_device("cpu") == torch.device(CPU)
    monkeypatch.setenv("LPT_PLATFORM", "tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _common.app_device()


@pytest.mark.parametrize("name", APPS)
def test_app_raises_without_a_card(name, tmp_path, monkeypatch):
    """Without ``LPT_PLATFORM=cpu`` and without a CUDA card an app raises
    before it reads its config: no run directory is made."""
    port, _, entry = APPS[name]
    monkeypatch.delenv("LPT_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = ["--quick"] if name == "eval.quality_baseline" else [f"output_dir={tmp_path}/out"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port, entry)(argv)
    assert os.listdir(tmp_path) == []
