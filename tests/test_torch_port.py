"""Properties of the PyTorch/CUDA port that hold on any machine: every
module of it imports with JAX, the JAX package, flax, OpenCV and
matplotlib blocked, its entry points refuse to
run on the CPU unless asked to, and importing it builds nothing."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lenslesspicam_tpu_torch.ops import _build
from lenslesspicam_tpu_torch.ops import kernels as K
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from lenslesspicam_tpu_torch.recon.base import ADMM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PURITY = r"""
import importlib, os, pkgutil, re, sys
# what the port must not need at import: JAX, the JAX package, and the
# JAX package's host dependencies that the card's machine does not have
BLOCKED = ("jax", "jaxlib", "flax", "cv2", "matplotlib", "lenslesspicam_tpu")
for name in BLOCKED:
    sys.modules[name] = None          # an import of it raises ImportError
import lenslesspicam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# the learned models and the zoo, and the public names that resolve to them
learned = {f"{pkg.__name__}.models.{m}" for m in (
    "unet", "unrolled", "inversion", "multi_wiener", "compensation", "background",
    "restormer", "trainable_recon")} | {f"{pkg.__name__}.zoo.model_dict"}
missed_learned = sorted(learned - set(names))
for public in pkg._LAZY:
    getattr(pkg, public)
import chip_smoke, ab_kernels, profile_solver
files = {os.path.relpath(os.path.join(d, f), os.path.dirname(pkg.__path__[0]))[:-3]
         .replace(os.sep, ".").removesuffix(".__init__")
         for d, _, fs in os.walk(pkg.__path__[0]) for f in fs if f.endswith(".py")}
missed = sorted(files - set(names) - {pkg.__name__})
bad = [m for m in sys.modules if sys.modules[m] is not None
       and (m.split(".")[0] in BLOCKED or re.match(r"^lenslesspicam_tpu(\.|$)", m))]
print("BAD", bad, "MISSED", missed + missed_learned, "IMPORTED", len(names))
sys.exit(1 if bad or missed or missed_learned else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _PURITY], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_precompute_rsplit_without_cuda_raises(no_cuda):
    psf = np.ones((48, 64), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsplit.precompute_rsplit(psf, psf)
    assert tsplit.precompute_rsplit(psf, psf, device="cpu").Hr.device.type == "cpu"


def test_admm_without_cuda_raises(no_cuda):
    psf = np.ones((1, 8, 8, 1), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ADMM(psf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadmm.make_convolver(psf)
    assert ADMM(psf, device="cpu")._convolver.H.device.type == "cpu"


def test_cpu_path_builds_nothing(monkeypatch):
    """Importing the build module and running every wrapper on CPU tensors
    starts no compiler and loads no library."""
    def refuse(*args, **kwargs):
        raise AssertionError("a compiler was started")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    K.reset_launches()
    rng = np.random.RandomState(0)

    def r(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32))

    K.rfft_w(r(96, 128))
    K.e1_rtv(r(96, 128), r(96, 128), r(96, 128), r(96, 128), 1e-5, 4e-5, 1e-4)
    K.fft_h_combine_dual(*[r(96, 64) for _ in range(7)], 96)
    K.irfft_w_dual_state(*[r(96, 64) for _ in range(4)], *[r(96) for _ in range(4)],
                         r(96, 128), r(96, 128), r(96, 128), 1e-6)
    K.irfft_w(*K.rfft_w(r(96, 128).to(torch.bfloat16)))
    K.sat_scan_i16((r(96, 128) * 100).to(torch.int16))
    tsplit.run_rsplit(tsplit.precompute_rsplit(r(48, 64).numpy(), r(48, 64).numpy(), device="cpu"),
                      n_iter=2, io="bf16", carry_tv="i16", carry_v="i16")
    assert _build._libs == {}
    assert sum(K.launch_counts().values()) == 0


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py alone in a directory, and in the repo without a card,
    exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    for cwd, script in ((tmp_path, lone), (REPO, os.path.join(REPO, "chip_smoke.py"))):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
