"""The port's CLI apps that run learned models or read the hub
(``lenslesspicam_tpu_torch/scripts/recon``: ``train_learning_based``,
``dataset_recon``, ``diffusercam``, ``digicam`` and their helpers
``_pretrained``) against the JAX package's scripts of the same paths,
in-process on the CPU (``LPT_PLATFORM=cpu``); the helpers and tolerances
of ``tests/test_torch_scripts.py``.

``train_learning_based`` draws other initial weights than the JAX app, so
it is held to the JAX app on the models it builds (each
``reconstruction.method`` of ``configs/train.yaml``, and one with a
post-processor, a PSF network and a compensation branch: the flax variable
tree's paths and shapes, so the parameter count and the modules' names),
the config it saves and the form of its ``best`` line; its trainer's
numbers are held in ``tests/test_torch_train.py``.  The hub's apps read
stand-in ``datasets`` / ``huggingface_hub`` modules put in ``sys.modules``
by ``monkeypatch`` (nothing reaches the network): every split is four
seeded 32 x 48 rows, and a zoo checkpoint a seeded 3-iteration unrolled
ADMM in the reference's layout.  A learned model is held to the JAX
package's on the same checkpoint at 1e-4 of the max
(``tests/test_torch_zoo_load.py``'s tolerance).
"""

import os
import re
import sys
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.scripts import _common
from lenslesspicam_tpu_torch.scripts.recon import _pretrained as t_pre
from lenslesspicam_tpu_torch.scripts.recon import dataset_recon as t_dsrecon
from lenslesspicam_tpu_torch.scripts.recon import diffusercam as t_diffusercam
from lenslesspicam_tpu_torch.scripts.recon import train_learning_based as t_train

from test_torch_scripts import (REPO, CPU, TOL_ADMM, TOL_LEARNED, TOL_METRIC, _both, _nerr,
                                _png_levels, _rel, _run, _saved)
from scripts.recon import dataset_recon as j_dsrecon
from scripts.recon import train_learning_based as j_train

sys.path.insert(0, str(REPO / "scripts" / "recon"))     # the JAX digicam's `_pretrained`
import _pretrained as j_pre  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")


# --- the trainer --------------------------------------------------------------------------

TRAIN_METHODS = {
    "unrolled_admm": {},
    "unrolled_fista": {},
    "trainable_inversion": {},
    "multi_wiener": {},
    "sv_deconvnet": {},
    "unrolled_admm+networks": {"reconstruction.unrolled_admm.n_iter": 3,
                               "reconstruction.post_process.network": "UnetRes",
                               "reconstruction.post_process.nc": [4, 8, 16, 16],
                               "reconstruction.post_process.depth": 1,
                               "reconstruction.psf_network": True,
                               "reconstruction.compensation": [4, 8, 16]},
}


@pytest.mark.parametrize("method", TRAIN_METHODS)
def test_train_app_builds_the_jax_models(method):
    """The model of each ``reconstruction.method`` of configs/train.yaml
    (and one with a post-processor, a PSF network and a compensation
    branch): the port's variables in the flax layout have flax's paths and
    shapes, so the same parameter count and modules."""
    from lenslesspicam_tpu_torch.utils.config import load_config

    overrides = {"reconstruction.method": method.split("+")[0], **TRAIN_METHODS[method]}
    config = load_config(_common.config_path("train.yaml"), overrides)
    jmodel = j_train._build_model(config)
    tmodel = t_train._build_model(config, CPU, psf_channels=3)
    data = np.random.RandomState(0).rand(1, 1, 32, 48, 3).astype(np.float32)
    psf = np.random.RandomState(1).rand(1, 32, 48, 3).astype(np.float32)
    with torch.no_grad():
        tmodel(data, psf)           # a parameter made on the first call
    ref = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(data),
                                             jnp.asarray(psf)))
    ref = {k: v for k, v in ref.items() if k in ("params", "batch_stats")}
    variables = convert.to_variables(tmodel)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), variables)
    ref_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    n_port = sum(p.numel() for p in tmodel.parameters())
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(ref.get("params", {})))
    if method == "multi_wiener":
        # the one difference: a gain for each of the PSF's 3 channels where
        # flax keeps one for all
        assert (shapes["params"].pop("w"), ref_shapes["params"].pop("w")) == (
            (1, 1, 1, 3), (1, 1, 1, 1))
        n_jax += 2
    assert shapes == ref_shapes
    assert n_port == n_jax


def test_train_app_saves_the_jax_config_and_best_line(tmp_path, capsys):
    args = ["dataset.n_files=8", "dataset.batch_size=2", "training.epoch=1"]
    _run(j_train.main, args, tmp_path / "jax")
    jax_out = capsys.readouterr().out
    _run(t_train.main, args, tmp_path / "port")
    port_out = capsys.readouterr().out
    configs = [yaml.safe_load(open(_saved(tmp_path / side, "config.yaml")))
               for side in ("port", "jax")]
    configs[0]["output_dir"] = configs[1]["output_dir"]
    assert configs[0] == configs[1]
    best = [re.findall(r"^best (\S+): (\S+)$", text, re.M) for text in (port_out, jax_out)]
    assert len(best[0]) == len(best[1]) == 1 and best[0][0][0] == best[1][0][0] == "PSNR"
    assert np.isfinite(float(best[0][0][1]))
    assert _saved(tmp_path / "port", "checkpoints").is_dir()


def test_train_app_resumes_from_the_latest_checkpoint(tmp_path, capsys):
    """tests/test_scripts.py's resume: a second run from the first run's
    checkpoints starts at epoch 1."""
    args = ["dataset.n_files=8", "dataset.batch_size=2"]
    _run(t_train.main, [*args, "training.epoch=1"], tmp_path / "a")
    ckpt = _saved(tmp_path / "a", "checkpoints")
    log = _run(t_train.main, [*args, "training.epoch=2", f"training.resume={ckpt}"],
               tmp_path / "b")
    assert "resumed at epoch 1" in capsys.readouterr().out
    assert log


# --- the hub's apps, on stand-in hub modules ---------------------------------------

class _Rows:
    """A loaded hub split: dict rows and ``column_names``."""

    def __init__(self, rows):
        self.rows, self.column_names = rows, list(rows[0])

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        return self.rows[int(idx)]


@pytest.fixture
def hub(monkeypatch, tmp_path):
    """Stand-in ``datasets`` and ``huggingface_hub``: every split is four
    seeded 32 x 48 rows, a file is the one of that name under
    ``tmp_path / "hub"``, a snapshot is the folder ``snapshots[repo_id]``."""
    rng = np.random.RandomState(5)
    rows = _Rows([{"lensless": (rng.rand(32, 48, 3) * 255).astype(np.uint8),
                   "lensed": (rng.rand(32, 48, 3) * 255).astype(np.uint8)} for _ in range(4)])
    folder = tmp_path / "hub"
    folder.mkdir()
    psf = (rng.rand(32, 48, 3) * 200 + 20).astype(np.uint8)
    for name in ("psf.tiff", "psf.png"):
        cv2.imwrite(str(folder / name), psf)
    snapshots = {}
    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=lambda repo, split=None, cache_dir=None, **_: rows))
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        hf_hub_download=lambda repo_id, filename, **_: str(folder / filename),
        snapshot_download=lambda repo_id, **_: snapshots[repo_id]))
    return types.SimpleNamespace(dir=folder, snapshots=snapshots)


def _unrolled_checkpoint(folder, config):
    """A reference checkpoint folder of a seeded 3-iteration unrolled ADMM
    (tests/test_torch_zoo_load.py's layout): its config and its
    schedules at the top level of the state dict."""
    from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM

    model = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=3, device=CPU), device=CPU)
    sd = convert.state_dict(model, convert.random_variables(model, 3))
    sd = {k.replace("camera_inversion._", "_"): v for k, v in sd.items()}
    (folder / ".hydra").mkdir(parents=True)
    with open(folder / ".hydra" / "config.yaml", "w") as f:
        yaml.safe_dump(config, f)
    torch.save(sd, folder / "recon_epochBEST")
    return str(folder)


UNROLLED = {"reconstruction": {"method": "unrolled_admm", "unrolled_admm": {"n_iter": 3},
                               "pre_process": {"network": None},
                               "post_process": {"network": None}}}


def _printed_metrics(text):
    return [eval(m, {}) for m in re.findall(r"^\[\d+\] \S+ ms  (\{.*\})$", text, re.M)]


@pytest.mark.parametrize("algo", ["admm", "hf"])
def test_dataset_recon_app_matches_jax(hub, tmp_path, capsys, algo):
    """Two samples of the registry's ``diffusercam_mirflickr`` from the
    stand-in hub, through ADMM or a zoo checkpoint (a seeded unrolled
    ADMM): the printed metrics within 1e-4 relative."""
    from lenslesspicam_tpu_torch.zoo.model_dict import model_dict

    name = next(iter(model_dict["diffusercam"]["mirflickr"]))
    hub.snapshots[model_dict["diffusercam"]["mirflickr"][name]] = _unrolled_checkpoint(
        tmp_path / "ckpt", UNROLLED)
    args = ["dataset=diffusercam_mirflickr", "n_iter=5", "n_files=2",
            "algo=" + ("admm" if algo == "admm" else f"hf:diffusercam:mirflickr:{name}")]
    _run(j_dsrecon.main, args, tmp_path / "jax")
    ref = _printed_metrics(capsys.readouterr().out)
    out = _run(t_dsrecon.main, args, tmp_path / "port")
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert sorted(o) == sorted(r)
        for k in r:
            assert _rel(o[k], r[k]) <= TOL_METRIC, k


def test_diffusercam_app_matches_jax(hub, tmp_path):
    out, _ = _both(tmp_path, "recon.diffusercam", ["n_trials=1", "n_iter=5"])
    assert out.shape == (1, 16, 24, 3)
    assert _png_levels(_saved(tmp_path / "port", "admm_0.png"),
                       _saved(tmp_path / "jax", "admm_0.png")) <= 1


def test_diffusercam_app_runs_a_zoo_model(hub, tmp_path):
    """A zoo model runs as the module ``load_model`` returns, held to the
    JAX package's model on the same checkpoint (the JAX app calls the tuple
    its ``load_model`` returns)."""
    from lenslesspicam_tpu.zoo import model_dict as jzoo
    from lenslesspicam_tpu_torch.data.datasets import get_dataset

    name = next(iter(jzoo.model_dict["diffusercam"]["mirflickr"]))
    path = _unrolled_checkpoint(tmp_path / "ckpt", UNROLLED)
    hub.snapshots[jzoo.model_dict["diffusercam"]["mirflickr"][name]] = path
    out = _run(t_diffusercam.main, [f"model={name}", "n_trials=1"], tmp_path / "port")
    ds = get_dataset("diffusercam_mirflickr", split="test", device=CPU)
    jmodel, jvars = jzoo.load_model(path, ds.psf)[:2]
    ref = jmodel.apply(jvars, jnp.asarray(ds[0][0][None]), jnp.asarray(ds.psf))
    assert _nerr(out, ref) <= TOL_LEARNED


@pytest.mark.parametrize("model", ["admm", "unrolled"])
def test_digicam_app_matches_jax(hub, tmp_path, model):
    """``model_path=`` a local checkpoint folder whose config names the
    stand-in hub's dataset and PSF; ADMM or its model, the alignment crop
    saved."""
    config = {"files": {"dataset": "owner/digicam", "huggingface_psf": "psf.png",
                        "downsample": 1},
              "alignment": {"top_left": [2, 3], "height": 20, "width": 30}, **UNROLLED}
    path = _unrolled_checkpoint(tmp_path / "ckpt", config)
    args = [f"model_path={path}", "n_iter=5", "n_trials=1",
            f"model={'admm' if model == 'admm' else 'U5'}"]
    out, ref = _both(tmp_path, "recon.digicam", args)
    assert out[1] > 0 and _nerr(out[0].numpy(), ref[0]) <= (
        TOL_ADMM if model == "admm" else TOL_LEARNED)
    assert _png_levels(_saved(tmp_path / "port", f"{args[-1][6:]}_idx0.png"),
                       _saved(tmp_path / "jax", f"{args[-1][6:]}_idx0.png")) <= 1


def test_pretrained_helpers_match_jax(tmp_path):
    """tests/test_scripts.py's helper flow: ``build_recon("admm")``,
    ``timed_apply``, ``save_outputs`` and ``alignment_crop``."""
    rng = np.random.RandomState(0)
    psf = rng.rand(1, 32, 40, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    meas = rng.rand(1, 1, 32, 40, 3).astype(np.float32)
    res, avg_ms = t_pre.timed_apply(t_pre.build_recon("admm", None, psf, n_iter=5), meas,
                                    n_trials=2)
    ref = j_pre.build_recon("admm", None, psf, n_iter=5)(meas)
    assert avg_ms > 0 and _nerr(res.numpy(), ref) <= TOL_ADMM
    align = {"top_left": (2, 2), "height": 20, "width": 24}
    files = t_pre.save_outputs(str(tmp_path), "admm", 0, res, meas, lensed=meas[0, 0],
                               alignment=align, psf=psf, background=meas)
    assert [os.path.basename(f) for f in files] == [
        "admm_idx0.png", "original_idx0.png", "lensless_idx0.png", "psf.png",
        "background_idx0.png"]
    assert all(os.path.isfile(f) for f in files)
    img = np.zeros((32, 40, 3))
    assert t_pre.alignment_crop(img, align).shape == j_pre.alignment_crop(img, align).shape \
        == (20, 24, 3)
