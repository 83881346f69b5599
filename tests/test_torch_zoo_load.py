"""The port's ``zoo.model_dict.load_model`` against the JAX package's on the
CPU, one case for each family of ``tests/test_zoo_load.py`` and the
loader's options.

Each case writes a reference-layout checkpoint folder: the Hydra config
``.hydra/config.yaml`` (``yaml.safe_dump``) and ``recon_epochBEST``, the
torch state dict of seeded port modules (``convert.state_dict`` of
``convert.random_variables``, a JAX-layout tree drawn with numpy) with the
unrolled schedules ``_mu*_p`` / ``_tau_p`` moved to the top level, where
the reference keeps them.  Both packages' ``load_model`` read the folder;
the JAX model runs on its loaded variables laid over the same seeded tree
(the JAX loader returns only what the checkpoint holds, as
``tests/test_zoo_load.py``'s ``_merge`` does), and the forwards are held
to each other at TOL_RECON = 1e-4 of the max (``tests/test_torch_learned.py``'s
tolerance for models with networks inside).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lenslesspicam_tpu.zoo import model_dict as jzoo

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.models.compensation import CompensationBranch
from lenslesspicam_tpu_torch.models.inversion import SVDeconvNet, TrainableInversion
from lenslesspicam_tpu_torch.models.multi_wiener import MultiWiener
from lenslesspicam_tpu_torch.models.restormer import Restormer
from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon
from lenslesspicam_tpu_torch.models.unet import UNetRes
from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM
from lenslesspicam_tpu_torch.zoo import model_dict as tzoo

CPU = "cpu"
TOL_RECON = 1e-4
NC = [4, 8, 16, 16]                  # tests/test_zoo_load.py:19


def _problem(shape=(1, 32, 40, 3), seed=0, batch=2):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    return psf, rng.rand(batch, *shape).astype(np.float32)


def _rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _unet(nc=NC, depth=2, **kw):
    return UNetRes(in_nc=4, out_nc=3, nc=tuple(nc), nb=depth, device=CPU, **kw)


def _reference_sd(model, variables):
    """The reference's state dict of ``model``: the port's keys, the
    unrolled schedules at the top level."""
    sd = convert.state_dict(model, variables)
    return {k.replace("camera_inversion._", "_") if k.startswith("camera_inversion._")
            else k: v for k, v in sd.items()}


def _write(folder, config, sd, name="recon_epochBEST"):
    os.makedirs(folder / ".hydra", exist_ok=True)
    with open(folder / ".hydra" / "config.yaml", "w") as f:
        yaml.safe_dump(config, f)
    torch.save(sd, folder / name)
    return str(folder)


def _seeded(model, seed, run=None):
    """JAX-layout seeded variables of ``model`` (run once first on
    ``run`` where a parameter is made on the first call)."""
    if run is not None:
        with torch.no_grad():
            model(*run)
    return convert.random_variables(model, seed)


def _overlay(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _overlay(base[k], v) if (k in base and isinstance(v, dict)) else v
    return out


def _jax_forward(path, variables, data, psf, **kw):
    """The JAX ``load_model`` of ``path`` and its model's output, its loaded
    variables laid over ``variables``; returns (output, JAX load result)."""
    background = kw.pop("background", None)
    loaded = jzoo.load_model(path, psf=psf, **kw)
    jmodel, jvars = loaded[0], loaded[1]
    merged = {c: _overlay(variables.get(c, {}), jvars.get(c, {}))
              for c in set(variables) | set(jvars)}
    merged = jax.tree_util.tree_map(jnp.asarray, merged)
    args = (jnp.asarray(data), jnp.asarray(psf))
    kwargs = {} if background is None else {"background": jnp.asarray(background)}
    fn = jax.jit(functools.partial(jmodel.apply, **kwargs))
    out = fn.lower(merged, *args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(merged, *args)
    return out, loaded


def _port_forward(path, data, psf, **kw):
    background = kw.pop("background", None)
    loaded = tzoo.load_model(path, psf=psf, device=CPU, **kw)
    model = loaded[0]
    assert not model.training
    with torch.no_grad():
        out = model(data, psf, **({} if background is None else {"background": background}))
    return out, loaded


def _outputs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _check(tmp_path, model, config, psf, data, seed, run=None, background=None, **kw):
    variables = _seeded(model, seed, run)
    path = _write(tmp_path, config, _reference_sd(model, variables))
    extra = {} if background is None else {"background": background}
    out, tl = _port_forward(path, data, psf, **extra, **kw)
    ref, jl = _jax_forward(path, variables, data, psf, **extra, **kw)
    for o, r in zip(_outputs(out), _outputs(ref)):
        assert _rel(o, r) <= TOL_RECON
    assert tl[1] == jl[2] == config
    return tl, jl, variables


def _config(method, **recon):
    recon = {"method": method, "skip_unrolled": False, "pre_process": {"network": None},
             "post_process": {"network": None}, **recon}
    return {"files": {"downsample": 1}, "reconstruction": recon}


def _unet_cfg(depth=2, nc=NC):
    return {"network": "UnetRes", "depth": depth, "nc": list(nc)}


# --- the families of tests/test_zoo_load.py -----------------------------------------

def _pre_post_model():
    return TrainableRecon(camera_inversion=UnrolledADMM(n_iter=3, device=CPU),
                          pre_process=_unet(), post_process=_unet(), device=CPU)


PRE_POST = _config("unrolled_admm", unrolled_admm={"n_iter": 3}, pre_process=_unet_cfg(),
                   post_process=_unet_cfg())


def test_load_unrolled_admm_pre_post(tmp_path):
    psf, data = _problem()
    _check(tmp_path, _pre_post_model(), PRE_POST, psf, data, seed=1)


@pytest.mark.parametrize("flags", [{"skip_pre": True}, {"skip_post": True},
                                   {"return_intermediate": True}])
def test_load_options(tmp_path, flags):
    """``skip_pre``, ``skip_post`` and ``return_intermediate`` (all four
    outputs held to JAX's) on the pre + unrolled + post family."""
    psf, data = _problem(seed=2)
    (model, _), _, _ = _check(tmp_path, _pre_post_model(), PRE_POST, psf, data, seed=2,
                              **flags)
    for name, value in flags.items():
        assert getattr(model, name) is value


def test_load_psf_network_family(tmp_path):
    psf, data = _problem(seed=1)
    model = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=2, device=CPU),
                           post_process=_unet(), psf_network=_unet(depth=4),
                           psf_residual=True, device=CPU)
    config = _config("unrolled_admm", unrolled_admm={"n_iter": 2},
                     post_process=_unet_cfg(), psf_network=NC, psf_residual=True)
    _check(tmp_path, model, config, psf, data, seed=3)


def test_load_trainable_inversion_family(tmp_path):
    psf, data = _problem(seed=2)
    model = TrainableRecon(camera_inversion=TrainableInversion(K=1e-4),
                           post_process=_unet(), device=CPU)
    config = _config("trainable_inv", trainable_inv={"K": 1e-4}, post_process=_unet_cfg())
    _check(tmp_path, model, config, psf, data, seed=4)


def test_load_multiwiener_family(tmp_path):
    psf, data = _problem(seed=3)
    nc = [4, 8, 16, 16, 16]
    model = MultiWiener(in_channels=3, out_channels=3, psf_channels=3, nc=nc, device=CPU)
    config = {"files": {"downsample": 1, "single_channel_psf": False},
              "reconstruction": {"method": "multi_wiener", "multi_wiener": {"nc": nc},
                                 "pre_process": {"network": None},
                                 "post_process": {"network": None}}}
    (loaded, _), _, _ = _check(tmp_path, model, config, psf, data, seed=5)
    assert isinstance(loaded, MultiWiener)


def test_load_compensation_family(tmp_path):
    psf, data = _problem(shape=(1, 32, 32, 3), seed=4, batch=1)
    comp_nc = [4, 8, 16]
    model = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=3, device=CPU),
                           post_process=_unet(concatenate_compensation=comp_nc[-1]),
                           compensation_branch=CompensationBranch(nc=comp_nc, residual=True,
                                                                  device=CPU), device=CPU)
    config = _config("unrolled_admm", unrolled_admm={"n_iter": 3}, post_process=_unet_cfg(),
                     compensation=comp_nc, compensation_residual=True)
    (loaded, _), _, variables = _check(tmp_path, model, config, psf, data, seed=6)
    bn = loaded.compensation_branch.branch_layers[0][1]
    np.testing.assert_array_equal(
        bn.running_var.numpy(),
        variables["batch_stats"]["compensation_branch"]["branch0"]["BatchNorm_0"]["var"])


RESTORMER = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
             "heads": [1, 2, 2, 4], "ffn_expansion_factor": 2.66}


def test_load_restormer_processor(tmp_path):
    psf, data = _problem(seed=5, batch=1)
    rp = RESTORMER
    pre = Restormer(out_channels=3, dim=rp["dim"], num_blocks=tuple(rp["num_blocks"]),
                    num_refinement_blocks=rp["num_refinement_blocks"],
                    heads=tuple(rp["heads"]), expansion=rp["ffn_expansion_factor"], device=CPU)
    model = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=2, device=CPU),
                           pre_process=pre, device=CPU)
    config = _config("unrolled_admm", unrolled_admm={"n_iter": 2},
                     pre_process={"network": "Restormer", "restormer_params": rp})
    _check(tmp_path, model, config, psf, data, seed=7)


def test_load_learned_background_family(tmp_path):
    psf, data = _problem(seed=6)
    background = (np.random.RandomState(7).rand(*data.shape) * 0.1).astype(np.float32)
    model = TrainableRecon(camera_inversion=UnrolledADMM(n_iter=2, device=CPU),
                           post_process=_unet(), background_network=_unet(depth=4), device=CPU)
    config = _config("unrolled_admm", unrolled_admm={"n_iter": 2}, post_process=_unet_cfg(),
                     learned_background_subtraction=NC)
    _check(tmp_path, model, config, psf, data, seed=8, background=background)


def test_load_svdeconvnet_with_learned_psf(tmp_path):
    """SVDeconvNet's PSF copies from ``psf_epochBEST.npy`` (a TrainablePSF
    mask), returned as the third element; the forward takes the PSF."""
    psf, data = _problem(seed=7, batch=1)
    model = TrainableRecon(camera_inversion=SVDeconvNet(K=2, device=CPU),
                           post_process=_unet(), device=CPU)
    variables = _seeded(model, 9, run=(data, psf))
    sd = _reference_sd(model, variables)
    multipsf = sd.pop("camera_inversion.multipsf").numpy()
    config = _config("svdeconvnet", svdeconvnet={"K": 2}, post_process=_unet_cfg())
    config["trainable_mask"] = {"mask_type": "TrainablePSF"}
    path = _write(tmp_path, config, sd)
    np.save(tmp_path / "psf_epochBEST.npy", multipsf)
    out, tl = _port_forward(path, data, psf)
    ref, jl = _jax_forward(path, variables, data, psf)
    assert _rel(out, ref) <= TOL_RECON
    np.testing.assert_array_equal(tl[2], jl[3])
    np.testing.assert_array_equal(tl[0].camera_inversion.multipsf.detach().numpy(), multipsf)


def test_load_noisy_psf_override(tmp_path):
    """``files.psf_snr`` with ``psf.pt``: the noisy PSF is returned and the
    forward on it matches JAX's."""
    psf, data = _problem(seed=8)
    noisy = (psf * (1 + 0.05 * np.random.RandomState(9).randn(*psf.shape))).astype(np.float32)
    model = _pre_post_model()
    variables = _seeded(model, 10)
    config = {**PRE_POST, "files": {"downsample": 1, "psf_snr": 10}}
    path = _write(tmp_path, config, _reference_sd(model, variables))
    torch.save(torch.from_numpy(noisy), tmp_path / "psf.pt")
    tl = tzoo.load_model(path, device=CPU)
    jl = jzoo.load_model(path)
    np.testing.assert_array_equal(tl[2], noisy)
    np.testing.assert_array_equal(tl[2], jl[3])
    out, _ = _port_forward(path, data, tl[2])
    ref, _ = _jax_forward(path, variables, data, jl[3])
    assert _rel(out, ref) <= TOL_RECON


# --- the checkpoint's files ----------------------------------------------------------

def test_data_parallel_prefix_and_best_decoy(tmp_path):
    """``module.`` prefixes on every key, ``recon_epochBEST`` chosen over a
    decoy ``recon_epoch3`` of other weights; both packages load the same
    model."""
    psf, data = _problem(seed=9)
    model = _pre_post_model()
    variables = _seeded(model, 11)
    sd = _reference_sd(model, variables)
    path = _write(tmp_path, PRE_POST, {f"module.{k}": v for k, v in sd.items()})
    _write(tmp_path, PRE_POST, _reference_sd(model, _seeded(model, 12)), "recon_epoch3")
    out, _ = _port_forward(path, data, psf)
    ref, _ = _jax_forward(path, variables, data, psf)
    assert _rel(out, ref) <= TOL_RECON
    assert tzoo.remove_data_parallel({"module.a.module.b": 1, "c": 2}) == \
        jzoo.remove_data_parallel({"module.a.module.b": 1, "c": 2}) == {"a.b": 1, "c": 2}


def test_last_checkpoint_in_sorted_order(tmp_path):
    """Without BEST the last of ``sorted()``: recon_epoch3 after
    recon_epoch10, as the JAX package takes it."""
    model = _pre_post_model()
    sds = {name: _reference_sd(model, _seeded(model, seed))
           for name, seed in (("recon_epoch10", 13), ("recon_epoch3", 14))}
    for name, sd in sds.items():
        path = _write(tmp_path, PRE_POST, sd, name)
    loaded = tzoo.load_model(path, device=CPU)[0]
    want = sds["recon_epoch3"]["post_process_model.m_tail.weight"]
    torch.testing.assert_close(loaded.post_process_model.m_tail.weight.detach(), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(loaded.camera_inversion._mu1_p.detach(),
                               sds["recon_epoch3"]["_mu1_p"], rtol=0, atol=0)


def test_strict_load_raises(tmp_path):
    """A wrong shape or an unknown key in a component raises; a component
    the checkpoint lacks keeps its initial values."""
    model = _pre_post_model()
    sd = _reference_sd(model, _seeded(model, 15))
    bad = dict(sd)
    bad["post_process_model.m_tail.weight"] = bad["post_process_model.m_tail.weight"][:, :2]
    with pytest.raises(RuntimeError, match="post_process"):
        tzoo.load_model(_write(tmp_path / "shape", PRE_POST, bad), device=CPU)
    extra = {**sd, "pre_process_model.m_extra.weight": torch.zeros(1)}
    with pytest.raises(RuntimeError, match="pre_process"):
        tzoo.load_model(_write(tmp_path / "extra", PRE_POST, extra), device=CPU)
    lacking = {k: v for k, v in sd.items() if not k.startswith("pre_process")}
    loaded = tzoo.load_model(_write(tmp_path / "lacking", PRE_POST, lacking), device=CPU)[0]
    torch.testing.assert_close(loaded.pre_process_param.detach(), torch.ones(1))
    torch.testing.assert_close(loaded.post_process_param.detach(),
                               sd["post_process_param"], rtol=0, atol=0)


def test_load_model_defaults_to_the_card(tmp_path, monkeypatch):
    model = _pre_post_model()
    path = _write(tmp_path, PRE_POST, _reference_sd(model, _seeded(model, 16)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.load_model(path)
    with pytest.raises(FileNotFoundError, match="config"):
        tzoo.load_model(str(tmp_path / "nowhere"), device=CPU)


def test_download_model_needs_the_network(monkeypatch):
    """The download goes through ``huggingface_hub`` as in the JAX package:
    without the package both raise ImportError (the call itself is held to
    JAX's in tests/test_torch_hub_datasets.py)."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for zoo in (tzoo, jzoo):
        with pytest.raises(ImportError):
            zoo.download_model("diffusercam", "mirflickr", "U20")
