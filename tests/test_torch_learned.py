"""The port's learned solvers and compositions against the JAX package's on
the CPU: ``FFTConvolver.convolve_fft`` / ``with_filter``, UnrolledADMM and
UnrolledFISTA (at init, with non-constant schedules, with intermediates),
UnrolledADMM at constant schedules against the port's classical ADMM,
TrainableInversion, SVDeconvNet, TrainableRecon in each branch of its
forward, ``build_model`` for one name of each family of
``parse_model_name``, the gradient through a PSF network, and the public
names.

Weights go into both packages as JAX-layout numpy trees (the port takes
them through ``convert.state_dict``); inputs come from numpy with a fixed
seed.  Tolerances are max |port - JAX| / max |JAX|:

- the unrolled solvers, the inversions and the convolver: 1e-5;
- TrainableRecon and ``build_model`` (networks inside): 1e-4.
"""

import functools
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lenslesspicam_tpu as jlpt
from lenslesspicam_tpu.models import background as jbg
from lenslesspicam_tpu.models import compensation as jcomp
from lenslesspicam_tpu.models import inversion as jinv
from lenslesspicam_tpu.models import trainable_recon as jtr
from lenslesspicam_tpu.models import unet as junet
from lenslesspicam_tpu.models import unrolled as junr
from lenslesspicam_tpu.zoo import model_dict as jzoo

import lenslesspicam_tpu_torch as tlpt
from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.models import background as tbg
from lenslesspicam_tpu_torch.models import compensation as tcomp
from lenslesspicam_tpu_torch.models import inversion as tinv
from lenslesspicam_tpu_torch.models import multi_wiener as tmw
from lenslesspicam_tpu_torch.models import restormer as trest
from lenslesspicam_tpu_torch.models import trainable_recon as ttr
from lenslesspicam_tpu_torch.models import unet as tunet
from lenslesspicam_tpu_torch.models import unrolled as tunr
from lenslesspicam_tpu_torch.ops import fft_conv as tfft
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.zoo import model_dict as tzoo

from test_torch_scripts import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = "cpu"
TOL_SOLVER = 1e-5
TOL_RECON = 1e-4
SMALL_NC = (4, 8, 16, 32)          # tests/test_models.py:17
SHAPE = (1, 32, 40, 3)


def _problem(shape=SHAPE, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    return psf, rng.rand(batch, *shape).astype(np.float32)


def _rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))

def _apply(jmodel, variables, *args, **static):
    """``jmodel.apply`` under ``jax.jit``, the keyword arguments bound: one
    compile of the model takes 2-6x less time on the CPU than flax's eager
    dispatch, which compiles each op of a new shape on its own.  Each model
    runs once, so XLA's backend optimisation, which takes half the compile
    time, is turned off (the result moves by about 1e-6 of its max)."""
    fn = jax.jit(functools.partial(jmodel.apply, **static))
    return fn.lower(variables, *args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(variables, *args)



def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_tree(jmodel, *args, **kwargs):
    """flax's variable tree of ``jmodel`` (paths and shapes) under
    ``jax.eval_shape``: no initializer runs."""
    return jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args, **kwargs))


def _perturbed(variables, seed):
    """Each leaf times a uniform factor in [0.5, 1.5]: schedules that change
    from one iteration to the next."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * rng.uniform(0.5, 1.5, np.shape(a))).astype(np.float32),
        variables)


def _carried(jmodel, tmodel, args, seed=1, kwargs=None):
    """Seeded JAX-layout variables for both, checked against flax's tree."""
    ref = _jax_tree(jmodel, *args, **(kwargs or {}))
    variables = convert.random_variables(tmodel, seed)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), variables)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    tmodel.load_state_dict(convert.state_dict(tmodel, variables))
    return variables


# --- module 1: the convolver --------------------------------------------------------

def test_convolve_fft_and_with_filter_match_jax():
    psf, data = _problem(seed=1)
    jc = jlpt.make_convolver(psf, pad=True, norm="ortho")
    tc = tfft.make_convolver(psf, pad=True, norm="ortho", device=CPU)
    assert _rel(tc.convolve_fft(_t(data)), jc.convolve_fft(jnp.asarray(data))) <= TOL_SOLVER
    wiener = np.asarray(jnp.conj(jc.H) / (jnp.abs(jc.H) ** 2 + 1e-2))
    out = tc.with_filter(_t(wiener)).convolve(_t(data))
    assert tc.with_filter(_t(wiener)).padded_shape == tc.padded_shape
    assert _rel(out, jc.with_filter(jnp.asarray(wiener)).convolve(jnp.asarray(data))) <= TOL_SOLVER


# --- module 3: the unrolled solvers ------------------------------------------------

@pytest.mark.parametrize("solver", ["admm", "fista"])
@pytest.mark.parametrize("schedules", ["init", "random"])
def test_unrolled_matches_jax(solver, schedules):
    psf, data = _problem(seed=2)
    if solver == "admm":
        jm, tm = junr.UnrolledADMM(n_iter=5), tunr.UnrolledADMM(device=CPU, n_iter=5)
        jc = junr.UnrolledADMM.make_convolver(psf)
        tc = tunr.UnrolledADMM.make_convolver(psf, device=CPU)
    else:
        jm, tm = junr.UnrolledFISTA(n_iter=5), tunr.UnrolledFISTA(device=CPU, n_iter=5)
        jc = junr.UnrolledFISTA.make_convolver(psf)
        tc = tunr.UnrolledFISTA.make_convolver(psf, device=CPU)
    jd, jp = jnp.asarray(data), jnp.asarray(psf)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                                        jc, jd, jp))
    if schedules == "random":
        variables = _perturbed(variables, seed=3)
    tm.load_state_dict(convert.state_dict(tm, variables))
    ref, ref_inters = _apply(jm, variables, jc, jd, jp, return_intermediates=True)
    with torch.no_grad():
        out, inters = tm(tc, _t(data), _t(psf), return_intermediates=True)
        plain = tm(tc, _t(data), _t(psf))
    assert _rel(out, ref) <= TOL_SOLVER and torch.equal(plain, out)
    assert len(inters) == len(ref_inters) == 4
    assert max(_rel(a, b) for a, b in zip(inters, ref_inters)) <= TOL_SOLVER


def test_unrolled_fista_makes_its_steps_on_the_first_call():
    psf, data = _problem(seed=4)
    tc = tunr.UnrolledFISTA.make_convolver(psf, device=CPU)
    tm = tunr.UnrolledFISTA(device=CPU, n_iter=3, lip_fact=1.5)
    assert tm._alpha_p is None
    with torch.inference_mode():
        tm(tc, _t(data), _t(psf))
    ref = 1.5 / tc.mag_sq().reshape(-1, 3).amax(dim=0)
    assert isinstance(tm._alpha_p, torch.nn.Parameter)
    assert torch.equal(tm._alpha_p.detach(), ref.expand(3, 3))
    fresh = tunr.UnrolledFISTA(device=CPU, n_iter=3)
    fresh.load_state_dict(tm.state_dict())
    assert torch.equal(fresh._alpha_p, tm._alpha_p)


def test_unrolled_admm_constant_schedules_match_classical_admm():
    """tests/test_unrolled.py:21-33, in the port: the unrolled forward at the
    classical defaults is n_iter of the port's exact ADMM."""
    psf, data = _problem(batch=1, seed=5)
    tm = tunr.UnrolledADMM(device=CPU, n_iter=5, learn_params=False)
    with torch.no_grad():
        out = tm(tunr.UnrolledADMM.make_convolver(psf, device=CPU), _t(data))
    ref = tadmm.run(tadmm.make_convolver(psf, device=CPU), data, n_iter=5)
    assert _rel(out, ref) <= TOL_SOLVER
    assert set(dict(tm.named_buffers())) == {"_mu1_p", "_mu2_p", "_mu3_p", "_tau_p"}
    assert not list(tm.parameters())


def test_unrolled_admm_remat_matches_and_flows_gradients():
    psf, data = _problem(seed=6)
    tc = tunr.UnrolledADMM.make_convolver(psf, device=CPU)
    outs, grads = [], []
    for remat in (False, True):
        tm = tunr.UnrolledADMM(device=CPU, n_iter=3, remat=remat)
        out = tm(tc, _t(data))
        out.square().mean().backward()
        outs.append(out.detach())
        grads.append(tm._mu2_p.grad.clone())
    assert torch.equal(outs[0], outs[1])
    assert torch.allclose(grads[0], grads[1]) and bool(grads[0].abs().sum() > 0)


# --- module 4: the one-shot inversions ---------------------------------------------

def _carried_inversion(jm, tm, jc, jd, jp):
    ref = _jax_tree(jm, jc, jd, jp)
    variables = convert.to_variables(tm)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), variables) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    return variables


@pytest.mark.parametrize("learn", [True, False])
def test_inversions_match_jax(learn):
    psf, data = _problem(seed=7)
    jc = jinv.TrainableInversion.make_convolver(psf)
    tc = tinv.TrainableInversion.make_convolver(psf, device=CPU)
    jd, jp = jnp.asarray(data), jnp.asarray(psf)
    with torch.no_grad():
        out = tinv.TrainableInversion(K=1e-3)(tc, _t(data))
    assert _rel(out, _apply(jinv.TrainableInversion(K=1e-3), {}, jc, jd)) <= TOL_SOLVER

    jm = jinv.SVDeconvNet(K=2, learn_multipsf=learn)
    tm = tinv.SVDeconvNet(device=CPU, K=2, learn_multipsf=learn)
    variables = {}
    if learn:
        with torch.no_grad():
            tm(tc, _t(data), _t(psf))       # tiles the PSF into multipsf
        assert tm.multipsf.shape == (4, 32, 40, 3)
        variables = _perturbed(_carried_inversion(jm, tm, jc, jd, jp), seed=8)
        tm.load_state_dict(convert.state_dict(tm, variables))
    with torch.no_grad():
        out = tm(tc, _t(data), _t(psf))
    assert _rel(out, _apply(jm, variables, jc, jd, jp)) <= TOL_SOLVER
    np.testing.assert_array_equal(tinv.compute_weight_matrices((32, 40), 3),
                                  jinv.compute_weight_matrices((32, 40), 3))


# --- module 9: TrainableRecon in every branch ---------------------------------------

def _unetres(jax_side, **kw):
    if jax_side:
        return junet.UNetRes(out_nc=3, nc=SMALL_NC, nb=1, **kw)
    comp = kw.pop("concatenate_compensation", False)
    return tunet.UNetRes(device=CPU, in_nc=4, out_nc=3, nc=SMALL_NC, nb=1,
                         concatenate_compensation=comp and 16, **kw)


def _recon(case, j):
    """The JAX (j) or port composition for a branch of TrainableRecon's forward."""
    unr = junr if j else tunr
    dev = {} if j else {"device": CPU}
    if case in ("admm", "fista"):
        inv = (unr.UnrolledADMM(n_iter=3, **dev) if case == "admm" else
               unr.UnrolledFISTA(n_iter=3, **dev))
        kw = dict(camera_inversion=inv, pre_process=_unetres(j), post_process=_unetres(j))
    elif case == "psf_network":
        kw = dict(camera_inversion=unr.UnrolledADMM(n_iter=2, **dev), psf_network=_unetres(j))
    elif case == "direct_background":
        kw = dict(camera_inversion=unr.UnrolledADMM(n_iter=2, **dev),
                  direct_background_subtraction=True)
    elif case == "learned_background":
        kw = dict(camera_inversion=unr.UnrolledADMM(n_iter=2, **dev),
                  background_network=_unetres(j), post_process=_unetres(j))
    elif case == "compensation":
        comp = (jcomp if j else tcomp).CompensationBranch(nc=(4, 8, 16), **dev)
        kw = dict(camera_inversion=unr.UnrolledADMM(n_iter=3, **dev), compensation_branch=comp,
                  post_process=_unetres(j, concatenate_compensation=True))
    elif case == "per_sample_psfs":
        kw = dict(camera_inversion=unr.UnrolledADMM(n_iter=2, **dev), return_intermediate=True)
    elif case == "integrated_background":
        pre = (jbg.IntegratedBackgroundSub(nc=SMALL_NC, nb=1) if j else
               tbg.IntegratedBackgroundSub(device=CPU, in_nc=4, nc=SMALL_NC, nb=1))
        kw = dict(camera_inversion=unr.UnrolledADMM(n_iter=2, **dev), pre_process=pre,
                  integrated_background_subtraction=True)
    return (jtr if j else ttr).TrainableRecon(**kw, **dev)


RECON_CASES = ["admm", "fista", "psf_network", "direct_background", "learned_background",
               "compensation", "per_sample_psfs", "integrated_background"]


@pytest.mark.parametrize("case", RECON_CASES)
def test_trainable_recon_matches_jax(case):
    psf, data = _problem(seed=9)
    if case == "per_sample_psfs":
        psf = np.stack([psf, psf * 1.1])          # (B, D, H, W, C)
    bg = (np.random.RandomState(10).rand(*data.shape) * 0.2).astype(np.float32)
    kw = {"background": bg} if "background" in case else {}
    jm, tm = _recon(case, True), _recon(case, False)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    if case == "fista":        # the step sizes are made on the first call
        with torch.no_grad():
            tm.to(CPU)(data, psf, **kw)
    variables = _carried(jm, tm, (jnp.asarray(data), jnp.asarray(psf)), kwargs=jkw)
    ref = _apply(jm, variables, jnp.asarray(data), jnp.asarray(psf), **jkw)
    with torch.no_grad():
        out = tm.eval()(_t(data), _t(psf), **{k: _t(v) for k, v in kw.items()})
    if case == "per_sample_psfs":   # (final, unrolled, pre-processed, psf)
        assert len(out) == len(ref) == 4
        assert max(_rel(a, b) for a, b in zip(out, ref)) <= TOL_RECON
    else:
        assert _rel(out, ref) <= TOL_RECON


def test_trainable_recon_psf_network_grads():
    """tests/test_models.py:116-130 in the port: a finite loss and a non-zero
    gradient through the PSF network, the convolver and the unrolled solver."""
    psf, data = _problem(seed=11)
    target = _t(np.random.RandomState(7).rand(*data.shape).astype(np.float32))
    tm = _recon("psf_network", False).to(CPU)
    loss = torch.mean((tm(_t(data), _t(psf)) - target) ** 2)
    loss.backward()
    grads = [p.grad for p in tm.parameters()]
    assert torch.isfinite(loss) and all(g is not None for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0
    assert float(tm.psf_network_model.m_head.weight.grad.abs().sum()) > 0


def test_trainable_recon_state_dict_round_trip_through_jax_loader():
    """A whole TrainableRecon's state dict mapped back by the JAX package's
    zoo loader pieces (model_dict._convert_processor, convert.py's
    torch_unrolled_admm_params / torch_compensation_to_flax): equal."""
    from lenslesspicam_tpu.zoo import convert as jconv

    tm = ttr.TrainableRecon(camera_inversion=tunr.UnrolledADMM(n_iter=3, device=CPU),
                            pre_process=_unetres(False),
                            post_process=_unetres(False, concatenate_compensation=True),
                            compensation_branch=tcomp.CompensationBranch(nc=(4, 8, 16),
                                                                         device=CPU),
                            device=CPU)
    variables = convert.random_variables(tm, seed=12)
    sd = {k: v.numpy() for k, v in convert.state_dict(tm, variables).items()}
    tm.load_state_dict(convert.state_dict(tm, variables))
    params = {"camera_inversion": jconv.torch_unrolled_admm_params(
        {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith("camera_inversion.")}
    )["params"]}
    for prefix, name, block, param in (("pre_process_model.", "pre_process", "pre_block",
                                        "pre_process_param"),
                                       ("post_process_model.", "post_process", "post_block",
                                        "post_process_param")):
        net, noise = jzoo._convert_processor(sd, prefix, "unetres", 1, param)
        params[name], params[block] = net, {"noise_level": noise}
    comp = jconv.torch_compensation_to_flax(
        {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith("compensation_branch.")},
        (4, 8, 16))
    params["compensation_branch"] = comp["params"]
    back = {"params": params, "batch_stats": {"compensation_branch": comp["batch_stats"]}}
    leaves = jax.tree_util.tree_leaves
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    assert all(np.array_equal(a, b) for a, b in zip(leaves(back), leaves(variables)))
    assert all(np.array_equal(a, b) for a, b in zip(leaves(convert.to_variables(tm)),
                                                     leaves(variables)))


# --- module 10: the zoo's build_model ----------------------------------------------

# one name of each family of parse_model_name: unrolled ADMM alone, the
# trainable inversion, pre + ADMM + post with the PSF network, SVDeconvNet,
# MWDN, MMCN, a Restormer ("Transformer") processor, DRUNet, and the
# lowercase digicam grammar (pre / post, post only)
BUILD_NAMES = ["U5", "TrainInv+Unet2", "Unet2+U3+Unet2_psfNN", "SVDecon+Unet2", "MWDN8M",
               "MMCN2M+Unet2", "Transformer4M+U3", "U3+Drunet", "pre2_unrolled_admm3_post2",
               "unet2"]


@pytest.mark.parametrize("name", BUILD_NAMES)
def test_build_model_matches_jax(name):
    rng = np.random.RandomState(13)
    ch = 1 if name.startswith("MWDN") else 3    # MWDN's default PSF has one channel
    psf = rng.rand(1, 24, 32, ch).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(1, 1, 24, 32, 3).astype(np.float32)
    assert tzoo.parse_model_name(name) == jzoo.parse_model_name(name)
    tm = tzoo.build_model(name, nb=1, device=CPU).eval()
    jm = jzoo.build_model(name, nb=1)
    if name.startswith("SVDecon"):
        with torch.no_grad():
            tm(data, psf)
    variables = _carried(jm, tm, (jnp.asarray(data), jnp.asarray(psf)), seed=14)
    with torch.no_grad():
        out = tm(data, psf)
    assert out.device.type == CPU
    assert _rel(out, _apply(jm, variables, jnp.asarray(data), jnp.asarray(psf))) <= TOL_RECON


def test_build_model_refuses_baselines_and_loaders():
    with pytest.raises(ValueError, match="classical baseline"):
        tzoo.build_model("admm_pnp", device=CPU)
    with mock.patch.dict(sys.modules, {"huggingface_hub": None}), pytest.raises(ImportError):
        tzoo.download_model("diffusercam", "mirflickr", "U20")
    with pytest.raises(FileNotFoundError, match="config"):
        tzoo.load_model("some/checkpoint", device=CPU)
    assert tzoo.model_dict == jzoo.model_dict and tzoo._UNET_NC == jzoo._UNET_NC


def test_build_model_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.build_model("U5")


# --- module 12: the public names ----------------------------------------------------

def test_public_model_names_resolve_to_the_port():
    lazy = {"TrainableRecon": ttr.TrainableRecon,
            "TrainableReconstructionAlgorithm": ttr.TrainableRecon,
            "UnrolledADMM": tunr.UnrolledADMM, "UnrolledFISTA": tunr.UnrolledFISTA,
            "TrainableInversion": tinv.TrainableInversion, "SVDeconvNet": tinv.SVDeconvNet,
            "MultiWiener": None, "UNetRes": tunet.UNetRes, "Restormer": None}
    for name, cls in lazy.items():
        obj = getattr(tlpt, name)
        assert hasattr(jlpt, name) and issubclass(obj, torch.nn.Module)
        assert cls is None or obj is cls


# --- devices: the card unless the CPU is asked for, no copy across devices --------

def _model_makers():
    return {
        "UNetRes": lambda **d: tunet.UNetRes(nc=SMALL_NC, nb=1, **d),
        "UNet": lambda **d: tunet.UNet(nc=SMALL_NC, nb=1, **d),
        "UnrolledADMM": lambda **d: tunr.UnrolledADMM(n_iter=2, **d),
        "UnrolledFISTA": lambda **d: tunr.UnrolledFISTA(n_iter=2, **d),
        "SVDeconvNet": lambda **d: tinv.SVDeconvNet(K=2, **d),
        "MultiWiener": lambda **d: tmw.MultiWiener(nc=(4, 8, 16), **d),
        "CompensationBranch": lambda **d: tcomp.CompensationBranch(nc=(4, 8), **d),
        "IntegratedBackgroundSub": lambda **d: tbg.IntegratedBackgroundSub(nc=SMALL_NC, nb=1,
                                                                          **d),
        "Restormer": lambda **d: trest.Restormer(dim=8, num_blocks=(1, 1, 1, 1),
                                                 num_refinement_blocks=1, heads=(1, 1, 1, 1),
                                                 **d),
        "TrainableRecon": lambda **d: ttr.TrainableRecon(
            camera_inversion=tinv.TrainableInversion(), **d),
    }


@pytest.mark.parametrize("name", list(_model_makers()))
def test_models_refuse_the_cpu_unless_asked(name, monkeypatch):
    make = _model_makers()[name]
    assert all(t.device.type == CPU for t in make(device=CPU).state_dict().values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


@pytest.mark.parametrize("case", ["TrainableRecon", "MultiWiener", "UnrolledADMM",
                                  "UnrolledFISTA", "TrainableInversion", "SVDeconvNet",
                                  "drunet_denoise", "convolver"])
def test_models_refuse_a_tensor_on_another_device(case):
    """A module on the CPU fed a tensor that lies elsewhere (a meta tensor
    stands in for one on the card) raises, as a PyTorch layer does: the
    input is never copied over to the module's device.  So does a module
    whose convolver lies on another device than its own."""
    psf, data = _problem(seed=15)
    other = torch.empty(data.shape, device="meta")
    tc = tunr.UnrolledADMM.make_convolver(psf, device=CPU)
    calls = {
        "TrainableRecon": lambda: _recon("admm", False)(other, psf),
        "MultiWiener": lambda: tmw.MultiWiener(nc=(4, 8, 16), psf_channels=3,
                                               device=CPU)(other, psf),
        "UnrolledADMM": lambda: tunr.UnrolledADMM(n_iter=2, device=CPU)(tc, other),
        "UnrolledFISTA": lambda: tunr.UnrolledFISTA(n_iter=2, device=CPU)(tc, other, psf),
        "TrainableInversion": lambda: tinv.TrainableInversion()(tc, other),
        "SVDeconvNet": lambda: tinv.SVDeconvNet(K=2, device=CPU)(tc, other, psf),
        "drunet_denoise": lambda: tunet.drunet_denoise(
            tunet.UNetRes(nc=SMALL_NC, nb=1, device=CPU), other[:, 0], 10),
        "convolver": lambda: tunr.UnrolledADMM(n_iter=2, device="meta")(tc, data),
    }
    with pytest.raises(RuntimeError, match="expected a tensor on (cpu|meta), got one on"):
        calls[case]()
