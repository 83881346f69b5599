"""The port's networks against the JAX package's on the CPU: UNetRes
(plain, background subtraction, compensation concat), UNet, MultiWiener,
CompensationBranch, IntegratedBackgroundSub and Restormer at the narrow
widths of tests/test_models.py, drunet_denoise at an odd size, the two
resizes, and the weight conversion both ways.

Each JAX model's variable tree comes from flax's own ``init`` under
``jax.eval_shape`` (paths and shapes, no initializer runs); the port's ``convert.random_variables`` must give the same
tree, and those seeded variables go into both packages
(``convert.state_dict`` for the port).  Inputs come from numpy with a
fixed seed.  Tolerances are max |port - JAX| / max |JAX|:

- the networks and drunet_denoise: 1e-4;
- ``bilinear_align_corners`` against ``F.interpolate(align_corners=True)``: 1e-6;
- the compensation resize against ``jax.image.resize(method="bilinear")``: 1e-5;
- the state dicts through the JAX package's ``zoo/convert.py`` converters
  and back: equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lenslesspicam_tpu.models import background as jbg
from lenslesspicam_tpu.models import compensation as jcomp
from lenslesspicam_tpu.models import multi_wiener as jmw
from lenslesspicam_tpu.models import restormer as jrest
from lenslesspicam_tpu.models import unet as junet
from lenslesspicam_tpu.zoo import convert as jconv

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.models import background as tbg
from lenslesspicam_tpu_torch.models import compensation as tcomp
from lenslesspicam_tpu_torch.models import multi_wiener as tmw
from lenslesspicam_tpu_torch.models import restormer as trest
from lenslesspicam_tpu_torch.models import unet as tunet

TOL_NET = 1e-4
TOL_ALIGN = 1e-6
TOL_RESIZE = 1e-5
SMALL_NC = (4, 8, 16, 32)          # tests/test_models.py:17
MW_NC = (4, 8, 16, 16, 16)
COMP_NC = (4, 8, 16)
REST = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 1, 1, 1))


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



def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def _carry(jmodel, tmodel, init_args, seed=1, init_kwargs=None):
    """Seeded variables in the flax layout (``convert.random_variables``),
    checked against flax's own tree for ``jmodel``, loaded into ``tmodel``;
    returns them."""
    ref = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *init_args,
                                             **(init_kwargs or {})))
    variables = convert.random_variables(tmodel, seed)
    assert _shapes(variables) == _shapes(ref)
    tmodel.load_state_dict(convert.state_dict(tmodel, variables))
    tmodel.eval()
    return variables


def _equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    return all(np.array_equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                                    jax.tree_util.tree_leaves(b)))


# --- module 2: UNetRes, UNet, drunet_denoise --------------------------------------

@pytest.mark.parametrize("variant", ["plain", "background_subtraction",
                                     "concatenate_compensation"])
def test_unetres_matches_jax(variant):
    x = _rand(2, 32, 40, 4, seed=2)
    kw = {variant: True} if variant != "plain" else {}
    jm = junet.UNetRes(out_nc=3, nc=SMALL_NC, nb=1, **kw)
    jkw, tkw = {}, {}
    if variant == "background_subtraction":
        bg = _rand(2, 32, 40, 4, seed=3)
        jkw, tkw = {"background": jnp.asarray(bg)}, {"background": _nchw(bg)}
        tm = tunet.UNetRes(device="cpu", in_nc=4, out_nc=3, nc=SMALL_NC, nb=1,
                           background_subtraction=True)
    elif variant == "concatenate_compensation":
        comp = _rand(2, 9, 11, 16, seed=3)     # resized down to the 4 x 5 bottleneck
        jkw, tkw = {"compensation_output": jnp.asarray(comp)}, {"compensation_output": _nchw(comp)}
        tm = tunet.UNetRes(device="cpu", in_nc=4, out_nc=3, nc=SMALL_NC, nb=1,
                           concatenate_compensation=16)
    else:
        tm = tunet.UNetRes(device="cpu", in_nc=4, out_nc=3, nc=SMALL_NC, nb=1)
    v = _carry(jm, tm, (jnp.asarray(x),), init_kwargs=jkw)
    ref = _apply(jm, v, jnp.asarray(x), **jkw)
    with torch.no_grad():
        out = tm(_nchw(x), **tkw)
    assert _rel(_nhwc(out), ref) <= TOL_NET


def test_unet_matches_jax():
    x = _rand(2, 32, 40, 3, seed=4)
    jm = junet.UNet(out_nc=3, nc=SMALL_NC, nb=1)
    tm = tunet.UNet(device="cpu", in_nc=3, out_nc=3, nc=SMALL_NC, nb=1)
    v = _carry(jm, tm, (jnp.asarray(x),))
    with torch.no_grad():
        assert _rel(_nhwc(tm(_nchw(x))), _apply(jm, v, jnp.asarray(x))) <= TOL_NET


def test_drunet_denoise_odd_size_matches_jax():
    img = _rand(1, 33, 27, 3, seed=5)
    jm = junet.UNetRes(out_nc=3, nc=SMALL_NC, nb=1)
    tm = tunet.UNetRes(device="cpu", in_nc=4, out_nc=3, nc=SMALL_NC, nb=1)
    v = _carry(jm, tm, (jnp.zeros((1, 40, 32, 4)),))
    # always a full pad: 33 x 27 -> 40 x 32
    assert tunet.pad_centered_multiple(torch.zeros(1, 33, 27, 3))[0].shape == (1, 40, 32, 3)
    ref = junet.drunet_denoise(jm, v, jnp.asarray(img), noise_level=10)
    with torch.no_grad():
        out = tunet.drunet_denoise(tm, torch.from_numpy(img), 10)
    assert _rel(out, ref) <= TOL_NET


def test_load_drunet_takes_a_dpir_checkpoint(tmp_path):
    """A DPIR-layout checkpoint (UNetRes's keys) loads straight into the
    port's UNetRes, on the device asked for, in eval mode."""
    src = tunet.UNetRes(device="cpu", in_nc=4, out_nc=3, nc=SMALL_NC, nb=1)
    torch.save(src.state_dict(), tmp_path / "drunet.pth")
    model = tunet.load_drunet(tmp_path / "drunet.pth", nc=SMALL_NC, nb=1, device="cpu")
    assert not model.training
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("src,dst", [((4, 5), (9, 15)), ((9, 15), (4, 5)), ((7, 6), (3, 11))])
def test_compensation_resize_matches_jax_image(src, dst):
    x = _rand(2, *src, 6, seed=6)
    ref = jax.image.resize(jnp.asarray(x), (2, *dst, 6), method="bilinear")
    assert _rel(_nhwc(tunet.resize_bilinear(_nchw(x), dst)), ref) <= TOL_RESIZE


# --- modules 5-8: MultiWiener, CompensationBranch, IntegratedBackgroundSub, Restormer ---

@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((4, 6), (9, 13)), ((1, 3), (2, 6))])
def test_bilinear_align_corners_matches_jax(src, dst):
    x = _rand(2, *src, 3, seed=7)
    ref = jmw.bilinear_align_corners(jnp.asarray(x), *dst)
    assert _rel(_nhwc(tmw.bilinear_align_corners(_nchw(x), *dst)), ref) <= TOL_ALIGN


def test_multi_wiener_matches_jax():
    rng = np.random.RandomState(8)
    psf = rng.rand(1, 32, 40, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(2, 1, 32, 40, 3).astype(np.float32)
    jm = jmw.MultiWiener(in_channels=3, out_channels=3, psf_channels=3, nc=MW_NC)
    tm = tmw.MultiWiener(device="cpu", in_channels=3, out_channels=3, psf_channels=3, nc=MW_NC)
    v = _carry(jm, tm, (jnp.asarray(data), jnp.asarray(psf)))
    assert set(v) == {"params", "batch_stats"}
    with torch.no_grad():
        out = tm(torch.from_numpy(data), torch.from_numpy(psf))
    assert _rel(out, _apply(jm, v, jnp.asarray(data), jnp.asarray(psf))) <= TOL_NET


@pytest.mark.parametrize("residual", [True, False])
def test_compensation_branch_matches_jax(residual):
    inputs = [_rand(2, 1, 32, 40, 3, seed=9 + k) for k in range(len(COMP_NC))]
    jm = jcomp.CompensationBranch(nc=COMP_NC, residual=residual)
    tm = tcomp.CompensationBranch(device="cpu", nc=COMP_NC, in_channels=3, residual=residual)
    v = _carry(jm, tm, ([jnp.asarray(x) for x in inputs],))
    with torch.no_grad():
        out = tm([torch.from_numpy(x) for x in inputs])
    assert out.shape == (2, COMP_NC[-1], 4, 5)
    assert _rel(_nhwc(out), _apply(jm, v, [jnp.asarray(x) for x in inputs])) <= TOL_NET


def test_integrated_background_sub_matches_jax():
    x, bg = _rand(2, 32, 40, 4, seed=12), _rand(2, 32, 40, 4, seed=13)
    jm = jbg.IntegratedBackgroundSub(nc=SMALL_NC, nb=1)
    tm = tbg.IntegratedBackgroundSub(device="cpu", in_nc=4, nc=SMALL_NC, nb=1)
    v = _carry(jm, tm, (jnp.asarray(x),), init_kwargs={"background": jnp.asarray(bg)})
    with torch.no_grad():
        out = tm(_nchw(x), background=_nchw(bg))
    assert _rel(_nhwc(out), _apply(jm, v, jnp.asarray(x), background=jnp.asarray(bg))) <= TOL_NET


@pytest.mark.parametrize("ln_bias", [False, True])
def test_restormer_matches_jax(ln_bias):
    x = _rand(2, 32, 40, 3, seed=14)
    jm = jrest.Restormer(out_channels=3, ln_bias=ln_bias, **REST)
    tm = trest.Restormer(device="cpu", in_channels=3, out_channels=3, ln_bias=ln_bias, **REST)
    v = _carry(jm, tm, (jnp.asarray(x),))
    with torch.no_grad():
        out = tm(_nchw(x))
    assert _rel(_nhwc(out), _apply(jm, v, jnp.asarray(x))) <= TOL_NET
    # the processor wrapper: NDHWC, padded to 8 at the bottom right
    img = _rand(2, 1, 30, 37, 3, seed=15)
    with torch.no_grad():
        out = trest.restormer_fn(tm)(torch.from_numpy(img))
    assert _rel(out, jax.jit(jrest.restormer_fn(jm, v))(jnp.asarray(img))) <= TOL_NET


def test_pixel_shuffles_match_jax():
    x = _rand(2, 8, 6, 12, seed=16)
    down = trest.pixel_unshuffle(_nchw(x))
    assert _rel(_nhwc(down), jrest.pixel_unshuffle(jnp.asarray(x))) == 0
    assert _rel(_nhwc(trest.pixel_shuffle(down)), x) == 0


# --- module 11: the weights, both ways ------------------------------------------------

def _families():
    """(port module, JAX converter of its state dict, kwargs) per family."""
    return {
        "UNetRes": (tunet.UNetRes(device="cpu", in_nc=4, nc=SMALL_NC, nb=2),
                    lambda sd: jconv.torch_unetres_to_flax(sd, nb=2)),
        "UNetRes:background": (
            tunet.UNetRes(device="cpu", in_nc=4, nc=SMALL_NC, nb=2, background_subtraction=True),
            lambda sd: jconv.torch_unetres_to_flax(sd, nb=2)),
        "UNetRes:compensation": (
            tunet.UNetRes(device="cpu", in_nc=4, nc=SMALL_NC, nb=2, concatenate_compensation=True),
            lambda sd: jconv.torch_unetres_to_flax(sd, nb=2)),
        "UNet": (tunet.UNet(device="cpu", nc=SMALL_NC, nb=2),
                 lambda sd: jconv.torch_unet_to_flax(sd, nb=2)),
        "MultiWiener": (tmw.MultiWiener(device="cpu", psf_channels=3, nc=MW_NC),
                        lambda sd: jconv.torch_multiwiener_to_flax(sd, nc=MW_NC)),
        "CompensationBranch": (tcomp.CompensationBranch(device="cpu", nc=COMP_NC),
                               lambda sd: jconv.torch_compensation_to_flax(sd, COMP_NC)),
        "Restormer": (trest.Restormer(device="cpu", ln_bias=True, **REST),
                      jconv.torch_restormer_to_flax),
    }


@pytest.mark.parametrize("family", list(_families()))
def test_state_dict_round_trip_through_jax_converters(family):
    module, to_flax = _families()[family]
    variables = convert.random_variables(module, seed=17)
    sd = convert.state_dict(module, variables)
    module.load_state_dict(sd)                          # strict: every key, no other
    back = to_flax({k: v.numpy() for k, v in module.state_dict().items()})
    assert _equal(back, variables)                      # port -> JAX by zoo/convert.py
    assert _equal(convert.to_variables(module), variables)
    assert all(torch.equal(module.state_dict()[k], v) for k, v in sd.items())
