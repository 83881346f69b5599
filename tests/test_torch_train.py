"""The port's training layer against the JAX package's on the CPU:
``filtered_synthesis``'s hand-written backward against ``jax.vjp``, the
LR schedules, the optimizer chain (Adam, AdamW with its ``ndim > 1`` mask,
global-norm clipping, ``skip_nan``) fed the same gradients as optax, one
``Trainer`` step from carried weights (loss and every gradient, with the
unrolled-output, pre-processor and mask L1 terms), ``train/steps.py``'s
step, the BatchNorm running statistics of a ``train()`` forward against
flax's ``batch_stats``, and the trainer's host side: checkpoints and
resume, the step log, examples, loggers, the composite best metric, extra
and per-batch-PSF evaluation, loss decrease.  The processor schedule
(delay, freeze, unfreeze, ``start_epoch``) is in
``tests/test_torch_train_schedule.py``.

Weights go into both packages as JAX-layout numpy trees
(``convert.state_dict`` for the port); inputs come from numpy with a fixed
seed.  The JAX trainer's model ``init`` is replaced by the carried tree and
its step compiled with XLA's backend optimisation off (a CPU-time saving:
the result moves by about 1e-6 of its max).  To read JAX's gradients, its
optimizer is replaced by a transformation that returns the gradients as
its state and zero updates.  Tolerances, max |port - JAX| / max |JAX| per
leaf:

- ``filtered_synthesis``'s dx and dH: 1e-5 (PyTorch's gradient of a
  complex tensor is the conjugate of JAX's cotangent);
- the LR sequences: 1e-7 of the base lr (the JAX schedule is float32:
  near the end of the cosine, where ``1 + cos`` cancels, it rounds at
  1e-6 of its own value);
- parameters after 5 updates from the same gradients: 1e-6;
- one trainer step: loss 1e-5, gradients 1e-4; after two steps of
  ``train/steps.py``'s step, the parameters 1e-4 (the gradients'
  tolerance: they are computed apart);
- BatchNorm running mean and variance: 1e-6 absolute, the largest
  difference over the whole tree (the statistics are of order 1; the
  unbiased variance of PyTorch's own ``BatchNorm2d`` is off by 9e-4).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lenslesspicam_tpu.models import compensation as jcomp
from lenslesspicam_tpu.models import multi_wiener as jmw
from lenslesspicam_tpu.models.trainable_recon import TrainableRecon as JRecon
from lenslesspicam_tpu.models.unet import UNetRes as JUNetRes
from lenslesspicam_tpu.models.unrolled import UnrolledADMM as JADMM
from lenslesspicam_tpu.hardware import trainable_mask as jtm
from lenslesspicam_tpu.ops import fft_conv as jfft
from lenslesspicam_tpu.train import loggers as jlog
from lenslesspicam_tpu.train import steps as jsteps
from lenslesspicam_tpu.train import trainer as jt

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.hardware import trainable_mask as ttm
from lenslesspicam_tpu_torch.models import compensation as tcomp
from lenslesspicam_tpu_torch.models import multi_wiener as tmw
from lenslesspicam_tpu_torch.models.trainable_recon import TrainableRecon as TRecon
from lenslesspicam_tpu_torch.models.unet import UNetRes as TUNetRes
from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM as TADMM
from lenslesspicam_tpu_torch.ops import fft_conv as tfft
from lenslesspicam_tpu_torch.train import loggers as tlog
from lenslesspicam_tpu_torch.train import steps as tsteps
from lenslesspicam_tpu_torch.train import trainer as tt

CPU = "cpu"
TOL_VJP = 1e-5
TOL_LR = 1e-7
TOL_UPDATE = 1e-6
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_BN = 1e-6
NC = (4, 8, 16, 16)                # tests/test_trainer.py:87-88
SHAPE = (1, 24, 32, 3)             # tests/test_trainer.py:15
O0 = {"xla_backend_optimization_level": 0}


def _rel(out, ref):
    out = out.detach().cpu().resolve_conj().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def as_numpy(t):
    return t.detach().cpu().numpy()


def _max_rel(tree_out, tree_ref):
    errs = jax.tree_util.tree_map(_rel, tree_out, jax.tree_util.tree_map(np.asarray, tree_ref))
    return max(jax.tree_util.tree_leaves(errs))


def _setup(n_batches=3, batch=2, shape=SHAPE, seed=0):
    """tests/test_trainer.py:15-29: measurements simulated through the
    forward model."""
    rng = np.random.RandomState(seed)
    psf = rng.rand(*shape).astype(np.float32)
    psf /= np.linalg.norm(psf)
    conv = jfft.FFTConvolver.from_psf(psf, pad=True, norm="backward")
    batches = []
    for _ in range(n_batches):
        lensed = rng.rand(batch, *shape).astype(np.float32)
        lensless = np.asarray(conv.convolve(jnp.asarray(lensed)))
        batches.append({"lensless": lensless.astype(np.float32), "lensed": lensed})
    return psf, batches


def _models(n_iter=2, processors=True, seed=3, **kw):
    """The JAX and the port's TrainableRecon (UNetRes pre and post at NC, nb
    = 1) and the carried JAX-layout variables, loaded into the port's."""
    procs = (lambda cls, **d: dict(pre_process=cls(out_nc=3, nc=NC, nb=1, **d),
                                   post_process=cls(out_nc=3, nc=NC, nb=1, **d))
             ) if processors else (lambda cls, **d: {})
    jm = JRecon(camera_inversion=JADMM(n_iter=n_iter), **procs(JUNetRes), **kw)
    tm = TRecon(camera_inversion=TADMM(n_iter=n_iter, device=CPU),
                **procs(TUNetRes, device=CPU), device=CPU, **kw)
    variables = convert.random_variables(tm, seed)
    tm.load_state_dict(convert.state_dict(tm, variables))
    return jm, tm, variables


def _compiled(step):
    """``step`` jitted, compiled on its first call with XLA's backend
    optimisation off."""
    cache = {}

    def call(*args):
        if "fn" not in cache:
            cache["fn"] = jax.jit(step).lower(*args).compile(compiler_options=O0)
        return cache["fn"](*args)
    return call


@pytest.fixture
def jax_trainer(monkeypatch):
    """A factory of JAX Trainers whose model init returns the carried
    variables and whose steps compile with the backend optimisation off."""
    monkeypatch.setattr(jt.Trainer, "_rebuild_step", lambda self: setattr(
        self, "_train_step", _compiled(self._build_train_step(
            self._skip_pre, self._skip_post, self._frozen))))

    def make(jm, variables, *args, **kwargs):
        monkeypatch.setattr(type(jm), "init", lambda self, *a, **k: jax.tree_util.tree_map(
            jnp.asarray, variables))
        return jt.Trainer(jm, *args, **kwargs)
    return make


# the gradients as the optimizer's state, zero updates
RECORD = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


# --- ops/fft_conv.py: filtered_synthesis ----------------------------------------------

@pytest.mark.parametrize("ph,pw,h_shape,complex_h", [
    (12, 16, (1, 12, 9, 3), True),      # even width
    (12, 15, (1, 12, 8, 3), True),      # odd width
    (12, 16, (1, 12, 9, 1), False),     # a real filter, broadcast over channels
    (12, 15, (12, 8, 1), True),         # broadcast over batch, depth and channels
])
def test_filtered_synthesis_backward_matches_jax_vjp(ph, pw, h_shape, complex_h):
    rng = np.random.RandomState(ph + pw + len(h_shape))
    x = rng.randn(2, 1, ph, pw, 3).astype(np.float32)
    H = rng.randn(*h_shape).astype(np.float32)
    if complex_h:
        H = (H + 1j * rng.randn(*h_shape)).astype(np.complex64)
    g = rng.randn(2, 1, ph, pw, 3).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jfft.filtered_synthesis(a, b, (ph, pw)),
                     jnp.asarray(x), jnp.asarray(H))
    dx, dH = vjp(jnp.asarray(g))
    xt, Ht = torch.from_numpy(x).requires_grad_(), torch.from_numpy(H).requires_grad_()
    yt = tfft.filtered_synthesis(xt, Ht, (ph, pw))
    yt.backward(torch.from_numpy(g))
    assert _rel(yt, y) <= TOL_VJP
    assert _rel(xt.grad, dx) <= TOL_VJP
    assert Ht.grad.dtype == Ht.dtype
    assert _rel(torch.conj(Ht.grad), dH) <= TOL_VJP
    # the plain form's autograd agrees
    xp, Hp = torch.from_numpy(x).requires_grad_(), torch.from_numpy(H).requires_grad_()
    torch.fft.irfft2(torch.fft.rfft2(xp, dim=(-3, -2)) * Hp, s=(ph, pw), dim=(-3, -2)).backward(
        torch.from_numpy(g))
    assert _rel(xt.grad, xp.grad) <= TOL_VJP and _rel(Ht.grad, Hp.grad) <= TOL_VJP


def test_filtered_synthesis_keeps_the_forward_bits():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 1, 12, 16, 3).astype(np.float32))
    H = torch.from_numpy((rng.randn(1, 12, 9, 3) + 1j * rng.randn(1, 12, 9, 3)).astype(
        np.complex64))
    plain = torch.fft.irfft2(torch.fft.rfft2(x, dim=(-3, -2)) * H, s=(12, 16), dim=(-3, -2))
    assert torch.equal(tfft.filtered_synthesis(x, H, (12, 16)), plain)
    assert torch.equal(tfft.filtered_synthesis(x.requires_grad_(), H, (12, 16)), plain)


# --- train/trainer.py: schedules and the optimizer chain ---------------------------------

SCHEDULES = [dict(), dict(slow_start=0.1), dict(final_lr=1e-5, lr=1e-3, epochs=11),
             dict(exp_decay=0.9), dict(step=2, gamma=0.1), dict(cosine_decay_warmup=True)]


@pytest.mark.parametrize("lr_step_epoch", [True, False])
@pytest.mark.parametrize("kwargs", SCHEDULES, ids=lambda k: "-".join(k) or "constant")
def test_lr_sequence_matches_optax(kwargs, lr_step_epoch):
    """The learning rate of each of 3 epochs x 4 steps, as ``LambdaLR``
    gives it to the optimizer, against the optax schedule at the count
    before each update (cosine warm-up: 0 on the first step)."""
    kwargs = dict(kwargs)
    cfg = dict(lr=kwargs.pop("lr", 1e-3), epochs=kwargs.pop("epochs", 3),
               lr_step_epoch=lr_step_epoch, **kwargs)
    sched = jt.make_lr_schedule(jt.TrainerConfig(**cfg), steps_per_epoch=4)
    tx = tt.TrainOptimizer(tt.TrainerConfig(**cfg), 4, [torch.zeros(2, requires_grad=True)])
    seq = []
    for _ in range(12):
        seq.append(tx.optimizer.param_groups[0]["lr"])
        tx.step([torch.ones(2)])
    ref = np.array([float(sched(k)) for k in range(12)])
    np.testing.assert_allclose(seq, ref, rtol=0, atol=TOL_LR * cfg["lr"])
    assert seq == [tt.make_lr_schedule(tt.TrainerConfig(**cfg), 4)(k) for k in range(12)]


def _grads(rng, scale, nan_at=None):
    """5 steps of gradients of a (3, 4) kernel and a (5,) bias; ``nan_at``:
    the step whose kernel gradient holds a NaN."""
    out = []
    for k in range(5):
        g = {"kernel": (rng.randn(3, 4) * scale[k]).astype(np.float32),
             "bias": (rng.randn(5) * scale[k]).astype(np.float32)}
        if k == nan_at:
            g["kernel"][1, 2] = np.nan
        out.append(g)
    return out


@pytest.mark.parametrize("case", ["adam", "adamw", "clip", "skip_nan"])
def test_updates_match_optax(case):
    """The same gradients into optax's chain and the port's for 5 steps (a
    step-level cosine schedule, so the lr moves): the parameters within
    1e-6.  ``clip``: global norms above and below 1; ``skip_nan``: the
    third gradient holds a NaN, and the update, the moments and the
    schedule's count skip it."""
    rng = np.random.RandomState(["adam", "adamw", "clip", "skip_nan"].index(case))
    cfg = jt.TrainerConfig(lr=1e-2, epochs=2, cosine_decay_warmup=True, lr_step_epoch=False,
                           optimizer="AdamW" if case == "adamw" else "Adam",
                           clip_grad=1.0 if case in ("clip", "skip_nan") else None,
                           skip_nan=case == "skip_nan", weight_decay=0.1)
    scale = [3.0, 0.05, 2.0, 0.1, 5.0] if case == "clip" else [0.1] * 5
    grads = _grads(rng, scale, nan_at=2 if case == "skip_nan" else None)
    params = {"kernel": rng.randn(3, 4).astype(np.float32),
              "bias": rng.randn(5).astype(np.float32)}
    tx = jt.make_optimizer(cfg, steps_per_epoch=3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    ttx = tt.TrainOptimizer(tt.TrainerConfig(**vars(cfg)), 3, list(leaves.values()))
    applied = []
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        applied.append(ttx.step([torch.from_numpy(g[k]) for k in leaves]))
        for k in leaves:
            assert _rel(leaves[k], jp[k]) <= TOL_UPDATE, (k, len(applied))
    assert applied == [True, True, case != "skip_nan", True, True]


def test_make_optimizer_takes_the_module_parameters():
    tm = TADMM(n_iter=2, device=CPU)
    tx = tt.make_optimizer(tt.TrainerConfig(optimizer="AdamW"), 3, tm)
    assert [(len(g["params"]), g["weight_decay"]) for g in tx.optimizer.param_groups] == \
        [(0, 0.01), (4, 0.0)]     # every schedule is 1-D
    assert tt.make_optimizer(tt.TrainerConfig(), 3, TADMM(learn_params=False, device=CPU)).step(
        [])


def test_measure_gradient():
    grads = {"pre": {"w": torch.full((2, 2), 3.0)}, "post": {"w": torch.full((4,), 4.0)}}
    np.testing.assert_allclose(tt.measure_gradient(grads), np.sqrt(4 * 9 + 4 * 16), rtol=1e-6)
    per = tt.gradient_norms(grads)
    np.testing.assert_allclose(per["pre"], 6.0, rtol=1e-6)
    np.testing.assert_allclose(per["post"], 8.0, rtol=1e-6)
    jgrads = {"pre": {"w": jnp.full((2, 2), 3.0)}, "post": {"w": jnp.full((4,), 4.0)}}
    assert per == pytest.approx(jt.gradient_norms(jgrads), rel=1e-6)


# --- one Trainer step ---------------------------------------------------------------

def test_trainer_step_matches_jax(jax_trainer):
    """One step at tests/test_trainer.py's sizes with the unrolled-output,
    pre-processor and mask-L1 terms on and a TrainablePSF mask: the loss,
    every model gradient and the mask's gradient, from carried weights;
    then the updated parameters (the port's own update) and the mask's
    projection."""
    torch.set_num_threads(1)
    psf, batches = _setup(n_batches=1)
    jm, tm, variables = _models(return_intermediate=True)
    cfg = dict(epochs=1, lr=1e-3, unrolled_output_factor=1.0, pre_proc_aux=0.5, l1_mask=1e-2)
    jmask, tmask = jtm.TrainablePSF(psf, lr=1e-2), ttm.TrainablePSF(psf, lr=1e-2, device=CPU)
    jtr = jax_trainer(jm, variables, psf, lambda: iter(batches), batches,
                      jt.TrainerConfig(**cfg), mask=jmask)
    jtr.tx = jtr.mask_tx = RECORD
    jtr.opt_state = RECORD.init(jtr.variables["params"])
    jtr.mask_opt_state = RECORD.init(jmask.params)
    jtr._rebuild_step()
    jloss = jtr.train_epoch()
    jgrads, jmask_grads = jtr.opt_state, jtr.mask_opt_state

    ttr = tt.Trainer(tm, psf, lambda: iter(batches), batches, tt.TrainerConfig(**cfg),
                     mask=tmask, device=CPU)
    loss, grads, mask_grads = ttr.loss_and_grads(batches[0])
    assert abs(float(loss) - jloss) / abs(jloss) <= TOL_LOSS
    sd = dict(tm.state_dict())
    sd.update({name: g for (name, _), g in zip(ttr.named_params, grads)})
    assert _max_rel(convert.to_variables(tm, sd)["params"], jgrads) <= TOL_GRAD
    assert _rel(mask_grads["psf"], jmask_grads["psf"]) <= TOL_GRAD
    assert sorted(ttr.grads_by_block(grads)) == sorted(jgrads)

    before = {n: p.detach().clone() for n, p in ttr.named_params}
    ttr.apply_grads(grads, mask_grads)
    for (n, p), g in zip(ttr.named_params, grads):
        assert torch.equal(before[n], p) == (not bool(g.any())), n
    psf_after = tmask.params["psf"].detach()
    assert float(psf_after.min()) >= 0.0 and float(psf_after.max()) <= 1.0
    assert not torch.equal(psf_after, torch.from_numpy(psf))


def test_trainer_follows_a_float64_model():
    """A model converted with ``.double()`` trains in float64 (its inputs,
    the convolver, every gradient), as the card-against-CPU gradient check
    runs it, and agrees with the float32 step from the same weights."""
    torch.set_num_threads(1)
    psf, batches = _setup(n_batches=1)
    cfg = tt.TrainerConfig(epochs=1, lr=1e-3, unrolled_output_factor=1.0, pre_proc_aux=0.5)
    out = []
    for dtype in (torch.float32, torch.float64):
        tm = _models(return_intermediate=True)[1].to(dtype)
        tr = tt.Trainer(tm, psf, lambda: iter(batches), batches, cfg, device=CPU)
        loss, grads, _ = tr.loss_and_grads(batches[0])
        assert tr.dtype == dtype and loss.dtype == dtype
        assert all(g.dtype == dtype for g in grads)
        out.append((loss, grads))
    (loss32, grads32), (loss64, grads64) = out
    assert abs(float(loss32) - float(loss64)) / abs(float(loss64)) <= TOL_LOSS
    assert max(_rel(g32, as_numpy(g64)) for g32, g64 in zip(grads32, grads64)) <= TOL_GRAD


def test_train_step_matches_jax_make_train_step():
    """train/steps.py: two steps of ``make_train_step`` on an UnrolledADMM
    with Adam, from the same schedules: the losses and the schedules."""
    psf, batches = _setup(n_batches=1)
    jm, tm = JADMM(n_iter=3), TADMM(n_iter=3, device=CPU)
    variables = convert.random_variables(tm, 5)
    jc = JADMM.make_convolver(psf)
    tc = TADMM.make_convolver(psf, device=CPU)
    tx = optax.adam(1e-2)
    jstep = jax.jit(jsteps.make_train_step(lambda p, c, d: jm.apply(p, c, d), tx))
    jstate = jsteps.init_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_()
              for k, v in convert.state_dict(tm, variables).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    tstep = tsteps.make_train_step(
        lambda p, c, d: torch.func.functional_call(tm, p, (c, d)), opt)
    tstate = tsteps.init_train_state(params, opt)
    b = batches[0]
    for k in range(2):
        jstate, jl = jstep(jstate, jc, jnp.asarray(b["lensless"]), jnp.asarray(b["lensed"]))
        tstate, tl = tstep(tstate, tc, torch.from_numpy(b["lensless"]),
                           torch.from_numpy(b["lensed"]))
        assert abs(float(tl) - float(jl)) / abs(float(jl)) <= TOL_LOSS
    assert tstate.step == int(jstate.step) == 2
    for name in ("_mu1_p", "_mu2_p", "_mu3_p"):
        assert _rel(tstate.params[name], jstate.params["params"][name[1:4]]) <= TOL_GRAD
    with pytest.raises(ValueError, match="built over"):
        tsteps.init_train_state({"x": torch.zeros(1, requires_grad=True)}, opt)


# --- models/multi_wiener.py: BatchNorm in train() mode --------------------------------

@pytest.mark.parametrize("model", ["multi_wiener", "compensation"])
def test_batch_norm_running_stats_match_flax(model):
    """One ``train()`` forward: ``running_mean`` and ``running_var`` against
    flax's ``batch_stats`` after ``mutable=["batch_stats"]`` (the biased
    batch variance, momentum 0.99)."""
    rng = np.random.RandomState(11)
    if model == "multi_wiener":
        jm = jmw.MultiWiener(in_channels=3, out_channels=3, psf_channels=3, nc=(4, 8, 16, 16, 16))
        tm = tmw.MultiWiener(device=CPU, in_channels=3, out_channels=3, psf_channels=3,
                             nc=(4, 8, 16, 16, 16))
        psf = rng.rand(1, 32, 40, 3).astype(np.float32)
        args = (rng.rand(2, 1, 32, 40, 3).astype(np.float32), psf / np.linalg.norm(psf))
    else:
        jm = jcomp.CompensationBranch(nc=(4, 8, 16))
        tm = tcomp.CompensationBranch(device=CPU, nc=(4, 8, 16), in_channels=3)
        args = ([rng.rand(2, 1, 32, 40, 3).astype(np.float32) for _ in range(3)],)
    variables = convert.random_variables(tm, 4)
    tm.load_state_dict(convert.state_dict(tm, variables))
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    fn = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))
    _, updated = fn.lower(variables, *jargs).compile(compiler_options=O0)(variables, *jargs)
    tm.train()
    tm(*jax.tree_util.tree_map(torch.from_numpy, args))
    stats = convert.to_variables(tm)["batch_stats"]
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(
        updated["batch_stats"])
    assert max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(updated["batch_stats"]))
    ) <= TOL_BN
    assert all(int(v) == 1 for k, v in tm.state_dict().items() if k.endswith("num_batches_tracked"))
    assert set(tm.state_dict()) == set(convert.state_dict(tm, variables))


# --- the trainer's host side -----------------------------------------------------------

def test_trainer_loss_decreases(tmp_path):
    """tests/test_trainer.py:32-45 in the port."""
    psf, batches = _setup()
    _, tm, _ = _models(n_iter=3, processors=False)
    cfg = tt.TrainerConfig(epochs=3, lr=1e-2, optimizer="Adam", save_dir=str(tmp_path / "ckpt"))
    log = tt.Trainer(tm, psf, lambda: iter(batches), batches[:1], cfg, device=CPU).train(
        verbose=False)
    losses = [log[e]["loss"] for e in range(1, 4)]
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    assert all(np.isfinite(v) for v in losses)
    assert (tmp_path / "ckpt" / "metrics.json").exists()
    assert (tmp_path / "ckpt" / "recon_epochBEST").exists()


def test_trainer_save_restore_resume(tmp_path):
    """Checkpoints by ``torch.save``: ``resume`` finds the last epoch, the
    weights come back equal, with the metrics log, config and the mask's
    files."""
    psf, batches = _setup(n_batches=2)
    _, tm, _ = _models(processors=False)
    cfg = tt.TrainerConfig(epochs=2, lr=1e-2, save_dir=str(tmp_path / "ck"))
    trainer = tt.Trainer(tm, psf, lambda: iter(batches), batches[:1], cfg, device=CPU,
                         mask=ttm.TrainablePSF(psf, device=CPU))
    trainer.train(verbose=False)
    trained = {k: v.clone() for k, v in tm.state_dict().items()}
    _, fresh_model, _ = _models(processors=False, seed=9)
    fresh = tt.Trainer(fresh_model, psf, lambda: iter(batches), batches[:1], cfg, device=CPU)
    assert fresh.resume() == 2
    for k, v in fresh_model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    assert sorted(fresh.metrics_log) == [0, 1, 2]
    best = torch.load(tmp_path / "ck" / "recon_epochBEST", weights_only=True)
    assert set(best) == set(trained)
    assert json.loads((tmp_path / "ck" / "config.json").read_text())["epochs"] == 2
    assert np.load(tmp_path / "ck" / "mask_params.npy").shape == psf.shape
    assert np.load(tmp_path / "ck" / "psf.npy").shape == psf.shape
    fresh.restore(epoch=1)
    assert not all(torch.equal(v, trained[k]) for k, v in fresh_model.state_dict().items())


def test_trainer_step_log_examples_and_loggers(tmp_path):
    """The per-step JSONL log, the per-epoch example PNGs, and the logger
    protocol (tests/test_trainer.py:208-271): a raising logger does not
    stop training; the port's CSVLogger writes the JAX package's file for
    the same records."""
    psf, batches = _setup(n_batches=2)
    _, tm, _ = _models(processors=False)
    cfg = tt.TrainerConfig(epochs=2, lr=1e-3, save_dir=str(tmp_path / "run"),
                           save_examples=True)
    seen = []
    csv = tlog.CSVLogger(str(tmp_path / "log.csv"))

    def bad_logger(data, step):
        raise RuntimeError("boom")

    trainer = tt.Trainer(tm, psf, lambda: iter(batches), batches[:1], cfg, device=CPU,
                         loggers=[lambda d, s: seen.append((s, d)), csv, bad_logger])
    with pytest.warns(UserWarning, match="boom"):
        trainer.train(verbose=False)
    recs = [json.loads(ln) for ln in (tmp_path / "run" / "train_log.jsonl").read_text()
            .splitlines()]
    assert len(recs) == 2 * len(batches)
    assert recs[0]["step"] == 1 and recs[-1]["epoch"] == 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    for name in ("recon_0.png", "lensed_0.png"):
        assert (tmp_path / "run" / "epoch2" / name).exists()
    assert len([d for _, d in seen if "train/loss_step" in d]) == 4
    assert len([d for _, d in seen if "train/loss" in d]) == 2
    assert seen[0][0] == 0 and "eval/PSNR" in seen[0][1]
    assert any("examples_dir" in d for _, d in seen)
    jcsv = jlog.CSVLogger(str(tmp_path / "jax.csv"))
    for s, d in seen:
        jcsv(d, s)
    assert (tmp_path / "log.csv").read_text() == (tmp_path / "jax.csv").read_text()
    with pytest.raises(ImportError, match="wandb"):
        tlog.WandbLogger("project")


def test_trainer_evaluation_and_best_metric():
    """Extra eval sets are namespaced; per-batch 'psfs' replace the
    trainer's PSF (tests/test_trainer.py:152-186); the composite best
    metric (metric_for_best=None) is the JAX package's ``_eval_loss``."""
    psf, batches = _setup(n_batches=2)
    psf_b, batches_b = _setup(n_batches=1, seed=9)
    _, tm, _ = _models(processors=False)
    trainer = tt.Trainer(tm, psf, lambda: iter(batches), batches[:1],
                         tt.TrainerConfig(epochs=1, metric_for_best=None, l1_mask=0.5),
                         device=CPU,
                         extra_eval_sets={"setB": {"batches": batches_b, "psf": psf_b}},
                         mask=ttm.TrainablePSF(psf, device=CPU))
    metrics = trainer.evaluate()
    assert "PSNR" in metrics and "setB_PSNR" in metrics
    base = trainer._eval_batches(batches[:1], torch.from_numpy(psf))
    other = trainer._eval_batches([dict(batches[0], psfs=np.stack([psf_b, psf_b]))],
                                  torch.from_numpy(psf))
    same = trainer._eval_batches([dict(batches[0], psfs=np.stack([psf, psf]))],
                                 torch.from_numpy(psf))
    assert other["MSE"] != base["MSE"]
    np.testing.assert_allclose(same["MSE"], base["MSE"], rtol=1e-5)
    trainer.train(verbose=False)
    assert trainer.best_metric is not None and np.isfinite(trainer.best_metric)
    fake = {"MSE": 0.25, "MSE_unrolled": 0.5, "LPIPS_Vgg": 0.125, "LPIPS_Vgg_unrolled": 0.25,
            "ReconstructionError_PreProc": 2.0}
    cfg = dict(metric_for_best=None, l1_mask=0.5, unrolled_output_factor=2.0, lpips_weight=0.5,
               pre_proc_aux=0.25)
    trainer.config = tt.TrainerConfig(**cfg)
    jself = type("J", (), {"config": jt.TrainerConfig(**cfg),
                           "mask": jtm.TrainablePSF(as_numpy(trainer.mask.params["psf"]))})()
    np.testing.assert_allclose(trainer._eval_loss(fake), jt.Trainer._eval_loss(jself, fake),
                               rtol=1e-6)


def test_trainer_random_rotate_and_adamw_skip_nan_run():
    psf, batches = _setup(n_batches=2)
    _, tm, _ = _models(processors=False)
    for cfg in (tt.TrainerConfig(epochs=1, lr=1e-3, random_rotate=10.0),
                tt.TrainerConfig(epochs=1, optimizer="AdamW", skip_nan=True, lr=1e-3)):
        trainer = tt.Trainer(tm, psf, lambda: iter(batches), batches[:1], cfg, device=CPU)
        assert np.isfinite(trainer.train_epoch())
