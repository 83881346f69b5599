"""The port's processor schedule against the JAX package's on the CPU:
``Trainer.train`` over 3 epochs with the pre-processor delayed by one
epoch and the post block frozen from the second (tests/test_trainer.py:
93-128), then a pre-processor freeze with its unfreeze, from carried
weights; the parameters and the Adam moments after it, the frozen blocks
unchanged while frozen, the delayed processor unchanged while delayed; and
the ``start_epoch`` replay of the schedule.

The JAX package's freeze zeroes the updates of the top-level keys
``pre_block`` / ``post_block`` of its parameter tree, which hold the
processors' noise levels (the networks' weights are under ``pre_process``
/ ``post_process``); the port freezes the same parameters.

Set-up as in ``tests/test_torch_train.py`` (carried JAX-layout weights,
the JAX steps compiled with XLA's backend optimisation off), one batch an
epoch, lr 1e-4.  Tolerances, max |port - JAX| / max |JAX| per leaf:

- the processors' parameters and noise levels, the blocks the schedule
  acts on: 1e-5 (4e-7 measured);
- the unrolled ADMM's schedules and both Adam moments: 4e-5, about twice
  the largest reading.  The two packages' float32 gradients of the
  schedules differ by 1.5e-5-2.4e-5 at one step, and Adam's normalized
  updates carry that into the parameters, whose size is set by the
  updates; the moments average the gradients.  Measured after 3 steps
  (delay_pre_freeze_post / freeze_unfreeze_pre_delay_post): schedules
  1.03e-5 / 1.25e-5, first moment 9.2e-6 / 9.6e-6, second moment
  1.78e-5 / 1.91e-5; the blocks 4.0e-7 / 3.2e-7.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from lenslesspicam_tpu.train import trainer as jt

from lenslesspicam_tpu_torch import convert
from lenslesspicam_tpu_torch.train import trainer as tt

from test_torch_train import CPU, _compiled, _max_rel, _models, _setup

TOL_BLOCKS = 1e-5
TOL_SCHEDULE = 4e-5


def _adam_moments(opt_state):
    """(mu, nu) of the optax chain's ScaleByAdamState."""
    state = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    return state.mu, state.nu


def _port_tree(trainer, values):
    """Per-parameter tensors of ``trainer``'s model in the flax layout."""
    sd = dict(trainer.model.state_dict())
    sd.update({name: v for (name, _), v in zip(trainer.named_params, values)})
    return convert.to_variables(trainer.model, sd)["params"]


def _snapshot(trainer, names):
    return {n: p.detach().clone() for n, p in trainer.named_params
            if trainer.block_of[n] in names}


@pytest.mark.parametrize("schedule", [
    dict(pre_process_delay=1, post_process_freeze=1),
    dict(pre_process_freeze=0, pre_process_unfreeze=2, post_process_delay=1),
], ids=["delay_pre_freeze_post", "freeze_unfreeze_pre_delay_post"])
def test_processor_schedule_matches_jax(schedule, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jt.Trainer, "_rebuild_step", lambda self: setattr(
        self, "_train_step", _compiled(self._build_train_step(
            self._skip_pre, self._skip_post, self._frozen))))
    psf, batches = _setup(n_batches=1)
    jm, tm, variables = _models()
    monkeypatch.setattr(type(jm), "init", lambda self, *a, **k: jax.tree_util.tree_map(
        jnp.asarray, variables))
    cfg = dict(epochs=3, lr=1e-4, **schedule)
    jtr = jt.Trainer(jm, psf, lambda: iter(batches), batches[:1], jt.TrainerConfig(**cfg))

    snaps = {}
    names = ("pre_block", "post_block", "pre_process", "post_process")

    def snapshot_logger(data, step):
        if "epoch" in data:
            snaps[data["epoch"]] = _snapshot(ttr, names)

    ttr = tt.Trainer(tm, psf, lambda: iter(batches), batches[:1], tt.TrainerConfig(**cfg),
                     device=CPU, loggers=[snapshot_logger])
    assert (ttr._skip_pre, ttr._skip_post) == (jtr._skip_pre, jtr._skip_post)
    jtr.train(verbose=False)
    ttr.train(verbose=False)
    assert (ttr._skip_pre, ttr._skip_post, ttr._frozen) == \
        (jtr._skip_pre, jtr._skip_post, jtr._frozen)
    params, jparams = convert.to_variables(tm)["params"], dict(jtr.variables["params"])
    assert params.keys() == jparams.keys()
    assert _max_rel(params.pop("camera_inversion"), jparams.pop("camera_inversion")) <= TOL_SCHEDULE
    assert _max_rel(params, jparams) <= TOL_BLOCKS
    mu, nu = _adam_moments(jtr.opt_state)
    state = [ttr.tx.optimizer.state[p] for _, p in ttr.named_params]
    assert _max_rel(_port_tree(ttr, [s["exp_avg"] for s in state]), mu) <= TOL_SCHEDULE
    assert _max_rel(_port_tree(ttr, [s["exp_avg_sq"] for s in state]), nu) <= TOL_SCHEDULE
    assert all(int(s["step"]) == 3 for s in state)

    # epochs are 1-based in the log, 0-based in the schedule
    def unchanged(block, first, last):
        return all(torch.equal(snaps[first][n], snaps[last][n]) for n in snaps[first]
                   if ttr.block_of[n] == block)

    if "pre_process_delay" in schedule:
        assert unchanged("pre_process", 0, 1) and unchanged("pre_block", 0, 1)
        assert not unchanged("pre_process", 1, 2)
        assert unchanged("post_block", 1, 3) and not unchanged("post_block", 0, 1)
        assert not unchanged("post_process", 1, 3)      # its network is not frozen
    else:
        assert unchanged("post_process", 0, 1) and not unchanged("post_process", 1, 2)
        assert unchanged("pre_block", 0, 2) and not unchanged("pre_block", 2, 3)

    for start in (1, 2, 3):
        jfresh = jt.Trainer(jm, psf, lambda: iter(batches), batches[:1],
                            jt.TrainerConfig(**dict(cfg, epochs=start)))
        tfresh = tt.Trainer(tm, psf, lambda: iter(batches), batches[:1],
                            tt.TrainerConfig(**dict(cfg, epochs=start)), device=CPU)
        jfresh.train(verbose=False, start_epoch=start)
        tfresh.train(verbose=False, start_epoch=start)
        assert (tfresh._skip_pre, tfresh._skip_post, tfresh._frozen) == \
            (jfresh._skip_pre, jfresh._skip_post, jfresh._frozen), start
