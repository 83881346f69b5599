"""Training steps for learned reconstruction (port of
lenslesspicam_tpu/train/steps.py).

A step is loss -> gradients -> optimizer update on a dict of parameter
tensors, as the JAX package's jitted ``(state, conv, lensless, lensed) ->
(state, loss)``.  The optimizer is a ``torch.optim`` optimizer built over
the dict's tensors; it updates them in place, and ``TrainState.opt_state``
is its per-parameter state (the moments and counts that the JAX package's
``optimizer.init(params)`` makes).

Data parallelism: parameters placed by ``parallel.sharding.replicate``
carry their mesh, each rank feeds its block of the batch (and of the
depths), and the step averages the gradients and the loss over every rank
of the mesh, as XLA's gradient psum over the sharded batch does in the JAX
package.  The forward must treat each depth apart (every model of the
port does: no convolver sums over depths), so the mean over the mesh's
equal blocks is the mean over the whole batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class TrainState(NamedTuple):
    params: dict        # name -> leaf tensor that requires grad
    opt_state: dict     # the optimizer's ``state``: tensor -> its moments and count
    step: int


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def make_train_step(apply_fn: Callable, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = l2_loss):
    """Build ``(state, conv, lensless, lensed) -> (state, loss)``.

    ``apply_fn(params, conv, lensless) -> prediction`` is typically a
    closure over a module (``torch.func.functional_call``); ``optimizer``
    is built over ``state.params``' tensors.  Every parameter gets a
    gradient tensor, zeros where the loss does not reach it, as
    ``jax.grad`` gives one: its moments decay and its count advances.  For
    parameters placed by ``parallel.sharding.replicate`` the gradients and
    the loss are averaged over the mesh before the update (module
    docstring).
    """

    def step(state: TrainState, conv, lensless, lensed):
        leaves = list(state.params.values())
        loss = loss_fn(apply_fn(state.params, conv, lensless), lensed)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p, g in zip(leaves, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        loss = loss.detach()
        meshes = {id(m): m for m in (getattr(p, "_lpt_mesh", None) for p in leaves)
                  if m is not None}
        if len(meshes) > 1:
            raise ValueError("the parameters were replicated over different meshes")
        if meshes:
            from ..parallel.distributed import all_reduce_mean, mesh_group

            group = mesh_group(next(iter(meshes.values())))
            all_reduce_mean([p.grad for p in leaves] + [loss], group)
        optimizer.step()
        return TrainState(state.params, optimizer.state, state.step + 1), loss

    return step


def init_train_state(params: dict, optimizer: torch.optim.Optimizer) -> TrainState:
    """The state at step 0 of ``optimizer``, which must be built over
    exactly ``params``' tensors."""
    held = [p for group in optimizer.param_groups for p in group["params"]]
    if {id(p) for p in held} != {id(p) for p in params.values()}:
        raise ValueError("the optimizer must be built over the tensors of params")
    return TrainState(params, optimizer.state, 0)
