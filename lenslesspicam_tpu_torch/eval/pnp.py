"""Parameterize-and-Perturb (Gilton et al.) test-time adaptation (port of
lenslesspicam_tpu/eval/pnp.py).

Given a measurement ``y`` and model parameters ``theta_0``, SGD steps on

    mean((normalize(H f_theta(y)) - y)^2) + mu * mean((theta - theta_0)^2)

with gradients from ``torch.autograd.grad``; returns the adapted
prediction and parameters.
"""

from __future__ import annotations

import torch

from ..ops.fft_conv import FFTConvolver


def _param_distance(params: dict, params0: dict):
    num = sum(torch.sum((params[k] - params0[k]) ** 2) for k in params)
    return num / sum(v.numel() for v in params.values())


def parameterize_perturb(apply_fn, params0: dict, forward_conv: FFTConvolver, lensless,
                         mu: float = 1e-3, lr: float = 1e-3, n_iter: int = 50):
    """Adapt ``params`` to one measurement batch; returns ``(prediction,
    adapted_params)``.

    ``apply_fn(params, lensless) -> prediction`` (B, D, H, W, C), with
    ``params`` a dict of tensors; ``forward_conv`` a padded convolver."""
    params0 = {k: v.detach() for k, v in params0.items()}
    params = dict(params0)
    for _ in range(int(n_iter)):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        y_est = forward_conv.convolve(apply_fn(p, lensless))
        y_est = y_est - torch.min(y_est)
        y_est = y_est / torch.clamp(torch.max(y_est), min=1e-12)
        loss = torch.mean((y_est - lensless) ** 2) + mu * _param_distance(p, params0)
        grads = torch.autograd.grad(loss, list(p.values()))
        params = {k: (v - lr * g).detach() for (k, v), g in zip(p.items(), grads)}
    with torch.no_grad():
        return apply_fn(params, lensless), params
