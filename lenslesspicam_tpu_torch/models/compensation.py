"""Model-mismatch compensation branch (Zeng & Lam 2021; port of
lenslesspicam_tpu/models/compensation.py).

A CNN ladder over the raw measurement and the K - 1 intermediate
reconstructions of the unrolled solver: each rung concatenates a
max-pooled (residual) encoding of the next intermediate; the last feature
map goes into the post-processor's bottleneck (``UNetRes``
``concatenate_compensation``).  NCHW inside; parameters named as the
reference's (recon/utils.py:30-175: ``branch_layers``,
``residual_layers``), BatchNorm as in ``multi_wiener``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .multi_wiener import batch_norm


def double_conv_pool(in_ch: int, out_ch: int, pool: int = 2, skip_last_relu: bool = False):
    """conv -> BN -> ReLU -> conv -> BN [-> ReLU] [-> max pool] as one
    Sequential (convolutions at indices 0 and 3, BatchNorms at 1 and 4)."""
    layers = [nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False), batch_norm(out_ch), nn.ReLU(),
              nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False), batch_norm(out_ch)]
    if not skip_last_relu:
        layers.append(nn.ReLU())
    if pool:
        layers.append(nn.MaxPool2d(pool))
    return nn.Sequential(*layers)


class ResPool(nn.Module):
    """max_pool(relu(x + double_conv(x))), a residual rung (utils.py:55-81)."""

    def __init__(self, ch: int, pool: int = 2):
        super().__init__()
        self.pool = pool
        self.double_conv = double_conv_pool(ch, ch, pool=0, skip_last_relu=True)

    def forward(self, x):
        return F.max_pool2d(F.relu(x + self.double_conv(x)), self.pool)


def fold_depth(x):
    """``(B, D, H, W, C)`` -> NCHW ``(B, D * C, H, W)``, depth folded into
    the channels (channel d * C + c), as the JAX package folds it."""
    if x.ndim == 5:
        b, d, h, w, c = x.shape
        return x.permute(0, 1, 4, 2, 3).reshape(b, d * c, h, w)
    return x


class CompensationBranch(nn.Module):
    """``forward(inputs)`` with ``inputs`` a list of ``len(nc)`` tensors
    ``(B, D, H, W, C)``: the measurement and the ``len(nc) - 1``
    intermediates; returns the last feature map, NCHW ``(B, nc[-1], h, w)``.
    ``in_channels`` is D * C.  The parameters lie on ``device`` (None: the
    CUDA card)."""

    def __init__(self, nc: Sequence[int], in_channels: int = 3, residual: bool = True,
                 device=None):
        super().__init__()
        nc = tuple(nc)
        self.branch_layers = nn.ModuleList(
            double_conv_pool(in_channels if k == 0 else nc[k - 1] + (
                in_channels if residual else nc[k - 1]), nc[k])
            for k in range(len(nc)))
        self.residual_layers = nn.ModuleList(
            ResPool(in_channels, pool=2 ** (k + 1)) if residual else
            double_conv_pool(in_channels, nc[k], pool=2 ** (k + 1))
            for k in range(len(nc) - 1))
        self.to(resolve_device(device))

    def forward(self, inputs):
        if len(inputs) != len(self.branch_layers):
            raise ValueError("need the measurement and n_iter - 1 intermediates")
        h = self.branch_layers[0](fold_depth(inputs[0]))
        for k, res in enumerate(self.residual_layers):
            h = torch.cat([h, res(fold_depth(inputs[k + 1]))], dim=1)
            h = self.branch_layers[k + 1](h)
        return h
