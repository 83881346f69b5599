"""Integrated background subtraction (port of
lenslesspicam_tpu/models/background.py): a ``UNetRes`` whose second
encoder takes the background measurement and whose per-scale features
are subtracted with learnable weights, used in place of a pre-processor
(trainable_recon.py:135-142)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .unet import UNetRes


class IntegratedBackgroundSub(nn.Module):
    """``forward(x, background)`` on NCHW inputs that carry the processor's
    noise-level channel (``in_nc`` channels); the parameters lie on
    ``device`` (None: the CUDA card).

    ``input_background`` is the JAX module's field, taken so that the same
    keywords build both; it has no effect in either package: nothing reads
    it, and ``TrainableRecon`` passes the background to this module whenever
    its ``integrated_background_subtraction`` is set."""

    def __init__(self, in_nc: int = 4, out_nc: int = 3, nc: Sequence[int] = (32, 64, 112, 128),
                 nb: int = 2, input_background: bool = True, device=None):
        super().__init__()
        self.input_background = input_background     # JAX-API parity, read by nothing
        self.unet = UNetRes(in_nc=in_nc, out_nc=out_nc, nc=nc, nb=nb,
                            background_subtraction=True, device=device)

    def forward(self, x, background=None):
        if background is None:
            raise ValueError("IntegratedBackgroundSub needs a background")
        return self.unet(x, background=background)
