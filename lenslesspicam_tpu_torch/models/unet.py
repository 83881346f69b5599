"""UNetRes / DRUNet and the plain UNet (port of lenslesspicam_tpu/models/unet.py).

The networks take and return NCHW tensors, PyTorch's layout.  Their
parameters carry the names of the reference LenslessPiCam torch modules
(lensless/recon/drunet/network_unet.py), which the JAX package's
``zoo/convert.py`` reads: ``m_head``, ``m_down{1..3}.{j}.res.{0,2}`` with
the stride-2 convolution at index ``nb``, ``m_body``, ``m_up{3..1}`` with
the transposed convolution at index 0, ``m_tail``; the background encoder
as ``m_head_background`` / ``m_down{k}_background`` and
``subtraction_weights``.  A DPIR checkpoint loads with ``load_state_dict``.

The padding helpers keep the JAX package's layout: spatial axes (-3, -2),
channels last.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import module_input, resolve_device
from ..recon.apgd import resize_weights


def _conv(cin, cout, k=3, stride=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2 if stride == 1 else 0,
                     bias=bias)


class ResBlock(nn.Module):
    """x + conv3x3(relu(conv3x3(x))) (basicblock.py ResBlock "CRC")."""

    def __init__(self, ch: int):
        super().__init__()
        self.res = nn.Sequential(_conv(ch, ch), nn.ReLU(), _conv(ch, ch))

    def forward(self, x):
        return x + self.res(x)


def _down(nc, nb, scale):
    """nb ResBlocks at nc[scale], then the stride-2 convolution to nc[scale + 1]."""
    return nn.Sequential(*[ResBlock(nc[scale]) for _ in range(nb)],
                         _conv(nc[scale], nc[scale + 1], k=2, stride=2))


def resize_bilinear(x, hw):
    """NCHW ``x`` resized over its spatial axes to ``hw`` as
    ``jax.image.resize(..., method="bilinear")`` resizes it (antialiased
    when it downsamples): float64 triangle-kernel weight matrices built on
    the host (``recon.apgd.resize_weights``), applied in ``x``'s dtype."""
    wy = torch.from_numpy(resize_weights(x.shape[-2], hw[0], "linear")).to(x)
    wx = torch.from_numpy(resize_weights(x.shape[-1], hw[1], "linear")).to(x)
    return torch.einsum("yh,bchw,xw->bcyx", wy, x, wx)


class UNetRes(nn.Module):
    """4-scale residual U-Net (network_unet.py:103-255) on NCHW input with
    ``in_nc`` channels.

    ``background_subtraction``: a second encoder takes ``background`` and
    its per-scale features are subtracted with learnable weights.
    ``concatenate_compensation``: the compensation branch's features
    (``compensation_output``, NCHW) are resized to the bottleneck and
    concatenated there before a conv + ReLU; ``True`` means ``nc[3]``
    feature channels (the reference's), an int gives their number.
    The parameters lie on ``device`` (None: the CUDA card).
    """

    def __init__(self, in_nc: int = 4, out_nc: int = 3, nc: Sequence[int] = (64, 128, 256, 512),
                 nb: int = 4, background_subtraction: bool = False,
                 concatenate_compensation: bool | int = False, device=None):
        super().__init__()
        if len(nc) != 4:
            raise ValueError("nc must have 4 scales")
        nc = tuple(nc)
        self.background_subtraction = background_subtraction
        self.concatenate_compensation = bool(concatenate_compensation)
        self.m_head = _conv(in_nc, nc[0])
        self.m_down1, self.m_down2, self.m_down3 = (_down(nc, nb, s) for s in range(3))
        body = [ResBlock(nc[3]) for _ in range(nb)]
        if concatenate_compensation:
            comp = nc[3] if concatenate_compensation is True else int(concatenate_compensation)
            body = [_conv(nc[3] + comp, nc[3]), nn.ReLU(), *body]
        self.m_body = nn.Sequential(*body)
        self.m_up3, self.m_up2, self.m_up1 = (
            nn.Sequential(nn.ConvTranspose2d(nc[s + 1], nc[s], 2, stride=2, bias=False),
                          *[ResBlock(nc[s]) for _ in range(nb)])
            for s in (2, 1, 0))
        self.m_tail = _conv(nc[0], out_nc)
        if background_subtraction:
            self.subtraction_weights = nn.Parameter(torch.ones(4))
            self.m_head_background = _conv(in_nc, nc[0])
            self.m_down1_background, self.m_down2_background, self.m_down3_background = (
                _down(nc, nb, s) for s in range(3))
        self.to(resolve_device(device))

    def _encode(self, x, suffix=""):
        x1 = getattr(self, "m_head" + suffix)(x)
        x2 = getattr(self, "m_down1" + suffix)(x1)
        x3 = getattr(self, "m_down2" + suffix)(x2)
        return x1, x2, x3, getattr(self, "m_down3" + suffix)(x3)

    def forward(self, x0, background=None, compensation_output=None):
        x1, x2, x3, x4 = self._encode(x0)
        if self.background_subtraction:
            if background is None:
                raise ValueError("UNetRes(background_subtraction=True) needs a background")
            w = self.subtraction_weights
            b1, b2, b3, b4 = self._encode(background, "_background")
            x1, x2, x3, x4 = x1 - w[0] * b1, x2 - w[1] * b2, x3 - w[2] * b3, x4 - w[3] * b4
        latent = x4
        if self.concatenate_compensation:
            if compensation_output is None:
                raise ValueError("UNetRes(concatenate_compensation=...) needs "
                                 "compensation_output")
            comp = resize_bilinear(compensation_output, x4.shape[-2:])
            latent = torch.cat([x4, comp], dim=1)
        h = self.m_body(latent)
        h = self.m_up3(h + x4)
        h = self.m_up2(h + x3)
        h = self.m_up1(h + x2)
        return self.m_tail(h + x1)


def _conv_relu(cin, cout, k=3, stride=1):
    return [_conv(cin, cout, k, stride, bias=True), nn.ReLU()]


class UNet(nn.Module):
    """Plain U-Net with the global residual ``+ x0`` (network_unet.py:22-100):
    biased conv + ReLU head, per scale ``nb`` conv + ReLU blocks and a
    stride-2 conv + ReLU, ``nb + 1`` body convs, transposed-conv upsamples
    with additive skips, a biased tail.  The reference's flattened
    Sequential indices (convs at even indices) name the parameters, which
    lie on ``device`` (None: the CUDA card)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: Sequence[int] = (64, 128, 256, 512),
                 nb: int = 2, device=None):
        super().__init__()
        self.out_nc = out_nc
        self.m_head = nn.Sequential(*_conv_relu(in_nc, nc[0]))
        self.m_down1, self.m_down2, self.m_down3 = (
            nn.Sequential(*[m for _ in range(nb) for m in _conv_relu(nc[s], nc[s])],
                          *_conv_relu(nc[s], nc[s + 1], k=2, stride=2))
            for s in range(3))
        self.m_body = nn.Sequential(*[m for _ in range(nb + 1) for m in _conv_relu(nc[3], nc[3])])
        self.m_up3, self.m_up2, self.m_up1 = (
            nn.Sequential(nn.ConvTranspose2d(nc[s + 1], nc[s], 2, stride=2), nn.ReLU(),
                          *[m for _ in range(nb) for m in _conv_relu(nc[s], nc[s])])
            for s in (2, 1, 0))
        self.m_tail = _conv(nc[0], out_nc, bias=True)
        self.to(resolve_device(device))

    def forward(self, x0):
        x1 = self.m_head(x0)
        x2 = self.m_down1(x1)
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        h = self.m_body(x4)
        h = self.m_up3(h + x4)
        h = self.m_up2(h + x3)
        h = self.m_up1(h + x2)
        out = self.m_tail(h + x1)
        # the reference adds the raw input (in_nc == out_nc there)
        residual = x0[:, : self.out_nc] if x0.shape[1] >= self.out_nc else x0
        return out + residual


def _pad_hw(x, top, bottom, left, right):
    return F.pad(x, (0, 0, left, right, top, bottom))


def pad_to_multiple(x, mult: int = 8):
    """Zero-pad the spatial axes (-3, -2) up to a multiple of ``mult`` at
    the bottom right (a no-op when aligned), the Restormer padding; returns
    ``(padded, (h, w))`` for :func:`crop_from_multiple`."""
    h, w = x.shape[-3], x.shape[-2]
    return _pad_hw(x, 0, (-h) % mult, 0, (-w) % mult), (h, w)


def crop_from_multiple(x, hw):
    h, w = hw
    return x[..., :h, :w, :]


def pad_centered_multiple(x, mult: int = 8):
    """The DRUNet padding (apply_denoiser): ``mult - dim % mult`` per axis,
    a full ``mult`` when the side is already aligned, split centered.
    Returns ``(padded, (h, w, top, left))`` for :func:`crop_centered`."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = mult - h % mult, mult - w % mult
    top, left = ph // 2, pw // 2
    return _pad_hw(x, top, ph - top, left, pw - left), (h, w, top, left)


def crop_centered(x, hwtl):
    h, w, top, left = hwtl
    return x[..., top : top + h, left : left + w, :]


def drunet_denoise(model: UNetRes, image, noise_level):
    """DRUNet denoising of a channels-last ``(B, H, W, C)`` image: a
    constant noise-level channel (``noise_level / 255``), the centered pad
    to a multiple of 8, the network on NCHW, the crop.  ``image`` is placed
    on the model's device, or must lie there if it is a tensor."""
    image = module_input(image, model.m_head.weight.device, dtype=None)
    x, hwtl = pad_centered_multiple(image, 8)
    nl = torch.as_tensor(noise_level, dtype=x.dtype, device=x.device) / 255.0
    x = torch.cat([x, nl.expand(x.shape[:-1] + (1,))], dim=-1)
    out = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return crop_centered(out, hwtl)


def load_drunet(path, nc=(64, 128, 256, 512), nb: int = 4, device=None) -> UNetRes:
    """The DRUNet color denoiser from a DPIR torch checkpoint (its keys are
    :class:`UNetRes`'s), on ``device`` (None: the CUDA card), in eval mode;
    use it with :func:`drunet_denoise`."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = UNetRes(in_nc=4, out_nc=3, nc=tuple(nc), nb=nb, device=device)
    model.load_state_dict(sd)
    return model.eval()
