"""MultiWiener deconvolution network, MWDN (port of
lenslesspicam_tpu/models/multi_wiener.py).

A U-Net encoder with a parallel PSF encoder; at each scale the image
features are Wiener-filtered by the PSF features with a learnable
regularizer ``delta`` per scale and a learnable PSF gain ``w``; a
bilinear (align-corners) decoder with concatenation skips; the input
padded to a multiple of 8; the output mapped ``(x + 1) / 2`` and clipped
at 0.  NCHW inside; parameters named as the reference's
(multi_wiener.py: ``inc``, ``inc0``, ``down_layers``, ``psf_down``,
``up_layers``, ``outc``).  BatchNorm has flax's momentum 0.99 (0.01 in
PyTorch's convention) and eps 1e-5; ``train()`` updates the running
variance with the biased batch variance, as flax does; ``eval()`` uses the
running statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import module_input, resolve_device


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose ``train()`` forward updates the running
    statistics as flax ``nn.BatchNorm`` does: ``running_var`` with the
    biased batch variance (PyTorch's own uses the unbiased one, n / (n - 1)
    times larger).  The state-dict names are ``nn.BatchNorm2d``'s."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    """flax ``nn.BatchNorm``'s defaults: momentum 0.99, eps 1e-5."""
    return FlaxBatchNorm2d(ch, eps=1e-5, momentum=0.01)


class DoubleConv(nn.Module):
    """(conv 3x3 -> BN -> ReLU) x 2, bias-free convolutions."""

    def __init__(self, in_ch: int, out_ch: int, mid_ch: int | None = None):
        super().__init__()
        mid = mid_ch or out_ch
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_ch, mid, 3, padding=1, bias=False), batch_norm(mid), nn.ReLU(),
            nn.Conv2d(mid, out_ch, 3, padding=1, bias=False), batch_norm(out_ch), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.pool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_ch, out_ch))

    def forward(self, x):
        return self.pool_conv(x)


def bilinear_align_corners(x, out_h: int, out_w: int):
    """NCHW bilinear resize with ``align_corners=True`` (the reference's
    ``nn.Upsample`` in ``Up``)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


class Up(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, mid_ch: int | None = None):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, mid_ch)

    def forward(self, x1, x2):
        x1 = bilinear_align_corners(x1, x1.shape[-2] * 2, x1.shape[-1] * 2)
        dy = x2.shape[-2] - x1.shape[-2]
        dx = x2.shape[-1] - x1.shape[-1]
        x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        return self.conv(x)


def wiener_filter(blur, psf_feat, delta):
    """Per-channel Wiener deconvolution of NCHW features:
    ``irfft2(conj(P) / (|P|^2 + delta) * rfft2(blur))``, then ifftshift."""
    h, w = blur.shape[-2], blur.shape[-1]
    blur_fft = torch.fft.rfft2(blur)
    psf_fft = torch.fft.rfft2(psf_feat)
    filt = torch.conj(psf_fft) / (torch.abs(psf_fft) ** 2 + delta)
    img = torch.fft.irfft2(filt * blur_fft, s=(h, w))
    return torch.roll(img, (-(h // 2), -(w // 2)), dims=(-2, -1))


class MultiWiener(nn.Module):
    """``forward(data, psf)``: data ``(B, D, H, W, C)`` with D == 1 (or
    ``(B, H, W, C)``), psf ``(D, H, W, psf_channels)``; returns a
    reconstruction of the data's shape.  The parameters lie on ``device``
    (None: the CUDA card); the inputs are numpy arrays, placed there, or
    tensors that lie there (they keep their autograd graph)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, psf_channels: int = 1,
                 nc: Sequence[int] = (64, 128, 256, 512, 512), device=None):
        super().__init__()
        nc = tuple(nc)
        self.delta = nn.Parameter(torch.ones(len(nc)) * 0.01)
        self.w = nn.Parameter(torch.ones(1, psf_channels, 1, 1) * 0.001)
        self.inc = DoubleConv(in_channels, nc[0])
        self.down_layers = nn.ModuleList(Down(nc[i], nc[i + 1]) for i in range(len(nc) - 1))
        # one downsample fewer than the image branch (multi_wiener.py:146-148)
        self.inc0 = DoubleConv(psf_channels, nc[0])
        self.psf_down = nn.ModuleList(Down(nc[i], nc[i + 1]) for i in range(len(nc) - 2))
        ups, n_prev = [], nc[-1]
        for i in range(len(nc) - 1):
            n_out = nc[-i - 2] // 2 if i < len(nc) - 2 else nc[0]
            ups.append(Up(n_prev + nc[-i - 2], n_out, (n_prev + nc[-i - 2]) // 2))
            n_prev = n_out
        self.up_layers = nn.ModuleList(ups)
        self.outc = OutConv(nc[0], out_channels)
        self.to(resolve_device(device))

    def forward(self, data, psf):
        data = module_input(data, self.delta.device)
        psf = module_input(psf, self.delta.device)
        if data.ndim == 5:
            if data.shape[1] != 1:
                raise ValueError("MultiWiener takes depth 1 (multi_wiener.py:217)")
            x = data[:, 0]
        else:
            x = data
        h0, w0 = x.shape[-3], x.shape[-2]
        pt = (8 - h0 % 8) // 2
        pb = (8 - h0 % 8) - pt
        pl = (8 - w0 % 8) // 2
        pr = (8 - w0 % 8) - pl
        x = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
        psf_in = F.pad((psf[0] if psf.ndim == 4 else psf).permute(2, 0, 1), (pl, pr, pt, pb))[None]

        feats = [self.inc(x)]
        for down in self.down_layers:
            feats.append(down(feats[-1]))
        psf_feats = [self.inc0(self.w * psf_in)]
        for down in self.psf_down:
            psf_feats.append(down(psf_feats[-1]))
        for i, pf in enumerate(psf_feats):
            feats[i] = wiener_filter(feats[i], pf, self.delta[i])

        h = feats[-1]
        for i, up in enumerate(self.up_layers):
            h = up(h, feats[-i - 2])
        out = self.outc(h)[..., pt : pt + h0, pl : pl + w0]
        out = torch.clamp((out + 1.0) / 2.0, min=0.0).permute(0, 2, 3, 1)
        return out[:, None] if data.ndim == 5 else out
