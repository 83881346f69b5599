"""Restormer, the transformer restoration model of Zamir et al. 2022 (port
of lenslesspicam_tpu/models/restormer.py).

NCHW inside, parameters named as the reference's (restormer.py:246-431:
``patch_embed.proj``, ``encoder_level1.{i}``, ``down1_2.body.0``, ...).
MDTA attends across channels (a C x C matrix per head) after 3x3
depthwise convolutions; GDFN gates ``gelu(x1) * x2`` with the tanh
approximation of GELU, flax's default, as the JAX package computes it
(the reference uses the exact form); the BiasFree layernorm scales by
1/std without subtracting the mean.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .unet import crop_from_multiple, pad_to_multiple


class _LayerNormBody(nn.Module):
    def __init__(self, dim: int, use_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x):
        mu = x.mean(dim=1, keepdim=True)
        inv = torch.rsqrt(((x - mu) ** 2).mean(dim=1, keepdim=True) + 1e-5)
        w = self.weight[:, None, None]
        if self.bias is None:
            return x * inv * w
        return (x - mu) * inv * w + self.bias[:, None, None]


class LayerNorm2d(nn.Module):
    """Layernorm over the channels of NCHW features: BiasFree
    (``use_bias=False``, the processors' default) or WithBias; eps 1e-5."""

    def __init__(self, dim: int, use_bias: bool = False):
        super().__init__()
        self.body = _LayerNormBody(dim, use_bias)

    def forward(self, x):
        return self.body(x)


def pixel_unshuffle(x, factor: int = 2):
    """``nn.PixelUnshuffle`` on NCHW: output channel c*f*f + i*f + j holds
    input channel c at spatial offset (i, j)."""
    return F.pixel_unshuffle(x, factor)


def pixel_shuffle(x, factor: int = 2):
    """``nn.PixelShuffle`` on NCHW, the inverse of :func:`pixel_unshuffle`."""
    return F.pixel_shuffle(x, factor)


class MDTA(nn.Module):
    """Multi-dconv-head transposed attention (restormer.py:145-183)."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=use_bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1, groups=dim * 3,
                                    bias=use_bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=use_bias)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = (t.reshape(b, self.num_heads, c // self.num_heads, h * w)
                   for t in self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1))
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = torch.softmax(q @ k.transpose(-2, -1) * self.temperature, dim=-1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class GDFN(nn.Module):
    """Gated depthwise-conv feed-forward (restormer.py:115-142):
    ``project_out(gelu(x1) * x2)``."""

    def __init__(self, dim: int, expansion: float = 2.66, use_bias: bool = False):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=use_bias)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1, groups=hidden * 2,
                                bias=use_bias)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=use_bias)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1, approximate="tanh") * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 ln_bias: bool = False):
        super().__init__()
        self.norm1 = LayerNorm2d(dim, ln_bias)
        self.attn = MDTA(dim, num_heads)
        self.norm2 = LayerNorm2d(dim, ln_bias)
        self.ffn = GDFN(dim, expansion)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, 3, padding=1, bias=False)

    def forward(self, x):
        return self.proj(x)


class _Resample(nn.Module):
    """A bias-free 3x3 convolution to ``out_ch``, then a pixel (un)shuffle."""

    def __init__(self, in_ch: int, out_ch: int, shuffle: nn.Module):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False), shuffle)

    def forward(self, x):
        return self.body(x)


class Restormer(nn.Module):
    """4-level Restormer (restormer.py:246-431): encoder levels at (d, 2d,
    4d), latent at 8d, 1x1 channel reductions at decoder levels 3 and 2,
    the level-1 decoder and refinement at 2d, a bias-free 3x3 output and
    a global residual.  NCHW in and out; the parameters lie on ``device``
    (None: the CUDA card)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), expansion: float = 2.66,
                 ln_bias: bool = False, device=None):
        super().__init__()
        self.out_channels = out_channels
        d = dim

        def blocks(level_dim, level_heads, n):
            return nn.Sequential(*[TransformerBlock(level_dim, level_heads, expansion, ln_bias)
                                   for _ in range(n)])

        self.patch_embed = _PatchEmbed(in_channels, d)
        self.encoder_level1 = blocks(d, heads[0], num_blocks[0])
        self.down1_2 = _Resample(d, d // 2, nn.PixelUnshuffle(2))
        self.encoder_level2 = blocks(2 * d, heads[1], num_blocks[1])
        self.down2_3 = _Resample(2 * d, d, nn.PixelUnshuffle(2))
        self.encoder_level3 = blocks(4 * d, heads[2], num_blocks[2])
        self.down3_4 = _Resample(4 * d, 2 * d, nn.PixelUnshuffle(2))
        self.latent = blocks(8 * d, heads[3], num_blocks[3])
        self.up4_3 = _Resample(8 * d, 16 * d, nn.PixelShuffle(2))
        self.reduce_chan_level3 = nn.Conv2d(8 * d, 4 * d, 1, bias=False)
        self.decoder_level3 = blocks(4 * d, heads[2], num_blocks[2])
        self.up3_2 = _Resample(4 * d, 8 * d, nn.PixelShuffle(2))
        self.reduce_chan_level2 = nn.Conv2d(4 * d, 2 * d, 1, bias=False)
        self.decoder_level2 = blocks(2 * d, heads[1], num_blocks[1])
        self.up2_1 = _Resample(2 * d, 4 * d, nn.PixelShuffle(2))
        # no channel reduction at level 1 (restormer.py:352-369)
        self.decoder_level1 = blocks(2 * d, heads[0], num_blocks[0])
        self.refinement = blocks(2 * d, heads[0], num_refinement_blocks)
        self.output = nn.Conv2d(2 * d, out_channels, 3, padding=1, bias=False)
        self.to(resolve_device(device))

    def forward(self, x):
        enc1 = self.encoder_level1(self.patch_embed(x))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        f = self.latent(self.down3_4(enc3))
        f = self.decoder_level3(self.reduce_chan_level3(torch.cat([self.up4_3(f), enc3], 1)))
        f = self.decoder_level2(self.reduce_chan_level2(torch.cat([self.up3_2(f), enc2], 1)))
        f = self.decoder_level1(torch.cat([self.up2_1(f), enc1], 1))
        return self.output(self.refinement(f)) + x[:, : self.out_channels]


def restormer_fn(model: Restormer):
    """The processor wrapper (restormer.py:16-49): ``(B, D, H, W, C)`` in and
    out, depth folded into the batch, padded to a multiple of 8 at the
    bottom right, the model on NCHW."""

    def process(image, noise_level=None, **_ignored):
        b, depth = image.shape[0], image.shape[1]
        x, hw = pad_to_multiple(image.reshape((b * depth,) + image.shape[2:]), 8)
        out = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        out = crop_from_multiple(out, hw)
        return out.reshape((b, depth) + out.shape[1:])

    return process
