"""Learned reconstruction: pre-processor -> camera inversion ->
post-processor, with a PSF network, background subtraction and the
compensation branch (port of lenslesspicam_tpu/models/trainable_recon.py).

The state dict follows the reference LenslessPiCam
``TrainableReconstructionAlgorithm`` (trainable_recon.py:22-549), whose
keys the JAX package's zoo loader reads: ``pre_process_model.*`` and the
noise level ``pre_process_param``, likewise ``post_process_*``,
``psf_network_*`` and ``background_network_*``, ``compensation_branch.*``;
the camera inversion's under ``camera_inversion.`` (the reference keeps an
unrolled solver's schedules at the top level).
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import module_input, resolve_device
from ..ops.fft_conv import FFTConvolver
from .restormer import Restormer
from .unet import crop_centered, crop_from_multiple, pad_centered_multiple, pad_to_multiple


def processor_block(net: nn.Module, noise_level, image, background=None,
                    compensation_output=None):
    """The JAX package's ``ProcessorBlock``: ``net`` on ``(B, D, H, W, C)``
    images, depth folded into the batch, NCHW inside.

    DRUNet-style nets (get_drunet_function_v2, recon/utils.py:369-394):
    normalize by the per-sample max over the last four axes plus 1e-6, the
    centered always-pad to a multiple of 8, a noise channel
    ``|noise_level| / 255`` (the background gets a zero one), clip at 0,
    rescale.  A :class:`Restormer` (get_restormer_function,
    restormer.py:16-49): pad to a multiple of 8 at the bottom right, clamp
    to [0, 1], no noise channel; ``noise_level`` is unused.
    """
    b, d = image.shape[0], image.shape[1]
    if isinstance(net, Restormer):
        x, hw = pad_to_multiple(image.reshape((b * d,) + image.shape[2:]), 8)
        out = torch.clamp(net(x.permute(0, 3, 1, 2)), 0.0, 1.0).permute(0, 2, 3, 1)
        out = crop_from_multiple(out, hw)
        return out.reshape((b, d) + out.shape[1:])

    x_max = torch.amax(image, dim=(-1, -2, -3, -4), keepdim=True) + 1e-6

    def net_input(x, level):
        x, hwtl = pad_centered_multiple((x / x_max).reshape((b * d,) + x.shape[2:]), 8)
        x = torch.cat([x, level.to(x.dtype).expand(x.shape[:-1] + (1,))], dim=-1)
        return x.permute(0, 3, 1, 2), hwtl

    x, hwtl = net_input(image, torch.abs(noise_level[0]) / 255.0)
    kwargs = {}
    if background is not None:
        kwargs["background"] = net_input(background, torch.zeros((), device=image.device))[0]
    if compensation_output is not None:
        kwargs["compensation_output"] = compensation_output
    out = crop_centered(net(x, **kwargs).permute(0, 2, 3, 1), hwtl)
    return torch.clamp(out.reshape((b, d) + out.shape[1:]), min=0.0) * x_max


class TrainableRecon(nn.Module):
    """Composable learned reconstruction (trainable_recon.py:22).

    ``forward(data, psf, background=None)`` with data ``(B, D, H, W, C)``
    and psf ``(D, H, W, C)`` or per sample ``(B, D, H, W, C)``.  The whole
    model, its parts included, lies on ``device`` (None: the CUDA card),
    held by an empty buffer for a model without parameters; numpy inputs
    are placed there, tensors must lie there and keep their autograd
    graph.  ``train()`` / ``eval()`` choose the BatchNorm statistics where
    flax passes ``train=``.
    """

    def __init__(self, camera_inversion: nn.Module | None = None,
                 pre_process: nn.Module | None = None, post_process: nn.Module | None = None,
                 psf_network: nn.Module | None = None,
                 background_network: nn.Module | None = None,
                 compensation_branch: nn.Module | None = None, psf_residual: bool = True,
                 direct_background_subtraction: bool = False,
                 integrated_background_subtraction: bool = False, skip_unrolled: bool = False,
                 skip_pre: bool = False, skip_post: bool = False,
                 return_intermediate: bool = False, pad_policy: str = "ref", device=None):
        super().__init__()
        self.camera_inversion = camera_inversion
        for name, net in (("pre_process", pre_process), ("post_process", post_process),
                          ("psf_network", psf_network),
                          ("background_network", background_network)):
            setattr(self, f"{name}_model", net)
            setattr(self, f"{name}_param",
                    None if net is None else nn.Parameter(torch.ones(1)))
        self.compensation_branch = compensation_branch
        self.psf_residual = psf_residual
        self.direct_background_subtraction = direct_background_subtraction
        self.integrated_background_subtraction = integrated_background_subtraction
        self.skip_unrolled = skip_unrolled
        self.skip_pre = skip_pre
        self.skip_post = skip_post
        self.return_intermediate = return_intermediate
        self.pad_policy = pad_policy
        self.register_buffer("_anchor", torch.empty(0), persistent=False)
        self.to(resolve_device(device))

    def _make_convolver(self, psf) -> FFTConvolver:
        inv = self.camera_inversion
        if inv is not None and hasattr(type(inv), "make_convolver"):
            return type(inv).make_convolver(psf, dtype=psf.dtype, pad_policy=self.pad_policy,
                                            device=psf.device)
        return FFTConvolver.from_psf(psf, pad=True, norm="ortho", dtype=psf.dtype,
                                     pad_policy=self.pad_policy, device=psf.device)

    def _process(self, name, image, **kwargs):
        return processor_block(getattr(self, f"{name}_model"), getattr(self, f"{name}_param"),
                               image, **kwargs)

    def forward(self, data, psf, background=None):
        # inputs take the module's dtype: float32 unless it was converted
        device, dtype = self._anchor.device, self._anchor.dtype
        data = module_input(data, device, dtype)
        psf = module_input(psf, device, dtype)
        if data.ndim != 5:
            raise ValueError("data must be (B, D, H, W, C)")
        if background is not None:
            background = module_input(background, device, dtype)

        # 1. background subtraction (trainable_recon.py:318-335)
        if self.direct_background_subtraction or (
                self.background_network_model is not None
                and not self.integrated_background_subtraction):
            if background is None:
                raise ValueError("this model subtracts a background: pass background=")
            if not self.direct_background_subtraction:
                background = self._process("background_network", background)
            data = torch.clamp(data - background, 0.0, 1.0)

        # 2. PSF network with its residual; the convolver from the result (338-355)
        if self.psf_network_model is not None:
            psf5 = psf[None] if psf.ndim == 4 else psf
            psf_out = self._process("psf_network", psf5)
            psf_out = psf_out[0] if psf.ndim == 4 else psf_out
            psf = psf_out + psf if self.psf_residual else psf_out
        conv = self._make_convolver(psf)

        # 3. pre-processor (357-370)
        if self.integrated_background_subtraction:
            if self.pre_process_model is None or background is None:
                raise ValueError("integrated background subtraction needs a pre-processor "
                                 "and background=")
            data = self._process("pre_process", data, background=background)
        elif self.pre_process_model is not None and not self.skip_pre:
            data = self._process("pre_process", data)
        pre_processed = data

        # 4. camera inversion (379-382)
        comp_inputs = None
        if self.skip_unrolled or self.camera_inversion is None:
            image_est = data
        elif self.compensation_branch is not None:
            image_est, inters = self.camera_inversion(conv, data, psf,
                                                      return_intermediates=True)
            comp_inputs = [data] + inters
        else:
            image_est = self.camera_inversion(conv, data, psf)

        # 5. post-processor, fed the compensation features (389-398)
        if self.post_process_model is not None and not self.skip_post:
            comp_out = None
            if comp_inputs is not None:
                comp_out = self.compensation_branch(comp_inputs)
            final_est = self._process("post_process", image_est, compensation_output=comp_out)
        else:
            final_est = image_est

        if self.return_intermediate:
            return final_est, image_est, pre_processed, psf
        return final_est

