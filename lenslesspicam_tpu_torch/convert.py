"""Carry solver constants, state and weights across from the JAX package.

The single-image solvers have no learned weights: what stands in for
them is the loop-invariant operator set and the solver state.  The LPIPS
metric has weights (:func:`lpips_state_dict`).  These functions take
plain numpy arrays (``np.asarray`` of the JAX arrays, keyed by the JAX
field names) and build the port's structures; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .ops.fft_conv import FFTConvolver
from .recon.admm import ADMMParams, ADMMPrecomp, ADMMState
from .recon.admm_split import ARRAY_FIELDS, SPLIT_FIELDS, RSplitPrecomp, SplitPrecomp


def _t(x, device, dtype=None):
    return torch.from_numpy(np.array(x, dtype)).to(device)


def tensor(x, device=None) -> torch.Tensor:
    """A numpy array (``np.asarray`` of a JAX array) as a tensor of the
    same dtype on ``device``.  bfloat16 arrays (numpy dtype
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) travel
    bit for bit as int16 and are viewed back as ``torch.bfloat16``."""
    device = resolve_device(device)
    a = np.array(x, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def admm_params(params) -> ADMMParams:
    """The port's ADMMParams from any (mu1, mu2, mu3, tau) record."""
    return ADMMParams(*(float(getattr(params, f)) for f in ADMMParams._fields))


def rsplit_precomp(arrays: dict, psf_shape, padded_shape, start,
                   device=None) -> RSplitPrecomp:
    """The port's RSplitPrecomp from the JAX RSplitPrecomp's arrays."""
    device = resolve_device(device)
    return RSplitPrecomp(
        *[_t(arrays[f], device, np.float32) for f in ARRAY_FIELDS],
        psf_shape=tuple(psf_shape), padded_shape=tuple(padded_shape),
        start=tuple(start))


def rsplit_general_precomp(arrays: dict, info: dict, psf_shape, padded_shape, start,
                           device=None):
    """``(pre, info)`` of the port's batched solver (``run_rsplit_general``)
    from the JAX ``precompute_rsplit_general`` result: its stacked
    RSplitPrecomp's arrays (a leading axis over the D * C planes) and its
    info dict."""
    pre = rsplit_precomp(arrays, psf_shape, padded_shape, start, device)
    return pre, {k: int(info[k]) for k in ("batch", "depth", "channels")}


def split_precomp(arrays: dict, psf_shape, padded_shape, start,
                  device=None) -> SplitPrecomp:
    """The port's SplitPrecomp (full-width solver) from the JAX
    SplitPrecomp's arrays: one plane, or a stack on a leading axis."""
    device = resolve_device(device)
    return SplitPrecomp(
        *[_t(arrays[f], device, np.float32) for f in SPLIT_FIELDS],
        psf_shape=tuple(psf_shape), padded_shape=tuple(padded_shape),
        start=tuple(start))


def split_general_precomp(arrays: dict, info: dict, psf_shape, padded_shape, start,
                          device=None):
    """``(pre, info)`` of the port's batched full-width solver
    (``run_split_general``) from the JAX ``precompute_split_general``
    result: its stacked SplitPrecomp's arrays and its info dict."""
    pre = split_precomp(arrays, psf_shape, padded_shape, start, device)
    return pre, {k: int(info[k]) for k in ("batch", "depth", "channels")}


def convolver(H, psf_shape, padded_shape, start, pad, norm, shift_folded,
              device=None) -> FFTConvolver:
    """The port's FFTConvolver from the JAX FFTConvolver's spectrum and
    geometry."""
    device = resolve_device(device)
    return FFTConvolver(H=_t(H, device, np.complex64),
                        psf_shape=tuple(psf_shape),
                        padded_shape=tuple(padded_shape), start=tuple(start),
                        pad=bool(pad), norm=norm,
                        shift_folded=bool(shift_folded))


def admm_precomp(arrays: dict, device=None) -> ADMMPrecomp:
    """The exact solver's ADMMPrecomp from the JAX one's arrays."""
    device = resolve_device(device)
    return ADMMPrecomp(*[_t(arrays[f], device, np.float32)
                         for f in ADMMPrecomp._fields])


def admm_state(arrays: dict, device=None) -> ADMMState:
    """The exact solver's ADMMState from the JAX one's arrays."""
    device = resolve_device(device)
    return ADMMState(*[_t(arrays[f], device, np.float32)
                       for f in ADMMState._fields])


def lpips_state_dict(variables) -> dict:
    """The port's LPIPS ``state_dict`` (``eval.lpips.LPIPS``) from the JAX
    package's LPIPS variables as numpy arrays: the flax tree ``{"params":
    {net: {conv: {"kernel": HWIO, "bias"}}, "lin<i>": (C,)}}`` (or the
    tree under "params").  Kernels become OIHW."""
    params = variables.get("params", variables)
    sd = {}
    for key, value in params.items():
        if isinstance(value, dict):
            for conv, leaves in value.items():
                kernel = np.transpose(np.asarray(leaves["kernel"], np.float32), (3, 2, 0, 1))
                sd[f"{key}.{conv}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
                sd[f"{key}.{conv}.bias"] = torch.from_numpy(np.array(leaves["bias"], np.float32))
        else:
            sd[key] = torch.from_numpy(np.array(value, np.float32).reshape(-1))
    return sd
