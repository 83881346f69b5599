"""Device selection and input conversion for the port's entry points.

``device=None`` means the CUDA card.  Without one the entry points raise:
they never carry on quietly on the CPU.  The CPU runs only when a caller
asks for it by name (``device="cpu"``), as the parity tests do.

The entry points take numpy arrays, array-likes and tensors on any
device, as the reference takes its own device arrays.  A tensor is
detached first: the solvers are not differentiated through (the reference
entry points take plain arrays too), and an n-iteration solve would
otherwise build an autograd graph.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def same_device(device: torch.device, *tensors) -> None:
    """Raise unless every tensor lies on ``device``, the device of the
    module or convolver it is fed to, as a PyTorch layer raises: the port
    never copies an input across devices to suit a module."""
    for t in tensors:
        if t.device != device:
            raise RuntimeError(
                f"expected a tensor on {device}, got one on {t.device}: move the "
                "input, or the module with .to(), so that both lie on one device")


def module_input(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor for a module whose tensors lie on
    ``device`` (taken from one of them): an array-like is placed there, a
    tensor must lie there already (:func:`same_device`) and keeps its
    autograd graph.  ``dtype=None`` keeps a tensor's dtype."""
    if isinstance(x, torch.Tensor):
        same_device(device, x)
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype or torch.float32).to(device)


def as_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``: a tensor is detached and
    moved without a round trip through the host, anything else goes
    through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(x.detach(), dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def as_host(x, dtype=np.float32) -> np.ndarray:
    """``x`` as a ``dtype`` numpy array on the host, for the float64 host
    precomputes: a tensor on any device is detached and copied over."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, dtype)


def as_tensor(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """``x`` as a tensor for the functional entry points (metrics, noise,
    solvers' inputs): a tensor stays on its device and in its autograd
    graph unless ``device`` names another; anything else is placed on
    ``resolve_device(device)``.  ``dtype=None`` keeps a tensor's dtype (and
    makes float32 of anything else)."""
    if isinstance(x, torch.Tensor):
        dev = None if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype or torch.float32).to(
        resolve_device(device))
