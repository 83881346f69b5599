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
