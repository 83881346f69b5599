"""Device selection for the port's entry points.

``device=None`` means the CUDA card.  Without one the entry points raise:
they never carry on quietly on the CPU.  The CPU runs only when a caller
asks for it by name (``device="cpu"``), as the parity tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
