"""What the port's CLI apps share: the device they run on and the
repository's ``configs/`` folder, whose YAML both CLIs read.

The JAX apps pick their platform from ``LPT_PLATFORM``; so do these:
``LPT_PLATFORM=cpu`` runs an app on the CPU (the kernels' plain versions),
anything else on the CUDA card, and without a card the app raises before
it reads its config.  There is no quiet fall-back to the CPU.
"""

from __future__ import annotations

import functools
import os

import torch

from .._device import resolve_device
from ..utils.config import config_main

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")


def config_path(name: str) -> str:
    """The path of ``configs/<name>``."""
    return os.path.join(CONFIGS, name)


def app_device(device=None) -> torch.device:
    """``device`` if given; else the CPU under ``LPT_PLATFORM=cpu`` and the
    CUDA card otherwise (raises when there is none)."""
    if device is not None:
        return torch.device(device)
    if os.environ.get("LPT_PLATFORM", "").lower() == "cpu":
        return torch.device("cpu")
    return resolve_device(None)


def app(default_config: str | None):
    """``config_main`` for an app ``fn(config, device)``: the returned
    ``main(argv=None)`` resolves the device first, then parses the config
    and its overrides (``-cn name`` and ``key.sub=value``), makes the
    timestamped run directory and calls ``fn``."""

    def decorator(fn):
        @functools.wraps(fn)
        def main(argv=None):
            device = app_device()
            return config_main(default_config)(lambda config: fn(config, device))(argv)

        return main

    return decorator
