"""Training observability hooks (port of lenslesspicam_tpu/train/loggers.py,
host code copied; reference: the wandb stream in
lensless/recon/utils.py:729-733, 1228-1307).

The Trainer accepts a list of *loggers* — callables with the
wandb-compatible signature ``logger(data: dict, step: int)`` where
``data`` maps scalar names (and, for per-epoch example images, file
paths under ``"examples_dir"``) to values.  Anything callable works;
the adapters below cover the common cases:

* :class:`WandbLogger` — forwards to ``wandb.log`` when the ``wandb``
  package is installed (it is imported when the logger is made; the
  class raises a clear ImportError without it, keeping the dependency
  optional exactly like the reference's ``wandb_project`` flag);
* :class:`CSVLogger` — appends one row per call to a CSV file, columns
  grown on first sight of a new key;
* plain functions / lambdas — e.g. ``lambda d, s: print(s, d)``.

The Trainer itself always writes ``train_log.jsonl`` + ``metrics.json``
(the local equivalents), so loggers are purely additive sinks.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

# Signature every Trainer logger must satisfy.
Logger = Callable[[Dict, int], None]


class WandbLogger:
    """Forward scalars to Weights & Biases (reference utils.py:729-733).

    Parameters mirror ``wandb.init``; the import is deferred so the
    framework has no hard wandb dependency.
    """

    def __init__(self, project: str, config: Optional[dict] = None, **init_kwargs):
        try:
            import wandb
        except ImportError as e:  # pragma: no cover - wandb not in env
            raise ImportError(
                "WandbLogger requires the 'wandb' package (pip install wandb)"
            ) from e
        self._wandb = wandb
        self._run = wandb.init(project=project, config=config, **init_kwargs)

    def __call__(self, data: Dict, step: int) -> None:  # pragma: no cover
        self._wandb.log(data, step=step)

    def finish(self) -> None:  # pragma: no cover - wandb not in env
        self._run.finish()


class CSVLogger:
    """Append one row per call to ``path``; header grows as new keys
    appear (rows logged before a key existed leave the column empty)."""

    def __init__(self, path: str):
        self.path = path
        self._keys: list = ["step"]
        self._rows: list = []

    def __call__(self, data: Dict, step: int) -> None:
        row = {"step": step}
        for k, v in data.items():
            if isinstance(v, (int, float)):
                row[k] = v
                if k not in self._keys:
                    self._keys.append(k)
        self._rows.append(row)
        self._flush()

    def _flush(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            f.write(",".join(self._keys) + "\n")
            for row in self._rows:
                f.write(",".join(str(row.get(k, "")) for k in self._keys) + "\n")
