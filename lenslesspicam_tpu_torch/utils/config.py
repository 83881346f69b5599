"""Config system for CLI apps (hydra-replacement; copy of
lenslesspicam_tpu/utils/config.py: host code, yaml only, and the port
imports nothing of the JAX package).

The reference binds every script to a Hydra YAML with CLI dotted
overrides and a timestamped run dir with a config snapshot (SURVEY §5.6).
This module reproduces that surface without the hydra dependency:

* ``load_config(path, overrides)`` — YAML + ``key.sub=value`` overrides
  (values parsed as YAML scalars, so numbers/bools/lists work);
* ``config_main(default_config)`` — decorator giving scripts the
  ``python script.py [-cn name] [key=value ...]`` interface;
* each run gets ``outputs/<date>/<time>/`` with a ``config.yaml``
  snapshot (checkpoints can embed their config like the reference's
  ``.hydra/config.yaml``, model_dict.py:309).
"""

from __future__ import annotations

import datetime
import functools
import os
import sys

import yaml


class DotDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name):
        try:
            val = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return DotDict(val) if isinstance(val, dict) and not isinstance(val, DotDict) else val

    __setattr__ = dict.__setitem__

    def get_path(self, dotted, default=None):
        node = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _set_path(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def parse_overrides(args):
    """Parse ``key.sub=value`` CLI tokens; values go through yaml."""
    overrides = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override must be key=value: {arg!r}")
        key, _, raw = arg.partition("=")
        overrides[key] = yaml.safe_load(raw)
    return overrides


def load_config(path=None, overrides=None, defaults=None) -> DotDict:
    cfg: dict = dict(defaults or {})
    if path is not None:
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}

        def merge(dst, src):
            for k, v in src.items():
                if isinstance(v, dict) and isinstance(dst.get(k), dict):
                    merge(dst[k], v)
                else:
                    dst[k] = v

        merge(cfg, loaded)
    for key, value in (overrides or {}).items():
        _set_path(cfg, key, value)
    return DotDict(cfg)


def apply_defaults(cfg: dict, defaults: dict) -> dict:
    """Recursively fill missing keys from a nested defaults dict
    WITHOUT overwriting anything the user set (the deep analog of the
    scripts' per-key setdefault — a CLI override like ``camera.psf=x``
    creates the ``camera`` sub-dict, which must still inherit its other
    defaults)."""
    import copy

    for key, val in defaults.items():
        if key not in cfg or (cfg[key] is None and isinstance(val, dict)):
            cfg[key] = (DotDict(copy.deepcopy(val))
                        if isinstance(val, dict) else val)
        elif isinstance(val, dict) and isinstance(cfg.get(key), dict):
            apply_defaults(cfg[key], val)
    return cfg


def make_run_dir(base="outputs") -> str:
    now = datetime.datetime.now()
    run_dir = os.path.join(base, now.strftime("%Y-%m-%d"), now.strftime("%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def save_config(cfg: dict, run_dir: str):
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(dict(cfg), f)


def config_main(default_config: str | None, config_dir: str | None = None):
    """Decorator: ``@config_main("configs/recon.yaml")`` gives the script
    hydra-like CLI behavior and passes a DotDict config."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(argv=None):
            argv = list(sys.argv[1:] if argv is None else argv)
            cfg_path = default_config
            if "-cn" in argv:
                i = argv.index("-cn")
                name = argv[i + 1]
                del argv[i : i + 2]
                base = config_dir or (os.path.dirname(default_config) if default_config else "configs")
                cfg_path = os.path.join(base, name if name.endswith(".yaml") else name + ".yaml")
            overrides = parse_overrides(argv)
            cfg = load_config(cfg_path, overrides)
            run_dir = make_run_dir(cfg.get("output_dir", "outputs"))
            save_config(cfg, run_dir)
            cfg["run_dir"] = run_dir
            return fn(cfg)

        return wrapper

    return decorator
