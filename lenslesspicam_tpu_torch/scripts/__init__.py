"""The CLI apps of the port: ``recon``, ``eval`` and ``sim``, each module
the counterpart of the script of the same path under the repository's
``scripts/``.

    python -m lenslesspicam_tpu_torch.scripts.<group>.<name> [key=value ...]

Each app reads the same YAML of ``configs/`` (or the same defaults) as its
JAX script, takes the same dotted overrides and prints the same lines; it
runs on the CUDA card, or on the CPU with ``LPT_PLATFORM=cpu``
(``_common.app_device``).
"""
