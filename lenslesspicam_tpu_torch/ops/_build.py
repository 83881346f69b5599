"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
library file name carries a hash of the flags and of every source and
header, so a changed source is rebuilt and an unchanged one is reused.
All missing libraries are compiled together, one ``nvcc`` process per
source, each timed.  Importing this module runs nothing; ``nvcc`` starts
only on the first :func:`load` or :func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("rfft_w", "irfft_w", "e1_rtv", "h_pass_a", "h_combine", "w_dual_state",
           "sat_scan", "e1_rcarry", "irfft_w_dual", "e1_carry", "ifft_w_dual", "fft_w",
           "ifft_w", "h_pass_b", "probe_bw")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(nvcc: str, name: str) -> dict:
    tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {"seconds": time.perf_counter() - t0, "log": res.stdout, "ok": res.returncode == 0}
    if out["ok"]:
        os.replace(tmp, lib_path(name))
    return out


def build_all(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, all at
    once.  Returns {name: {"seconds", "log", "ok"}} for the ones it
    compiled; raises with the compiler's output if any fails."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        done = dict(zip(todo, pool.map(lambda n: _compile(nvcc, n), todo)))
    failed = [n for n, r in done.items() if not r["ok"]]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(done[n]["log"] for n in failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _libs:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]
