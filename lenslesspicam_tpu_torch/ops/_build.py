"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
library file name carries a hash of the flags, of the source and of the
``csrc`` headers it includes (directly or through another header), so a
library whose source or headers changed is rebuilt and any other is
reused.
All missing libraries are compiled together, one ``nvcc`` process per
source, each timed.  Importing this module runs nothing; ``nvcc`` starts
only on the first :func:`load` or :func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("rfft_w", "irfft_w", "e1_rtv", "h_pass_a", "h_combine", "w_dual_state",
           "sat_scan", "e1_rcarry", "e1_rcarry_tv_bf16", "e1_rcarry_tv_i16", "irfft_w_dual",
           "e1_carry", "ifft_w_dual", "fft_w", "ifft_w", "h_pass_b", "probe_bw")
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _inputs(name: str, csrc: Path | None = None) -> list:
    """``<csrc>/<name>.cu`` (default ``CSRC``) and every header of that
    directory it includes, directly or through another header, sorted by
    name."""
    csrc = csrc or CSRC
    seen, todo = set(), [csrc / f"{name}.cu"]
    while todo:
        p = todo.pop()
        if p not in seen:
            seen.add(p)
            todo += [csrc / h for h in _INCLUDE.findall(p.read_text()) if (csrc / h).is_file()]
    return sorted(seen)


def lib_path(name: str, csrc: Path | None = None) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in _inputs(name, csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(nvcc: str, name: str, csrc: Path) -> dict:
    path = lib_path(name, csrc)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {"seconds": time.perf_counter() - t0, "log": res.stdout, "ok": res.returncode == 0}
    if out["ok"]:
        os.replace(tmp, path)
    return out


def build_jobs(jobs) -> dict:
    """Compile the libraries of ``jobs``, (name, csrc directory) pairs,
    that are not built yet, all at once (a library whose sources match
    another job's is compiled once).  Returns {(name, csrc): {"seconds",
    "log", "ok"}} for the ones it compiled; raises with the compiler's
    output if any fails."""
    todo = {}
    for name, csrc in jobs:
        path = lib_path(name, csrc)
        if not path.exists() and all(lib_path(*j) != path for j in todo):
            todo[(name, csrc)] = None
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        done = dict(zip(todo, pool.map(lambda j: _compile(nvcc, *j), todo)))
    failed = [j for j, r in done.items() if not r["ok"]]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(f"{c}/{n}.cu" for n, c in failed)
                           + ":\n" + "\n".join(done[j]["log"] for j in failed))
    return done


def build_all(names=SOURCES) -> dict:
    """Compile every library in ``names`` (from ``CSRC``) that is not built
    yet, all at once.  Returns {name: {"seconds", "log", "ok"}} for the
    ones it compiled; raises with the compiler's output if any fails."""
    return {n: r for (n, _), r in build_jobs([(n, CSRC) for n in names]).items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _libs:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]
