"""The port's bandwidth probe (port of scripts/dev/_probe_bw.py): three
streaming kernels over a plane, timed by the difference method, to
measure the rate at which the port's CUDA kernels can stream device
memory on this card.

    python3 -m lenslesspicam_tpu_torch.ops.probe_bw [mul|pure|consts]

| wrapper | TPU kernel it replaces | CUDA source |
|---|---|---|
| ``pure_copy_plane`` (P1) | ``pure_copy_plane`` / ``_pure_copy_kernel`` | ``csrc/probe_bw.cu`` |
| ``copy_plane`` (P2) | ``copy_plane`` / ``_copy_kernel`` | ``csrc/probe_bw.cu`` |
| ``copy_plane_consts`` (P3) | ``copy_plane_consts`` / ``_copy_kernel_consts`` | ``csrc/probe_bw.cu`` |

As in ``kernels``: a wrapper given a CPU tensor runs its plain version
(``*_plain``); given a CUDA tensor it launches its kernel on the current
stream or raises, and counts the launch in its ``launches`` attribute.
``br`` is the Pallas row block (rows % br == 0, else ValueError).  The
three are a bulk-copy stream through shared memory (csrc/probe_bw.cu):
the plane's bytes in chunks of ``CHUNK_BYTES``, one chunk a thread block
of ``STREAM_THREADS`` threads (grid = the chunks, dealt to the SMs by the
hardware), each brought in and written back by Hopper's bulk copies;
``br`` sets no grid.  P3's blocks read the one element c_k[0, 0] of each
constant plane that its function uses, while their chunk is in flight.
:func:`stream_plan` and :func:`chunks` mirror the kernel's constants and
chunks, and :func:`design` names each probe's design on a plane.

``main`` runs the JAX script's three modes on the 12 MP padded grid
(6144 x 8192; :func:`sweep`): ``mul`` (the default) P2 at f32, bf16 and
f16, ``pure`` P1 at those and i32, ``consts`` P3 at bf16 with 4 and 40
constant planes, each at br = 16 and 32.  It prints each reading's time
per call and its rate in GB/s, counting two plane-bytes a call (one read,
one write) as the JAX script does, then the card's name and power limit.
It needs a CUDA card.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import _build
from .kernels import _check, _empty, _launch, _on_card

PLANE = (6144, 8192)        # the 12 MP padded grid (scripts/dev/_probe_bw.py:16)
BRS = (16, 32)
N_CONSTS = (4, 40)
CONST_PLANE = (128, 128)    # one constant operand of P3, f32
SCALE = 1.0001              # P2's factor, rounded to f32 where it multiplies
_F32, _BF16, _F16, _I32 = torch.float32, torch.bfloat16, torch.float16, torch.int32
_CODE = {_F32: 0, _BF16: 1, _F16: 3, _I32: 4}     # type codes of the C entries
COPY_DTYPES = (_F32, _BF16, _F16, _I32)           # P1
FLOAT_DTYPES = (_F32, _BF16, _F16)                # P2, P3

# the probes' chunks, as csrc/probe_bw.cu sets them
CHUNK_BYTES = 16384         # a chunk, a block's stage
STREAM_THREADS = 512        # threads a block
BAR_BYTES = 128             # the block's mbarrier, before its stage
SM_THREADS = 2048           # threads an H100 SM holds


def stream_plan(nbytes: int) -> dict:
    """The probes' launch on a plane of ``nbytes`` bytes (whole 16-byte
    words): the chunk, the number of chunks, the grid (one block a chunk)
    and the stages of an SM, its resident blocks (as many as its threads
    hold; their shared memory, BAR_BYTES + CHUNK_BYTES each and P3's
    4 STREAM_THREADS bytes of scalars, fits)."""
    n_chunks = -(-nbytes // CHUNK_BYTES)
    return {"chunk": CHUNK_BYTES, "n_chunks": n_chunks, "grid": n_chunks,
            "stages": SM_THREADS // STREAM_THREADS}


def chunks(nbytes: int) -> list:
    """The chunks of a plane of ``nbytes`` bytes that blocks 0, 1, ...
    stream: [(byte offset, bytes)], the last one ragged."""
    return [(off, min(CHUNK_BYTES, nbytes - off)) for off in range(0, nbytes, CHUNK_BYTES)]


def design(name, rows, w, itemsize, br) -> dict:
    """How the probe ``name`` streams a (rows, w) plane of ``itemsize``-byte
    elements (``br`` checked by the wrappers, not used): in bulk chunks
    (:func:`stream_plan`), with the chunk, an SM's stages, the grid's
    thread blocks and the threads a block; P3's blocks also read one
    scalar of each constant plane ("scalars": "c_k[0, 0]")."""
    plan = stream_plan(rows * w * itemsize)
    return {"design": "bulk chunks", "chunk": plan["chunk"], "stages": plan["stages"],
            "blocks": plan["grid"], "threads": STREAM_THREADS,
            **({"scalars": "c_k[0, 0]"} if name == "copy_plane_consts" else {})}


def _plane_rows(name, x, br, dtypes):
    """(rows, w) of the 2-D plane ``x`` streamed in blocks of ``br`` rows;
    raises TypeError / ValueError where it is not one."""
    _check(name, [x], dtypes=dtypes)
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a (rows, w) plane, got {tuple(x.shape)}")
    rows, w = x.shape
    if br <= 0 or rows % br:
        raise ValueError(f"{name}: {rows} rows are not whole blocks of {br}")
    return rows, w


def _card(name, x, dtypes, others=()):
    """True for a CUDA plane the kernels take (rows of whole 16-byte
    words besides ``kernels._on_card``'s checks, which ``others`` pass
    too), False for a CPU one."""
    cuda = _on_card(name, [x, *others], (x.dtype,), {(d,) for d in dtypes})
    if cuda and (x.shape[-1] * x.element_size()) % 16:
        raise ValueError(f"{name}: a row of {x.shape[-1]} {x.dtype} is not whole 16-byte words")
    return cuda


def pure_copy_plane_plain(x, br):
    return x.clone()


def pure_copy_plane(x, br):
    """P1: o = x in bulk chunks; f32, bf16, f16 or i32 (``br`` checked,
    as for every probe)."""
    name = "pure_copy_plane"
    rows, w = _plane_rows(name, x, br, COPY_DTYPES)
    if not _card(name, x, COPY_DTYPES):
        return pure_copy_plane_plain(x, br)
    o = _empty(x.shape, x)
    _launch("probe_bw", "lpt_pure_copy_plane", "ppiiii", x, o, rows, w, br, _CODE[x.dtype])
    pure_copy_plane.launches += 1
    return o


def copy_plane_plain(x, br):
    return (x.to(_F32) * SCALE).to(x.dtype)


def copy_plane(x, br):
    """P2: o = (f32(x) * 1.0001) stored at x's dtype (one f32 multiply,
    one round to nearest even), in bulk chunks; f32, bf16 or f16 (``br``
    checked)."""
    name = "copy_plane"
    rows, w = _plane_rows(name, x, br, FLOAT_DTYPES)
    if not _card(name, x, FLOAT_DTYPES):
        return copy_plane_plain(x, br)
    o = _empty(x.shape, x)
    _launch("probe_bw", "lpt_copy_plane", "ppiiii", x, o, rows, w, br, _CODE[x.dtype])
    copy_plane.launches += 1
    return o


def copy_plane_consts_plain(x, br, consts):
    bump = sum(c[0, 0] for c in consts) * 0.0
    return (x.to(_F32) + bump).to(x.dtype)


def copy_plane_consts(x, br, consts):
    """P3: o = f32(x) + 0 * sum_k c_k[0, 0] stored at x's dtype, the sum
    in f32 from k = 0 over the n constant planes ``consts`` (an (n, 128,
    128) f32 stack), in bulk chunks, each block reading the n scalars
    c_k[0, 0] (``br`` checked); x is f32, bf16 or f16.  For finite
    constants whose sum does not overflow, o is x up to the sign of a
    zero; else every element is NaN."""
    name = "copy_plane_consts"
    rows, w = _plane_rows(name, x, br, FLOAT_DTYPES)
    _check(name, [consts], dtypes=(_F32,))
    if consts.dim() != 3 or tuple(consts.shape[1:]) != CONST_PLANE:
        raise ValueError(f"{name}: constants must be (n, 128, 128), got {tuple(consts.shape)}")
    if not _card(name, x, FLOAT_DTYPES, (consts,)):
        return copy_plane_consts_plain(x, br, consts)
    o = _empty(x.shape, x)
    _launch("probe_bw", "lpt_copy_plane_consts", "pppiiiii", x, o, consts, consts.shape[0],
            rows, w, br, _CODE[x.dtype])
    copy_plane_consts.launches += 1
    return o


WRAPPERS = (pure_copy_plane, copy_plane, copy_plane_consts)
for _w in WRAPPERS:
    _w.launches = 0

KERNELS = SimpleNamespace(**{w.__name__: w for w in WRAPPERS})
PLAIN = SimpleNamespace(**{w.__name__: globals()[w.__name__ + "_plain"] for w in WRAPPERS})


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


# ---------------------------------------------------------------------------
# timing and the JAX script's sweeps
# ---------------------------------------------------------------------------


def _sync(x):
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def timed(fn, x, gbytes, base=2, full=52, reps=3, clock=time.perf_counter):
    """Time per call of ``fn`` (a plane in, the next plane out) by the
    difference method of scripts/dev/_probe_bw.py:45-55: after one warm-up
    loop, ``reps`` pairs of a loop of ``full`` calls and one of ``base``
    calls, each chaining output into input and synchronised at both ends;
    the best (t_full - t_base) / (full - base).  Returns {"ms": time per
    call, "gb_per_s": ``gbytes`` over it, "calls": the calls of ``fn`` made,
    warm-up included}.  A pair whose full loop did not take longer than its
    base loop is no reading; with none left the clock does not scale with
    the work, and it raises."""
    calls = 0

    def loop(n):
        nonlocal calls
        s = x
        for _ in range(n):
            s = fn(s)
        calls += n
        _sync(s)

    _sync(x)
    loop(base)
    best = math.inf
    for _ in range(reps):
        t0 = clock()
        loop(full)
        t1 = clock()
        loop(base)
        t2 = clock()
        d = ((t1 - t0) - (t2 - t1)) / (full - base)
        if d > 0:
            best = min(best, d)
    if best == math.inf:
        raise RuntimeError("timed: no loop pair scaled with its number of calls")
    return {"ms": best * 1e3, "gb_per_s": gbytes / best, "calls": calls}


def sweep(which):
    """The readings of one mode of the JAX script (its ``main`` and
    ``main_consts``): (wrapper name, dtype, br, number of constant planes
    or None)."""
    if which == "consts":
        return [("copy_plane_consts", _BF16, br, n) for n in N_CONSTS for br in BRS]
    if which not in ("mul", "pure"):
        raise ValueError(f"probe_bw: mode {which!r} is not one of mul, pure, consts")
    name, dtypes = ("pure_copy_plane", COPY_DTYPES) if which == "pure" else \
        ("copy_plane", FLOAT_DTYPES)
    return [(name, d, br, None) for d in dtypes for br in BRS]


def plane(dtype, device, seed=0):
    """A seeded 12 MP plane at ``dtype``: uniform [0, 1), and for i32
    uniform integers in [0, 100) (the JAX script's data)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.rand(PLANE, generator=gen, device=device)
    return (x * 100).to(_I32) if dtype == _I32 else x.to(dtype)


def const_planes(n, device):
    """The n (128, 128) f32 constant planes of P3: ones, as in the JAX
    script."""
    return torch.ones((n,) + CONST_PLANE, dtype=_F32, device=device)


def step(name, br, consts=None, ops=None):
    """The probe ``name`` as a function of one plane (the chained call of
    :func:`timed`), through ``ops`` (default the wrappers; ``PLAIN`` for
    the plain versions)."""
    fn = getattr(ops or KERNELS, name)
    if name == "copy_plane_consts":
        return lambda s: fn(s, br, consts)
    return lambda s: fn(s, br)


def plane_gbytes(x):
    """The GB a call moves, as the JAX script counts it: the plane read
    and written once."""
    return 2 * x.numel() * x.element_size() / 1e9


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "mul"
    configs = sweep(which)
    if not torch.cuda.is_available():
        print("probe_bw: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all(("probe_bw",))
    for name, dtype, br, n in configs:
        x = plane(dtype, "cuda")
        consts = const_planes(n, "cuda") if n is not None else None
        r = timed(step(name, br, consts), x, plane_gbytes(x))
        label = f"{which} {str(dtype).removeprefix('torch.')} br={br}" + \
            (f" consts={n}" if n is not None else "")
        print(f"{label}: {r['ms']:.3f} ms/call -> {r['gb_per_s']:.0f} GB/s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
