"""Times the port's kernels built from two source trees on one card.

    python3 ab_kernels.py OTHER_CSRC [OTHER_CSRC ...] [--modes headline,f32]
                          [--rounds 2] [--planes 3x3,4x1] [--kernels h_combine_dual]
                          [--probes 5]

A is ``lenslesspicam_tpu_torch/ops/csrc`` of this checkout, B the
directory OTHER_CSRC holding the same sources changed (the same C
entries); with several, B1, B2, ... in the order given.  All are built
with ``nvcc``, the libraries of all trees at once (a library whose
sources match one already built, or another tree's, is compiled once),
then every kernel of
``chip_smoke.kernel_cases`` (a mode of ``chip_smoke.MODES``: headline,
f32) and of ``chip_smoke.split_kernel_cases`` (a mode of
``chip_smoke.SPLIT_MODES``: f32, bench, K4, K5 and K14 among them at the
lane width W as "name:full_width", K4's inverse as
"h_passA_pair:full_width_inverse"; K4's inverse at the v3 lanes is
"h_passA_pair:inverse"; K13 alone in
``chip_smoke.PALLAS_K13_MODES``: pallas_bf16; and of
``chip_smoke.pallas_kernel_cases``, K14-K18 in every form, in a mode of
``PALLAS_AB_MODES``: pallas_io_f32, pallas_io_bf16) is timed at 12 MP in each
mode named, in the order A, B, B, A per round (A, B1 .. Bn, Bn .. B1, A with
several; CUDA events, median of 7 after
a warm-up, as ``chip_smoke.time_ms``), and its output is checked against
the plain version as ``chip_smoke.check_kernels`` checks it.  Each tree's
build prints one JSON line with nvcc's seconds and ptxas's entry
functions, registers and spills per library (libraries already built
print none).  ``--planes``
times the kernels that take a plane axis (``chip_smoke.PLANE_KERNELS``,
the full-width ``chip_smoke.SPLIT_KERNELS`` and ``FULL_WIDTH_H`` and
every pallas case) on stacks of P planes over Pc constant planes instead
of one plane;
``--kernels`` keeps only the kernels named (a wrapper's name keeps its
"name:form" rows too).  Prints one JSON line per
kernel, mode and stack with each tree's median and its ratio to A (with
one other tree also ``a_ms``, ``b_ms`` and ``b_over_a``).  ``--probes N``
then times the bandwidth probe's P1-P3 of every tree on the same 12 MP
plane at f32 and bf16 (br = 16, P3 with 40 constant planes), P1 and P2
also against their PyTorch calls (``x.clone()``, ``torch.mul``), N rounds
of A, B1 .. Bn, library, library, Bn .. B1, A, each tree's output first
held bit-equal to its plain version; one JSON line per probe and dtype,
with ``kernel_over_parent`` (B1 is the parent) beside
``kernel_over_library``.  A mode that names no kernel family (``--modes
none``) times no kernel but the probes and builds only their library.
Last, the card's name and power limit.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from lenslesspicam_tpu_torch.ops import _build, kernels as K, probe_bw as PB


E1_RCARRY_LIB = dict(K._E1_RCARRY_LIB)


def sources(csrc: Path) -> list:
    """The libraries of ``_build.SOURCES`` whose source ``csrc`` holds."""
    return [n for n in _build.SOURCES if (csrc / f"{n}.cu").is_file()]


def use(csrc: Path):
    """Point the wrappers at the libraries built from ``csrc``.  A tree
    that predates K8's three libraries (one a TV carry type) serves every
    TV carry type from its one ``e1_rcarry``."""
    _build.CSRC = csrc
    _build._libs.clear()
    K._entry.cache_clear()
    split = all(n in sources(csrc) for n in E1_RCARRY_LIB.values())
    K._E1_RCARRY_LIB = E1_RCARRY_LIB if split else dict.fromkeys(E1_RCARRY_LIB, "e1_rcarry")


def probe_ab(ph, pw, rounds, trees, labels):
    """The probes P1-P3 of every tree (``--probes``) on one (ph, pw) plane
    at f32 and bf16 (br = 16, P3 with 40 constant planes), each tree's
    output first held bit-equal to the plain version: medians of
    ``rounds`` rounds of A, B1 .. Bn, library, library, Bn .. B1, A (P3
    has no library call).  B1 is the parent."""
    for io in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(ph)
        cases = cs.probe_kernel_cases(ph, pw, gen, io)
        for name, (inputs, *_) in cases.items():
            kernel, plain = getattr(PB, name), getattr(PB, name + "_plain")
            ref = cs.bits(plain(*inputs))
            for label, tree in trees.items():
                use(tree)
                if not torch.equal(cs.bits(kernel(*inputs)), ref):
                    raise AssertionError(f"{name} ({io}, {label}): not bit-equal to its plain "
                                         "version")
            lib_name, lib = cs.probe_library(name)
            lib_calls = ["library", "library"] if lib else []
            times = {label: [] for label in (*trees, *lib_calls)}
            for _ in range(rounds):
                for label in ("A", *labels, *lib_calls, *labels[::-1], "A"):
                    if label == "library":
                        times[label].append(cs.time_ms(lambda: lib(inputs[0])))
                    else:
                        use(trees[label])
                        times[label].append(cs.time_ms(lambda: kernel(*inputs)))
            med = {label: statistics.median(ts) for label, ts in times.items()}
            x = inputs[0]
            print(json.dumps({"probe": cs.KERNEL_INFO[name][0], "name": name,
                              "dtype": str(io).removeprefix("torch."), "grid": [ph, pw],
                              "br": inputs[1], "design": PB.design(name, *x.shape,
                                                                   x.element_size(),
                                                                   inputs[1]),
                              "library": lib_name, "kernel_ms": med["A"],
                              "parent_ms": med[labels[0]],
                              "library_ms": med.get("library"),
                              "kernel_over_parent": med["A"] / med[labels[0]],
                              "kernel_over_library": med["A"] / med["library"] if lib else None,
                              "ms": med, "over_a": {k: m / med["A"] for k, m in med.items()},
                              "times": times}), flush=True)
    use(trees["A"])


# chip_smoke.PALLAS_MODES under names of their own, so that the default
# modes (headline, f32) leave the pallas family out
PALLAS_AB_MODES = {f"pallas_io_{m}": dts for m, dts in cs.PALLAS_MODES.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other_csrc", type=Path, nargs="+")
    ap.add_argument("--modes", default="headline,f32")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--planes", default="", help="stacks PxPc, comma separated")
    ap.add_argument("--kernels", default="", help="kernel names, comma separated")
    ap.add_argument("--probes", type=int, default=0,
                    help="rounds of P1-P3 of every tree, P1 and P2 beside their library "
                         "calls (0: none)")
    args = ap.parse_args()
    stacks = [tuple(int(n) for n in st.split("x")) for st in args.planes.split(",") if st]
    keep = set(args.kernels.split(",")) - {""}
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    others = [p.resolve() for p in args.other_csrc]
    labels = ["B"] if len(others) == 1 else [f"B{i + 1}" for i in range(len(others))]
    trees = {"A": _build.CSRC, **dict(zip(labels, others))}
    ph, pw = 6144, 8192
    # (modes, cases, the kernels timed on a stack or in the K13 mode; None: all)
    families = ((cs.MODES, cs.kernel_cases, cs.PLANE_KERNELS),
                (cs.SPLIT_MODES, cs.split_kernel_cases, cs.SPLIT_KERNELS + cs.FULL_WIDTH_H),
                (cs.PALLAS_K13_MODES, cs.split_kernel_cases, ("ifft_w",)),
                (PALLAS_AB_MODES, cs.pallas_kernel_cases, None))
    runs = [(m, st, fam) for m in args.modes.split(",") for st in stacks or [None]
            for fam in families if m in fam[0]]
    # with no mode that names a kernel family, only the probes' library
    logs = _build.build_jobs([(n, tree) for tree in trees.values() for n in sources(tree)
                              if runs or n == "probe_bw"])
    for label, tree in trees.items():
        built = {n: r for (n, c), r in sorted(logs.items()) if c == tree}
        print(json.dumps({"tree": label, "csrc": str(tree), "seconds_by_library": {
            n: r["seconds"] for n, r in built.items()}, "ptxas": {
            n: [ln.strip() for ln in r["log"].splitlines()
                if any(w in ln for w in ("entry function", "registers", "spill"))]
            for n, r in built.items()}}), flush=True)
    for mode, planes, (modes, case_fn, names) in runs:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(ph)
        cases = case_fn(ph, pw, gen, *modes[mode], planes=planes)
        for name, (inputs, _) in cases.items():
            fn = name.split(":")[0]     # "name:form": the wrapper ``name`` at another shape
            if (names is not None and name not in names
                    and (planes or modes is cs.PALLAS_K13_MODES)) or (
                    keep and fn not in keep and name not in keep):
                continue
            wrapper, plain = getattr(K, fn), getattr(K, fn + "_plain")
            ref = plain(*inputs)
            times = {label: [] for label in trees}
            for _ in range(args.rounds):
                for label in ("A", *labels, *labels[::-1], "A"):
                    use(trees[label])
                    errs = [cs.out_err(a, b) for a, b in
                            zip(cs.flatten(wrapper(*inputs)), cs.flatten(ref))]
                    if not all(e[3] for e in errs):
                        raise AssertionError(f"{name} ({mode}, {label}): errors {errs}")
                    times[label].append(cs.time_ms(lambda: wrapper(*inputs)))
            med = {label: statistics.median(ts) for label, ts in times.items()}
            ab = ({"a_ms": med["A"], "b_ms": med["B"], "b_over_a": med["B"] / med["A"]}
                  if "B" in med else {})
            print(json.dumps({"kernel": name, "mode": mode, "grid": [ph, pw],
                              "planes": list(planes) if planes else None, **ab, "ms": med,
                              "over_a": {label: m / med["A"] for label, m in med.items()},
                              "times": times}), flush=True)
    if args.probes:
        probe_ab(ph, pw, args.probes, trees, labels)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
