"""K8's and K9's radix designs (the v2 placement's kernels) modelled on the CPU.

- K8 ``e1_rcarry`` (csrc/e1_rcarry.cuh): two blocks of T = M / 16 threads
  a row (grid rows x 2).  Block 0 is K3's radix design: ``tv_pass0``
  gives rk_even[j] + i rk_odd[j] at the thread's pass-0 positions j = t +
  T r and ``fft::rfft_core`` transforms it from the registers.  Block 1 is
  K6's tail: ``xv_pass0`` loads fwd, v, the mask row (plane p % Pc) and dp
  at j and M + j, stores v' and leaves the f32 v' (before quantization) as
  v'_even[j] + i v'_odd[j] in the registers for ``rfft_core``.
- K9 ``irfft_w_dual`` (csrc/irfft_w_dual.cu): K2's radix design once for
  each spectrum, one block a row and spectrum: ``fft::irfft_row`` of a0
  (lane 0 replaced by p0) stored as image by ``store_split_row``, of a1
  (p1) into fwd.

The models compute the registers from the kernels' own index reads in
f32 (tests/test_torch_tv_radix.py's ``model_tv_pass0`` for the TV step),
write them into a row at their positions and run the existing numpy
models of the radix transforms (tests/test_torch_rfft_radix.py's
``model_rfft_w``, tests/test_torch_irfft_radix.py's ``model_irfft_row``).
They are held to the JAX package's ``e1_rcarry`` and ``irfft_w_dual`` in
interpret mode, in f32 and with 2-byte storage, and to the port's plain
versions on a 6-over-3 stack, so an index, wrap, order or scale mistake
shows here before the kernels reach a card.  The C entries' length
switches, K8's three libraries and the wrappers' card path are checked
against the Python rules.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lenslesspicam_tpu.ops import pallas_kernels2 as pk2

from lenslesspicam_tpu_torch.ops import _build, kernels as K
from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from test_torch_irfft_radix import model_irfft_row
from test_torch_modes import JDT, _check, _pair
from test_torch_rfft_radix import model_rfft_w
from test_torch_tv_radix import (_row, _spectrum_check, model_tv_pass0, pass0_positions,
                                 xv_update)
from test_torch_v2 import _k8_inputs

P = tsplit.ADMMParams()
# f32 spectra: max |model - reference| / max |reference| of each row (the
# bound chip_smoke.py holds the kernels to); against the port's plain
# versions on a stack 1e-5 (the f32 round-off of two transform orders).
# Stored carries and 2-byte planes: test_torch_modes' ``_check``
# (tests/test_torch_tv_radix.py's tolerances).
TOL_KERNEL = 1e-4
TOL_PLAIN = 1e-5
MODEL_MS = (64, 256, 4096)
ROWS = 8                      # one Pallas block: the halo rows wrap inside it
STACK = (6, 3)                # P planes over Pc mask planes
CSRC = Path(K.__file__).parent / "csrc"
F32 = np.float32
# (io, carry_tv, carry_v) of the K8 cases against Pallas: f32, the headline
# mode, and mixed carries (each io with each carry type once)
K8_SAMPLE = [("f32", "f32", "f32"), ("bf16", "i16", "i16"), ("bf16", "bf16", "f32"),
             ("f32", "i16", "bf16")]


@pytest.fixture
def jax_modes(monkeypatch):
    """Pallas in interpret mode; returns a setter of the JAX storage
    globals that ``e1_rcarry`` and ``irfft_w_dual`` read at call time."""
    pk2._set_interpret(True)

    def set_modes(io="f32", tv="f32", v="f32"):
        monkeypatch.setattr(pk2, "_IO_DTYPE", JDT[io])
        monkeypatch.setattr(pk2, "_CARRY_TV_DTYPE", JDT[tv])
        monkeypatch.setattr(pk2, "_CARRY_V_DTYPE", JDT[v])

    try:
        yield set_modes
    finally:
        pk2._set_interpret(False)


def model_xv_pass0(fwd, v, mask_rows, dp):
    """``xv_pass0`` on (rows, 2M) f32 planes (``mask_rows`` the mask row
    each row reads, v the stored carry's f32 value) -> (x, v'): x (rows,
    T, 16) the registers v'_even[j] + i v'_odd[j] before quantization, v'
    written at the positions the threads store."""
    m = fwd.shape[-1] // 2
    j = pass0_positions(m)
    vn = np.full(fwd.shape, np.nan, F32)
    for q in (j, m + j):
        vn[:, q] = xv_update(fwd[:, q], v[:, q], mask_rows[:, q], dp[:, q])
    return (vn[:, j] + 1j * vn[:, m + j]).astype(np.complex64), vn


def model_e1_rcarry(img, fwd, v, b, a0, a1, mask_rows, dp, ph):
    """K8's radix design on f32 planes -> (rkr, rki, vwr, vwi, v', a0',
    a1', b') in f32, before the stores' rounding: rk's registers through
    K1's model, then v''s."""
    m = img.shape[-1] // 2
    rk, a0o, a1o, bo, _ = model_tv_pass0(img, a0, a1, b, ph, natural=False)
    rkr, rki = model_rfft_w(_row(rk, m, natural=False))
    x, vn = model_xv_pass0(fwd, v, mask_rows, dp)
    vwr, vwi = model_rfft_w(_row(x, m, natural=False))
    return rkr, rki, vwr, vwi, vn, a0o, a1o, bo


def model_irfft_w_dual(a0r, a0i, a1r, a1i, p0, p1):
    """K9's radix design in f32: image = irfft_row(a0, z0 = p0), fwd =
    irfft_row(a1, z0 = p1), the complex patch columns one value a row."""
    return model_irfft_row(a0r, a0i, p0), model_irfft_row(a1r, a1i, p1)


def _row_errs(a, b):
    return np.abs(a - b).max(axis=-1) / np.abs(b).max(axis=-1)


# ---------------------------------------------------------------------------
# the register X / v step alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", (64, 512))
def test_xv_registers_are_the_xv_step(m):
    """xv_pass0's registers and stores at every position equal the port's
    row-wise X / v step (``kernels._xv_step``) on a stack over a 2-plane
    mask (plane p reads mask plane p % 2), and cover the row once."""
    rng = np.random.RandomState(11 + m)
    ph, n = 3, 2 * m
    shape = (4, ph, n)
    mask = (rng.rand(2, ph, n) > 0.5).astype(F32)
    fwd = rng.randn(*shape).astype(F32)
    v = (P.mu1 * rng.randn(*shape)).astype(F32)
    dp = (mask[np.arange(4) % 2] * rng.rand(*shape)).astype(F32)
    mask_rows = mask[np.arange(4) % 2].reshape(4 * ph, n)
    x, vn = model_xv_pass0(fwd.reshape(-1, n), v.reshape(-1, n), mask_rows, dp.reshape(-1, n))
    ref = K._xv_step(torch.from_numpy(fwd), torch.from_numpy(v), torch.from_numpy(mask),
                     torch.from_numpy(dp), P.mu1).reshape(-1, n).numpy()
    assert not np.isnan(vn).any()
    assert np.abs(vn - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.array_equal(_row(x, m, natural=False), vn)


# ---------------------------------------------------------------------------
# the models against the Pallas kernels and the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("io,tv,v", K8_SAMPLE)
@pytest.mark.parametrize("m", MODEL_MS)
def test_k8_model_matches_pallas(jax_modes, m, io, tv, v):
    """K8's radix model against the Pallas ``e1_rcarry`` (ROWS rows, one
    periodic plane), data only inside the support mask, v of order mu1,
    carries at their KKT scale; each output in its storage dtype."""
    jax_modes(io=io, tv=tv, v=v)
    rng = np.random.RandomState(40 + m.bit_length() + 7 * K8_SAMPLE.index((io, tv, v)))
    ins = _k8_inputs(rng, io, tv, v, shape=(ROWS, 2 * m))
    ref = pk2.e1_rcarry(*(j for j, _ in ins), P.mu1, P.mu2, P.mu3, P.tau, block_rows=ROWS)
    img, fwd, vc, b, a0, a1, mask, dp = (t for _, t in ins)
    sc_a, sc_b = K._tv_scales(P.mu2, P.mu3, P.tau)
    f = lambda t: t.float().numpy()
    outs = model_e1_rcarry(f(img), f(fwd), K._load_carry(vc, K._v_scale(P.mu1)).numpy(),
                           K._load_carry(b, sc_b).numpy(), K._load_carry(a0, sc_a).numpy(),
                           K._load_carry(a1, sc_a).numpy(), f(mask), f(dp), ph=ROWS)
    for o, r in zip(outs[:4], ref[:4]):
        _spectrum_check(o, r)
    _check(K.encode_v(torch.from_numpy(outs[4]), P.mu1, vc.dtype), ref[4])
    for o, like, scale, r in zip(outs[5:], (a0, a1, b), (sc_a, sc_a, sc_b), ref[5:]):
        _check(K._store_carry(torch.from_numpy(o), like.dtype, scale), r)


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("m", MODEL_MS)
def test_k9_model_matches_pallas(jax_modes, m, io):
    """K9's radix model against the Pallas ``irfft_w_dual`` (the port's
    (rows,) columns are the JAX kernel's (m, 128) column operands' column
    0, the only one it reads); image and fwd in the io dtype."""
    jax_modes(io=io)
    rng = np.random.RandomState(50 + m.bit_length())
    spec = [_pair(rng.randn(ROWS, m).astype(F32), io) for _ in range(4)]
    cols = [rng.randn(ROWS).astype(F32) for _ in range(4)]
    jcols = [jnp.asarray(np.pad(c[:, None], ((0, 0), (0, 127)))) for c in cols]
    ref = pk2.irfft_w_dual(*(j for j, _ in spec), *jcols, block_rows=ROWS)
    f32 = [t.float().numpy() for _, t in spec]
    outs = model_irfft_w_dual(*f32, cols[0] + 1j * cols[1], cols[2] + 1j * cols[3])
    for o, r in zip(outs, ref):
        _spectrum_check(o, r)


@pytest.mark.parametrize("m", (64, 256))
def test_models_match_plain_on_a_stack(m):
    """Both models against the plain versions (the kernels' yardsticks on
    the card) on a stack of 6 planes of 4 rows over 3 mask planes, int16
    TV carries and an int16 v: the halo rows wrap within each plane and
    plane p reads mask plane p % 3; plane 0 scaled by 1e3."""
    rng = np.random.RandomState(90 + m.bit_length())
    (p, pc), ph, n = STACK, 4, 2 * m
    shape = (p, ph, n)
    sc_a, sc_b = K._tv_scales(P.mu2, P.mu3, P.tau)
    mask = torch.from_numpy((rng.rand(pc, ph, n) > 0.5).astype(F32))
    st = lambda s=1.0: torch.from_numpy((s * rng.randn(*shape)).astype(F32))
    img, fwd = st(), st()
    img[0] *= 1e3
    a0, a1 = (K._store_carry(st(P.tau), torch.int16, sc_a) for _ in range(2))
    b = K._store_carry(st(P.mu3), torch.int16, sc_b)
    vc = K.encode_v(st(P.mu1), P.mu1, torch.int16)
    dp = K.bmul(mask.repeat(p // pc, 1, 1), torch.from_numpy(rng.rand(*shape).astype(F32)))
    ref = K.e1_rcarry_plain(img, fwd, vc, b, a0, a1, mask, dp, P.mu1, P.mu2, P.mu3, P.tau)
    rows = lambda t: t.reshape(p * ph, -1).numpy()
    load = lambda t, s: rows(K._load_carry(t, s))
    outs = model_e1_rcarry(rows(img), rows(fwd), load(vc, K._v_scale(P.mu1)), load(b, sc_b),
                           load(a0, sc_a), load(a1, sc_a), rows(mask.repeat(p // pc, 1, 1)),
                           rows(dp), ph=ph)
    for o, r in zip(outs[:4], ref[:4]):
        assert _row_errs(o, rows(r)).max() <= TOL_PLAIN
    _check(K.encode_v(torch.from_numpy(outs[4]), P.mu1, torch.int16).reshape(shape), ref[4])
    for o, scale, r in zip(outs[5:], (sc_a, sc_a, sc_b), ref[5:]):
        _check(K._store_carry(torch.from_numpy(o), torch.int16, scale).reshape(shape), r)
    spec = [torch.from_numpy(rng.randn(p, ph, m).astype(F32)) for _ in range(4)]
    cols = [torch.from_numpy(rng.randn(p, ph).astype(F32)) for _ in range(4)]
    ref = K.irfft_w_dual_plain(*spec, *cols)
    c = [x.reshape(-1).numpy() for x in cols]
    outs = model_irfft_w_dual(*(rows(s) for s in spec), c[0] + 1j * c[1], c[2] + 1j * c[3])
    for o, r in zip(outs, ref):
        assert np.abs(o - rows(r)).max() <= TOL_PLAIN * np.abs(rows(r)).max()


# ---------------------------------------------------------------------------
# the design rules, the libraries and the card path
# ---------------------------------------------------------------------------


def test_design_rules():
    """K8 and K9 take K1's rule: radix for M a power of two from 64 to
    4096 (the 12 MP grid's M = 4096, 768 x 1024's 512, 96 x 128's 64),
    split for any other M (96 x 384's 192, 96 x 1536's 768)."""
    assert K.e1_rcarry_design is K.rfft_w_design
    assert K.irfft_w_dual_design is K.rfft_w_design
    for m in K.RADIX_LENGTHS:
        assert K.e1_rcarry_design(m) == K.irfft_w_dual_design(m) == "radix"
    for m in (16, 32, 135, 192, 480, 768, 8192):
        assert K.e1_rcarry_design(m) == K.irfft_w_dual_design(m) == "split"


@pytest.mark.parametrize("src,macro", [("e1_rcarry.cuh", "LPT_E8R"),
                                       ("irfft_w_dual.cu", "LPT_E9R")],
                         ids=["e1_rcarry", "irfft_w_dual"])
def test_c_entry_takes_the_same_rule(src, macro):
    """The C entry launches the radix kernel for exactly the lengths of the
    Python rule, each case at its own length, and every other length
    falls to the split kernel (``run<``) in the switch's default."""
    text = (CSRC / src).read_text()
    cases = re.findall(rf"case (\d+): {macro}\((\d+)\);", text)
    assert sorted(int(a) for a, _ in cases) == list(K.RADIX_LENGTHS)
    assert all(a == b for a, b in cases)
    body = text[text.index(f"#define {macro}"):text.index(f"#undef {macro}")]
    assert re.search(r"default:\s*return run<", body)


def test_k8_libraries_by_tv_carry():
    """K8 is built as three libraries, one a TV carry type, each a source
    that includes e1_rcarry.cuh and exports ``lpt_e1_rcarry`` for its type
    alone; the wrapper's map names them, and the build lists them."""
    ctype = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16", torch.int16: "int16_t"}
    assert set(K._E1_RCARRY_LIB) == set(K.CARRY_DTYPES)
    for dtype, lib in K._E1_RCARRY_LIB.items():
        assert lib in _build.SOURCES
        text = (CSRC / f"{lib}.cu").read_text()
        assert '#include "e1_rcarry.cuh"' in text
        assert re.findall(r"^LPT_E1_RCARRY_ENTRY\(([\w]+)\)", text, re.M) == [ctype[dtype]]
        assert "e1_rcarry.cuh" in {p.name for p in _build._inputs(lib)}


def _record(monkeypatch):
    launched = []
    monkeypatch.setattr(K, "_on_card", lambda name, tensors, combo, built, cols=(): (
        combo in built) or pytest.fail(f"{combo} not built"))
    monkeypatch.setattr(K, "_launch",
                        lambda lib, fn, sig, *args: launched.append((lib, fn, sig, args)))
    return launched


@pytest.mark.parametrize("tv", [torch.float32, torch.bfloat16, torch.int16])
@pytest.mark.parametrize("m", (64, 192))
def test_k8_card_path_passes_the_design_table(monkeypatch, m, tv):
    """On the card ``e1_rcarry`` calls the library of its TV carry type and
    hands its C entry the table of its design (the split table, extended
    by the radix twiddles and the natural-order unpack factors for the
    radix design) with (rows, ph, pc, m, n1, n2) and the type codes."""
    launched = _record(monkeypatch)
    shape = (6, 4, 2 * m)
    io = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2)]
    vc = torch.zeros(shape, dtype=torch.int16)
    carries = [torch.zeros(shape, dtype=tv) for _ in range(3)]
    mask = torch.zeros((3, 4, 2 * m), dtype=torch.bfloat16)
    K.e1_rcarry(*io, vc, *carries, mask, io[0], P.mu1, P.mu2, P.mu3, P.tau)
    (lib, fn, sig, args), = launched
    assert lib == K._E1_RCARRY_LIB[tv] and fn == "lpt_e1_rcarry" and len(sig) == len(args)
    want = K._design_table(m, True, K.e1_rcarry_design(m), torch.device("cpu"))
    assert torch.equal(args[16], want)
    assert list(args[17:23]) == [24, 4, 3, m, *K.factors(m)]
    assert list(args[-3:]) == [1, K._CODE[tv], 2]


@pytest.mark.parametrize("m", (64, 192, 4096))
def test_k9_card_path_passes_the_design_table(monkeypatch, m):
    """On the card ``irfft_w_dual`` hands its C entry the table of its
    design with (rows, m, n1, n2) and the io code."""
    launched = _record(monkeypatch)
    spec = [torch.zeros((2, 3, m), dtype=torch.bfloat16) for _ in range(4)]
    cols = [torch.zeros((2, 3)) for _ in range(4)]
    K.irfft_w_dual(*spec, *cols)
    (lib, fn, sig, args), = launched
    assert (lib, fn) == ("irfft_w_dual", "lpt_irfft_w_dual") and len(sig) == len(args)
    want = K._design_table(m, True, K.irfft_w_dual_design(m), torch.device("cpu"))
    assert torch.equal(args[10], want)
    assert list(args[11:]) == [6, m, *K.factors(m), 1]


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors both wrappers return their plain versions' outputs
    whatever the design (radix and split widths)."""
    rng = np.random.RandomState(5)
    for pw in (128, 384):
        x = [torch.from_numpy(rng.randn(2, 6, pw).astype(F32)) for _ in range(8)]
        consts = (P.mu1, P.mu2, P.mu3, P.tau)
        for a, r in zip(K.e1_rcarry(*x, *consts), K.e1_rcarry_plain(*x, *consts)):
            assert torch.equal(a, r)
        s = [torch.from_numpy(rng.randn(2, 6, pw // 2).astype(F32)) for _ in range(4)]
        c = [torch.from_numpy(rng.randn(2, 6).astype(F32)) for _ in range(4)]
        for a, r in zip(K.irfft_w_dual(*s, *c), K.irfft_w_dual_plain(*s, *c)):
            assert torch.equal(a, r)


def test_library_hash_follows_its_includes(tmp_path, monkeypatch):
    """A library's build key changes with its source and with each csrc
    header it includes, directly or through another header, and with no
    other file: a change to K8's header rebuilds K8's three libraries
    alone, a change to lpt_fft.cuh every library that includes it."""
    import shutil
    tree = tmp_path / "csrc"
    shutil.copytree(CSRC, tree)
    monkeypatch.setattr(_build, "CSRC", tree)
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    for header, want in (("e1_rcarry.cuh", set(K._E1_RCARRY_LIB.values())),
                         ("lpt_fft.cuh", {n for n in _build.SOURCES
                                          if "lpt_fft.cuh" in {p.name for p in
                                                               _build._inputs(n)}})):
        (tree / header).write_text((tree / header).read_text() + "\n// changed\n")
        after = {n: _build.lib_path(n) for n in _build.SOURCES}
        assert {n for n in before if before[n] != after[n]} == want, header
        before = after
    assert {"sat_scan", "probe_bw"}.isdisjoint(want)


def test_smoke_run_names_k8_k9_designs():
    """chip_smoke.py holds K8 and K9 with the M-rule kernels (M_NAMES: 96
    x 384 and 96 x 1536 run their split designs, the small grid, 768 x
    1024 and 12 MP their radix ones) and runs K8 in all 18 type
    combinations at a radix and at both split grids; their rows carry the
    design."""
    import chip_smoke as cs
    assert {"e1_rcarry", "irfft_w_dual"} <= set(cs.M_NAMES)
    assert len(cs.K8_COMBOS) == 18 and len(set(cs.K8_COMBOS)) == 18
    assert {(96, 128), (2 * cs.K1_SPLIT[0], 2 * cs.K1_SPLIT[1]),
            (2 * cs.W_SPLIT[0], 2 * cs.W_SPLIT[1])} <= set(cs.K8_GRIDS)
    for name in ("e1_rcarry", "irfft_w_dual"):
        for grid, want in (((6144, 8192), "radix"), ((96, 128), "radix"),
                           ((2 * cs.K1_SPLIT[0], 2 * cs.K1_SPLIT[1]), "split"),
                           ((2 * cs.W_SPLIT[0], 2 * cs.W_SPLIT[1]), "split"),
                           ((540, 960), "split"), ((768, 1024), "radix")):
            assert cs.design(name, *grid) == {"design": want}, (name, grid)


def test_scripts_find_k8_and_time_v2(tmp_path, monkeypatch):
    """profile_solver.py finds K8's kernels in its header (else their time
    would count as PyTorch's) and profiles the v2 placement in both modes;
    ab_kernels.py serves every TV carry type from the one ``e1_rcarry``
    library of a tree from before K8 was built as three."""
    import shutil
    import ab_kernels
    import profile_solver
    names = profile_solver.port_kernel_names()
    assert {"e1_rcarry_kernel", "e1_rcarry_radix_kernel", "irfft_w_dual_kernel",
            "irfft_w_dual_radix_kernel"} <= names
    assert {("rsplit_v2", "bench"), ("rsplit_v2", "f32")} <= set(profile_solver.MODES)
    old = tmp_path / "csrc"
    shutil.copytree(CSRC, old)
    for lib in ("e1_rcarry_tv_bf16", "e1_rcarry_tv_i16"):
        (old / f"{lib}.cu").unlink()
    monkeypatch.setattr(_build, "CSRC", _build.CSRC)
    monkeypatch.setattr(K, "_E1_RCARRY_LIB", K._E1_RCARRY_LIB)
    ab_kernels.use(old)
    assert set(K._E1_RCARRY_LIB.values()) == {"e1_rcarry"}
    assert "e1_rcarry_tv_i16" not in ab_kernels.sources(old)
    ab_kernels.use(CSRC)
    assert K._E1_RCARRY_LIB == ab_kernels.E1_RCARRY_LIB
    assert ab_kernels.sources(CSRC) == list(_build.SOURCES)


def test_build_jobs_compile_each_library_once(tmp_path, monkeypatch):
    """``_build.build_jobs`` compiles the libraries of several source trees
    in one pool: a library whose inputs match another tree's is compiled
    once, a built one not again (a stand-in compiler that writes its
    output file; no nvcc here)."""
    import shutil
    import stat
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    a, b = tmp_path / "a", tmp_path / "b"
    shutil.copytree(CSRC, a)
    shutil.copytree(CSRC, b)
    (b / "irfft_w_dual.cu").write_text((b / "irfft_w_dual.cu").read_text() + "\n")
    jobs = [(n, t) for t in (a, b) for n in ("irfft_w_dual", "sat_scan")]
    done = _build.build_jobs(jobs)
    assert set(done) == {("irfft_w_dual", a), ("sat_scan", a), ("irfft_w_dual", b)}
    assert all(r["ok"] for r in done.values())
    assert all(_build.lib_path(n, t).exists() for n, t in jobs)
    assert _build.build_jobs(jobs) == {}
