"""The design of the bandwidth probe's P1-P3 (``csrc/probe_bw.cu``): a
bulk-copy stream through shared memory, one chunk of the plane a thread
block, modelled on the CPU.

The host helpers of ``ops/probe_bw.py`` mirror the kernel's constants,
which are parsed from the source here, and its chunks: every byte of the
plane is streamed once, in 16-byte-aligned chunks, one a block.  A numpy
model of P2's and P3's pass through each stage (widen, multiply or add
the bump, round back in place) is held bit for bit to the plain versions
and to the JAX script's ``copy_plane`` and ``copy_plane_consts`` run in
interpret mode (the script is loaded from
its file and stays unchanged; its ``pl`` is swapped for one whose
``pallas_call`` interprets), P1's to the copy.  The C entries' signatures
must match the wrappers' ``_launch`` type strings, ``chip_smoke.py`` must
name each probe's design, and ``ab_kernels.py --probes`` must time every
tree in its interleaved order."""

import functools
import importlib.util
import inspect
import json
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lenslesspicam_tpu_torch.ops import probe_bw as PB

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "lenslesspicam_tpu_torch" / "ops" / "csrc" / "probe_bw.cu").read_text()
SCRIPT = ROOT / "scripts" / "dev" / "_probe_bw.py"
MP12 = 6144 * 8192
NP = {torch.float32: np.float32, torch.bfloat16: np.uint16, torch.float16: np.float16,
      torch.int32: np.int32}


def _constants():
    """The kernel's ``constexpr int`` constants, evaluated in order (C's
    integer division on non-negative ints is Python's //)."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", SRC, re.M):
        env[name] = eval(expr.split("//")[0].replace("/", "//"), {}, dict(env))
    return env


def _body(head):
    b = SRC[SRC.index(head):]
    return b[:b.index("\n}\n")]


@pytest.fixture(scope="module")
def jaxbw():
    """The JAX script, its Pallas calls in interpret mode."""
    spec = importlib.util.spec_from_file_location("_probe_bw_script_interpret", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(BlockSpec=pl.BlockSpec,
                                   pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


def test_constants_mirror_the_kernel():
    """CHUNK, the threads a block, the barrier's bytes and P3's constant
    plane are the kernel's; a chunk is a multiple of 16 in 16-32 KB and
    P2's and P3's threads take whole words of it; an SM holds SM_THREADS /
    STREAM_THREADS blocks, their shared memory too (P3's with a round of
    STREAM_THREADS f32 scalars)."""
    c = _constants()
    assert (c["CHUNK"], c["STREAM_THREADS"], c["BAR_BYTES"], c["CONST_FLOATS"]) == (
        PB.CHUNK_BYTES, PB.STREAM_THREADS, PB.BAR_BYTES, np.prod(PB.CONST_PLANE))
    assert "THREADS" not in c and not hasattr(PB, "P3_THREADS")
    assert PB.CHUNK_BYTES % 16 == 0 and 16 * 1024 <= PB.CHUNK_BYTES <= 32 * 1024
    assert c["WORDS"] * 16 * PB.STREAM_THREADS == PB.CHUNK_BYTES
    stages = PB.stream_plan(1)["stages"]
    assert stages == PB.SM_THREADS // PB.STREAM_THREADS == 4
    assert stages * (PB.BAR_BYTES + PB.CHUNK_BYTES + 4 * PB.STREAM_THREADS + 1024) <= 228 * 1024
    assert "return BAR_BYTES + (size_t)CHUNK + (OP == CONSTS ? sizeof(float) * STREAM_THREADS " \
        ": 0);" in SRC
    assert "smem_bytes<OP>(), stream" in SRC


def test_kernel_streams_the_models_chunks():
    """The kernel's own expressions: block b's chunk at b CHUNK, cut at the
    plane's end, one barrier phase, P1 with one working thread, P2's and
    P3's threads updating the stage before a fence and a barrier, the
    store's read of the stage waited on before the block leaves, and a
    grid of one block a chunk; ``br`` is still checked.  P3's scalars
    c_k[0, 0] are loaded after the bulk load is issued and before it is
    waited on, summed from k = 0, and 0 times the sum is added."""
    k = _body("chunk_kernel(const char* __restrict__ x")
    assert "const long long at = (long long)blockIdx.x * CHUNK;" in k
    assert "min((long long)CHUNK, bytes - at)" in k
    assert "if (OP == COPY && threadIdx.x) return;" in k
    assert "bulk_load(stage, x + at, size, full);" in k and "mbar_wait(full, 0);" in k
    assert "fence_async_shared();\n    __syncthreads();" in k
    assert re.search(r"bulk_store\(o \+ at, stage, size\);\s*bulk_wait_read\(\);", k)
    assert k.index("bulk_load(stage, x + at, size, full);") < k.index(
        "__ldg(consts + (size_t)k * CONST_FLOATS)") < k.index("mbar_wait(full, 0);")
    assert "float sum = 0.f;" in k and "for (int j = 0; j < m; ++j) sum += cs[j];" in k
    assert "bump = sum * 0.f;" in k and "v[e] * 1.0001f : v[e] + bump" in k
    run = _body("static int run(const void* x")
    assert "const long long n_chunks = (bytes + CHUNK - 1) / CHUNK;" in run
    assert "dim3((unsigned)n_chunks), dim3(STREAM_THREADS)" in run
    assert "if (br <= 0 || rows % br" in run
    for nbytes in (MP12 * 2, 5000 * 16, 16):
        plan = PB.stream_plan(nbytes)
        assert plan["grid"] == plan["n_chunks"] == len(PB.chunks(nbytes))
        assert [off for off, _ in PB.chunks(nbytes)] == [
            b * PB.CHUNK_BYTES for b in range(plan["grid"])]


CASES = {
    "12mp_2": MP12 * 2,
    "12mp_4": MP12 * 4,
    "96x256_2": 96 * 256 * 2,
    "96x256_4": 96 * 256 * 4,
    "ragged_last": 1000 * 8200 * 4,
    "ragged_few": 5 * PB.CHUNK_BYTES + 7 * 16,
    "smaller_than_a_chunk": 3 * 2056 * 2,
    "one_word": 16,
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunks_cover_every_byte_once(case):
    """Every byte once, in order, in 16-byte-aligned chunks of CHUNK bytes
    but the last, which is ragged where the plane is not whole chunks;
    one chunk a block (the blocks' counts all 1)."""
    nbytes = CASES[case]
    plan = PB.stream_plan(nbytes)
    n = plan["n_chunks"]
    assert n == -(-nbytes // PB.CHUNK_BYTES) == plan["grid"] >= 1
    got = PB.chunks(nbytes)
    assert len(got) == n
    end = 0
    for off, size in got:
        assert off == end and off % 16 == 0 and size % 16 == 0 and 0 < size <= PB.CHUNK_BYTES
        end += size
    assert end == nbytes
    assert [s for _, s in got[:-1]] == [PB.CHUNK_BYTES] * (n - 1)
    assert (got[-1][1] == PB.CHUNK_BYTES) == (nbytes % PB.CHUNK_BYTES == 0)


def _bump_model(c00):
    """P3's bump as the kernel's loop takes it: rounds of STREAM_THREADS
    scalars, one a thread, into shared memory, each round summed in order
    by every thread after a barrier, a second barrier before the next
    round; returns (0 * the sum in f32, the barriers, the loads)."""
    cs = np.full(PB.STREAM_THREADS, np.nan, np.float32)
    total, barriers, loads, k0 = np.float32(0), 0, 0, 0
    n = len(c00)
    while True:
        for t in range(PB.STREAM_THREADS):
            if k0 + t < n:
                cs[t] = c00[k0 + t]
                loads += 1
        barriers += 1
        for j in range(min(n - k0, PB.STREAM_THREADS)):
            total = np.float32(total + cs[j])
        if k0 + PB.STREAM_THREADS >= n:
            break
        barriers += 1
        k0 += PB.STREAM_THREADS
    return np.float32(total * np.float32(0)), barriers, loads


@pytest.mark.parametrize("n", [0, 1, 40, 512, 513, 1100])
def test_bump_loop_reads_each_scalar_once_in_order(n):
    """Each c_k[0, 0] loaded once, summed from k = 0 as the plain version
    sums; one barrier up to STREAM_THREADS constants (the one that also
    publishes the mbarrier), two more a further round."""
    rng = np.random.RandomState(n)
    c00 = (rng.randn(n) * np.exp2(rng.randint(-20, 20, n))).astype(np.float32)
    if n:
        c00[-1] = -abs(c00[:-1].sum(dtype=np.float32)) - 1     # a negative sum: a bump of -0
    bump, barriers, loads = _bump_model(c00)
    consts = torch.zeros(n, 128, 128)
    consts[:, 0, 0] = torch.from_numpy(c00)
    x = torch.tensor([[-0.0, 1.5, -2.0, 0.0]])
    want = PB.copy_plane_consts_plain(x, 1, consts)
    assert np.array_equal((x.numpy() + bump).view(np.int32), want.numpy().view(np.int32))
    assert loads == n and barriers == 1 + 2 * ((max(n, 1) - 1) // PB.STREAM_THREADS)
    assert np.signbit(bump) == (n > 0)


def _bf16_round(f):
    """f32 -> bf16 bits, round to nearest even (finite values)."""
    u = f.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _stream_model(name, buf, dtype, c00=()):
    """P1, P2 or P3 on the bytes ``buf`` of a plane: each chunk brought into
    a stage, P2's and P3's 16-byte words widened to f32, multiplied by
    f32(1.0001) (P2) or added the bump of the scalars ``c00`` (P3,
    :func:`_bump_model`) and rounded back to ``dtype`` in the stage, the
    stage stored at its chunk's offset."""
    bump = _bump_model(c00)[0]

    def op(f):
        return f * np.float32(PB.SCALE) if name == "copy_plane" else f + bump

    out = np.full_like(buf, 0xA5)
    for off, size in PB.chunks(buf.size):
        stage = buf[off:off + size].copy()
        if name != "pure_copy_plane":
            words = stage.reshape(-1, 16)
            if dtype == torch.bfloat16:
                f = op((words.view(np.uint16).astype(np.uint32) << 16).view(np.float32))
                words[:] = _bf16_round(f).view(np.uint8).reshape(words.shape)
            else:
                f = op(words.view(NP[dtype]).astype(np.float32))
                words[:] = f.astype(NP[dtype]).view(np.uint8).reshape(words.shape)
        out[off:off + size] = stage
    return out


def _plane(dtype, shape, seed):
    """A plane with values over many binades, signed zeros, f16 values
    near its largest, and for i32 integers; (tensor, its bytes)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * np.exp2(rng.randint(-12, 12, shape))).astype(np.float32)
    x.flat[:4] = [-0.0, 0.0, 65500.0, -65504.0]
    t = torch.from_numpy(x * 1000).to(torch.int32) if dtype == torch.int32 else \
        torch.from_numpy(x).to(dtype)
    return t, t.view(torch.uint8).numpy().reshape(-1).copy()


@pytest.mark.parametrize("name,dtype", [("copy_plane", d) for d in PB.FLOAT_DTYPES]
                         + [("pure_copy_plane", d) for d in PB.COPY_DTYPES]
                         + [("copy_plane_consts", d) for d in PB.FLOAT_DTYPES])
def test_stage_model_is_the_plain_and_the_pallas_kernel(jaxbw, name, dtype):
    """At 40 x 520 (six chunks at 4 bytes, three at 2, the last one ragged)
    the stream equals the plain version and the JAX script's kernel in
    interpret mode (row blocks of 8; P3 with its 4 constant planes of
    ones), bit for bit."""
    br = 8
    t, buf = _plane(dtype, (40, 520), 5)
    assert len(PB.chunks(buf.size)) == (6 if t.element_size() == 4 else 3)
    consts = PB.const_planes(PB.N_CONSTS[0], "cpu")
    extra = (consts,) if name == "copy_plane_consts" else ()
    plain = getattr(PB, name + "_plain")(t, br, *extra)
    want = plain.view(torch.uint8).numpy().reshape(-1)
    jx = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if dtype == torch.bfloat16 else \
        jnp.asarray(t.numpy())
    jout = np.asarray(getattr(jaxbw, name)(jx, br, *(len(c) for c in extra)))
    jbits = jout.view(np.uint16) if dtype == torch.bfloat16 else jout
    assert np.array_equal(np.ascontiguousarray(jbits).view(np.uint8).reshape(-1), want)
    c00 = consts[:, 0, 0].numpy() if extra else ()
    assert np.array_equal(_stream_model(name, buf, dtype, c00), want)
    if name == "copy_plane" and dtype != torch.float32:
        assert np.array_equal(want, buf)        # 1e-4 is below half an ulp


def test_c_entries_match_the_launch_strings():
    """Each ``extern "C"`` entry of probe_bw.cu takes, before its stream,
    the arguments that the wrapper's ``_launch`` type string says: "p" for
    a pointer, "i" for an int; the wrapper passes that many."""
    entries = {}
    for fn, params in re.findall(r'extern "C" int (lpt_\w+)\(([^)]*)\)', SRC):
        ps = [q.strip() for q in params.split(",")]
        assert ps[-1] == "void* stream", fn
        entries[fn] = "".join("p" if "*" in q else "i" if q.startswith("int ") else "?"
                              for q in ps[:-1])
    wrappers = inspect.getsource(PB)
    calls = re.findall(r'_launch\("probe_bw", "(lpt_\w+)", "(\w+)",([^)]*)\)', wrappers)
    assert {fn: sig for fn, sig, _ in calls} == entries == {
        "lpt_pure_copy_plane": "ppiiii", "lpt_copy_plane": "ppiiii",
        "lpt_copy_plane_consts": "pppiiiii"}
    for fn, sig, args in calls:
        assert len([a for a in args.split(",") if a.strip()]) == len(sig), fn


def test_card_path_launches_each_entry(monkeypatch):
    """On the card each wrapper launches its entry once with (rows, w, br,
    type code) and counts it; br still has to divide the rows."""
    launched = []
    monkeypatch.setattr(PB, "_on_card", lambda name, tensors, combo, built, cols=(): True)
    monkeypatch.setattr(PB, "_launch", lambda lib, fn, sig, *a: launched.append((lib, fn, a)))
    PB.reset_launches()
    x = torch.zeros(32, 256, dtype=torch.bfloat16)
    PB.pure_copy_plane(x, 16)
    PB.copy_plane(x, 32)
    PB.copy_plane_consts(x, 16, PB.const_planes(4, "cpu"))
    assert [(lib, fn) for lib, fn, _ in launched] == [
        ("probe_bw", "lpt_pure_copy_plane"), ("probe_bw", "lpt_copy_plane"),
        ("probe_bw", "lpt_copy_plane_consts")]
    assert launched[0][2][2:] == (32, 256, 16, 1) and launched[1][2][2:] == (32, 256, 32, 1)
    assert launched[2][2][3:] == (4, 32, 256, 16, 1)
    assert PB.launch_counts() == dict.fromkeys(PB.launch_counts(), 1)
    with pytest.raises(ValueError):
        PB.copy_plane(x, 24)
    PB.reset_launches()


def test_smoke_names_each_probe_design():
    """chip_smoke.py names each probe's design, on its bandwidth line and
    in its kernels line: P1-P3 in bulk chunks with C, S and G whatever br,
    P3's blocks also reading one scalar of each constant plane; its edge
    planes have a ragged last chunk at every type, one after many whole
    chunks."""
    import chip_smoke as cs
    for itemsize in (2, 4):
        want = {"design": "bulk chunks", "chunk": PB.CHUNK_BYTES, "stages": 4,
                "blocks": MP12 * itemsize // PB.CHUNK_BYTES, "threads": PB.STREAM_THREADS}
        for name in cs.STREAM_PROBES:
            assert cs.design(name, 6144, 8192, itemsize) == want
            assert PB.design(name, 6144, 8192, itemsize, PB.BRS[1]) == want
        assert cs.design("copy_plane_consts", 6144, 8192, itemsize) == {
            **want, "scalars": "c_k[0, 0]"}
        assert "copy_plane_consts" not in cs.STREAM_PROBES
    assert cs.design("pure_copy_plane", 1, 8, 2)["blocks"] == 1
    src = inspect.getsource(cs.bandwidth_phase)
    assert src.count("PB.design(") == 2 and "PROBE_EDGES" in src
    for rows, w in cs.PROBE_EDGES:
        for itemsize in (2, 4):
            nbytes = rows * w * itemsize
            assert nbytes % 16 == 0 and nbytes % PB.CHUNK_BYTES
    assert max(rows * w for rows, w in cs.PROBE_EDGES) * 2 > 100 * PB.CHUNK_BYTES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_bytes_count_what_each_function_reads(dtype):
    """The bound's bytes of each probe case: the plane read and written
    once, and for P3 the one f32 element c_k[0, 0] of each of its n
    constant planes, not the whole planes its inputs hold."""
    import chip_smoke as cs
    gen = torch.Generator()
    gen.manual_seed(0)
    cases = cs.probe_kernel_cases(32, 256, gen, dtype)
    plane = 2 * 32 * 256 * dtype.itemsize
    assert {name: case[2] for name, case in cases.items()} == {
        "pure_copy_plane": plane, "copy_plane": plane,
        "copy_plane_consts": plane + 4 * PB.N_CONSTS[-1]}
    (x, br, consts), flops, moved = cases["copy_plane_consts"]
    assert consts.shape == (PB.N_CONSTS[-1], *PB.CONST_PLANE) and x.dtype == dtype
    assert flops == x.numel() + len(consts) and moved < plane + consts.numel() * 4
    src = inspect.getsource(cs.check_kernels)
    assert "byt = moved[0] if moved else nbytes(*tensors(args), *tensors(out))" in src


def test_ab_probes_interleave_every_tree(monkeypatch):
    """``ab_kernels.py --probes`` times P1-P3 of every tree in the order A,
    B1 .. Bn, library, library, Bn .. B1, A (P3 without the library),
    checks each tree's output against the plain version first, and prints
    kernel_over_parent (B1) beside kernel_over_library."""
    import ab_kernels as ab
    import chip_smoke as cs
    trees = {"A": Path("a"), "B1": Path("b1"), "B2": Path("b2")}
    state, order, lines = {"tree": None, "lib": False}, [], []
    ms = {"A": 1.0, "B1": 2.0, "B2": 4.0, "library": 1.6}

    def time_ms(fn):
        state["lib"] = False
        fn()
        label = "library" if state["lib"] else next(k for k, v in trees.items()
                                                     if v == state["tree"])
        order.append(label)
        return ms[label]

    def cases(ph, pw, gen, io):
        x = torch.rand(ph, pw, generator=gen).to(io)
        plane = 2 * x.numel() * x.element_size()
        return {"pure_copy_plane": ((x, 16), 0, plane),
                "copy_plane": ((x, 16), x.numel(), plane),
                "copy_plane_consts": ((x, 16, PB.const_planes(4, "cpu")), x.numel() + 4,
                                      plane + 16)}

    def library(name):
        lib_name, lib = cs.PROBE_LIBRARY(name)
        if lib is None:
            return None, None

        def call(s):
            state["lib"] = True
            return lib(s)
        return lib_name, call

    monkeypatch.setattr(cs, "PROBE_LIBRARY", cs.probe_library, raising=False)
    monkeypatch.setattr(ab, "use", lambda tree: state.update(tree=tree))
    monkeypatch.setattr(cs, "probe_kernel_cases", cases)
    monkeypatch.setattr(cs, "probe_library", library)
    monkeypatch.setattr(cs, "time_ms", time_ms)
    cpu_generator = torch.Generator
    monkeypatch.setattr(ab.torch, "Generator", lambda device=None: cpu_generator())
    monkeypatch.setattr("builtins.print", lambda line, **kw: lines.append(line))
    ab.probe_ab(16, 256, 2, trees, ["B1", "B2"])
    rows = [json.loads(line) for line in lines]
    assert [(r["probe"], r["dtype"]) for r in rows] == [
        (p, d) for d in ("float32", "bfloat16") for p in ("P1", "P2", "P3")]
    one = ["A", "B1", "B2", "library", "library", "B2", "B1", "A"]
    three = [t for t in one if t != "library"]
    assert order == (one * 2 + one * 2 + three * 2) * 2
    assert all(r["kernel_over_parent"] == 0.5 and r["parent_ms"] == 2.0 for r in rows)
    assert [r["kernel_over_library"] for r in rows] == [1 / 1.6, 1 / 1.6, None] * 2
    assert rows[0]["design"]["design"] == "bulk chunks" and rows[2]["design"]["blocks"] == 1
    assert len(rows[0]["times"]["A"]) == 4 and len(rows[0]["times"]["library"]) == 4
    assert state["tree"] == trees["A"]
