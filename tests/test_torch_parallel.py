"""The port's parallel layer (``lenslesspicam_tpu_torch/parallel``) on gloo
ranks of this CPU, held to the JAX package's on its virtual CPU devices.

The port's ranks are processes: this file started as ``python -m
tests.test_torch_parallel <worker> <out>`` is one rank of a worker (4 ranks,
two simulated hosts of 2; or 2 ranks), which computes every case of its
batch and writes its results to ``<out>.<rank>``.  The workers are started
once, when the module's first test runs, and the JAX references are
computed while they run.  Each rank runs with one thread; gloo warns that
it cannot resolve the host name, which is harmless.

Held, on the same seeded numpy inputs:

- ``spatial_sharded_admm`` at 4 ranks against the JAX package's on
  ``Mesh(devices[:4], ("sp",))``, backends ``xla`` (1e-5), ``pallas`` and
  ``rpallas`` (1e-4; the JAX kernels in interpret mode, the port's plain
  versions), the shapes of ``tests/test_sharding.py``, n = 5;
- ``filtered_synthesis_sharded`` against the JAX round trip (1e-4, its
  test's bar), ``sharded_admm_run`` batch and depth (1e-5), one
  data-parallel SGD step of ``UnrolledADMM`` at data = 4 and at (data,
  depth) = (2, 2) against JAX's single-device step (loss 1e-5, parameters
  1e-4), ``benchmark(mesh=)`` at 2 ranks against the JAX ``benchmark`` on a
  2-device mesh (1e-4, ``tests/test_torch_eval.py``'s bar) and against its
  own ``mesh=None`` (1e-6);
- the collective counters of the rpallas loop: per iteration the compiled
  JAX program's op counts (2 all-to-all, 4 all-gather, 2 permute) and
  bytes within 10 % of ``ici_traffic_model`` and of JAX's HLO audit;
- the meshes over simulated hosts, ``put_global`` / ``gather_global``, and
  the 2 hosts x 2 ranks dryrun (1e-5).
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from lenslesspicam_tpu_torch.parallel import distributed as tdist

if __name__ != "__main__":      # a rank (python -m tests.test_torch_parallel) needs no test helpers
    from test_torch_scripts import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N_ITER = 5
TOL_XLA = 1e-5
TOL_KERNEL = 1e-4
TOL_SHARDED = 1e-5
TOL_FS = 1e-4
TOL_LOSS = 1e-5
TOL_PARAMS = 1e-4
TOL_BENCH = 1e-4
TOL_BENCH_SELF = 1e-6
TOL_BYTES = 0.10
SPATIAL_SEEDS = {"xla": 7, "pallas": 9, "rpallas": 10}
COUNTER_GRIDS = ((64, 96, 3, 2), (96, 128, 1, 1))     # (ph, pw, planes, batch)
DP_MESHES = {"dp4": (4, 1), "dp22": (2, 2)}
SCHEDULES = ("mu1", "mu2", "mu3", "tau")


def _spatial_problem(seed):
    rng = np.random.RandomState(seed)
    psf = rng.rand(1, 32, 48, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    return psf, rng.rand(2, 1, 32, 48, 3).astype(np.float32)


def _fs_problem():
    rng = np.random.RandomState(8)
    ph, pw, n = 64, 96, 4
    pwh = pw // 2 + 1
    x = rng.rand(2, 1, ph, pw, 3).astype(np.float32)
    H = (rng.rand(1, ph, pwh, 3) + 1j * rng.rand(1, ph, pwh, 3)).astype(np.complex64)
    Hp = np.zeros((1, ph, -(-pwh // n) * n, 3), np.complex64)
    Hp[:, :, :pwh] = H
    return x, H, Hp


def _admm_problem(depth=1, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    psf = rng.rand(depth, 24, 32, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    return psf, rng.rand(batch, depth, 24, 32, 3).astype(np.float32)


def _dp_problem():
    psf, data = _admm_problem(depth=2, batch=8, seed=1)
    return psf, data, np.random.RandomState(2).rand(*data.shape).astype(np.float32)


def _bench_problem():
    rng = np.random.RandomState(15)
    psf = rng.rand(1, 24, 32, 3).astype(np.float32)
    psf /= np.linalg.norm(psf)
    batches = [{"lensless": rng.rand(4, 1, 24, 32, 3).astype(np.float32),
                "lensed": rng.rand(4, 1, 24, 32, 3).astype(np.float32)} for _ in range(2)]
    return psf, batches


# --- the workers (one process a rank) -------------------------------------------------------


def _worker4():
    from lenslesspicam_tpu_torch.models.unrolled import UnrolledADMM
    from lenslesspicam_tpu_torch.parallel import sharding, spatial
    from lenslesspicam_tpu_torch.recon import admm
    from lenslesspicam_tpu_torch.train.steps import init_train_state, make_train_step

    res = {}
    mesh = tdist.device_mesh(np.arange(4), ("sp",))
    for backend, seed in SPATIAL_SEEDS.items():
        psf, data = _spatial_problem(seed)
        conv = admm.make_convolver(psf, device="cpu")
        res[f"spatial_{backend}"] = spatial.spatial_sharded_admm(
            mesh, conv, data, n_iter=N_ITER, backend=backend).numpy()
        res["auto_backend"] = spatial._choose_backend(mesh, conv, "auto", None)

    x, _, Hp = _fs_problem()
    g = mesh.get_group("sp")
    spec = tdist.NamedSharding(mesh, (None, None, "sp"))
    out = spatial.filtered_synthesis_sharded(tdist.put_global(x, spec).data,
                                             tdist.put_global(Hp, spec).data, 64, 96, 4, g)
    res["fs"] = tdist.all_gather(out, 2, g).numpy()

    for key, (depth, batch, nd, ndep, n) in {"batch": (1, 8, 4, 1, 5),
                                             "depth": (4, 4, 2, 2, 3)}.items():
        psf, data = _admm_problem(depth, batch)
        res[f"sharded_{key}"] = sharding.sharded_admm_run(
            sharding.make_mesh(nd, ndep), admm.make_convolver(psf, device="cpu"), data,
            n_iter=n).numpy()

    psf, data, target = _dp_problem()
    for key, shape in DP_MESHES.items():
        dmesh = sharding.make_mesh(*shape)
        model = UnrolledADMM(n_iter=2, device="cpu")
        conv = sharding.shard_convolver(dmesh, UnrolledADMM.make_convolver(psf, device="cpu"))
        params = sharding.replicate(dmesh, dict(model.named_parameters()))
        opt = torch.optim.SGD(list(params.values()), lr=1e-2)
        step = make_train_step(
            lambda p, c, d: torch.func.functional_call(model, p, (c, d)), opt)
        state = init_train_state(params, opt)
        box = []
        nbytes = tdist.allreduce_bytes(lambda: box.append(step(
            state, conv, sharding.shard_batch(dmesh, data),
            sharding.shard_batch(dmesh, target))))
        state, loss = box[0]
        res[key] = {"loss": float(loss), "bytes": nbytes,
                    **{k: state.params[f"_{k}_p"].detach().numpy() for k in SCHEDULES}}

    for ph, pw, planes, batch in COUNTER_GRIDS:
        res[f"counters_{ph}x{pw}"] = spatial.collective_bytes_per_iter(
            mesh, ph, pw, nplanes=planes, batch=batch, n_iter=2)

    hosts = tdist.multihost_mesh(("sp",))
    res["multihost"] = {
        "grid": hosts.mesh.tolist(),
        "data_spans": tdist.axis_spans_processes(hosts, "data"),
        "sp_spans": tdist.axis_spans_processes(hosts, "sp")}
    across = tdist.device_mesh(np.arange(4).reshape(2, 2).T, ("data", "sp"))
    try:
        tdist.assert_ici_axes(across, ("sp",))
        res["multihost"]["refused"] = False
    except ValueError:
        res["multihost"]["refused"] = True
    res["multihost"]["hybrid"] = tdist.hybrid_mesh((1, 2), (2, 1), ("data", "sp")).mesh.tolist()
    arr = np.arange(48, dtype=np.float32).reshape(8, 6)
    shard = tdist.put_global(arr, tdist.NamedSharding(sharding.make_mesh(2, 2),
                                                      ("data", "depth")))
    res["placement"] = {"gathered": tdist.gather_global(shard), "shape": tuple(shard.data.shape),
                        "err": tdist.max_local_shard_err(shard, arr)}
    return res


def _worker2():
    from lenslesspicam_tpu_torch.eval.benchmark import benchmark
    from lenslesspicam_tpu_torch.parallel.sharding import make_mesh
    from lenslesspicam_tpu_torch.recon import admm
    from lenslesspicam_tpu_torch.recon.base import ADMM

    psf, batches = _bench_problem()
    conv = admm.make_convolver(psf, device="cpu")
    model = ADMM(psf, n_iter=3, device="cpu")
    mesh = make_mesh(n_data=2)

    def rec(x):
        return admm.run(conv, x, n_iter=3)

    res = {}
    for key, m in (("mesh", mesh), ("none", None)):
        res[key] = benchmark(rec, batches, model=model, mesh=m, device="cpu")
        res[f"snr_{key}"] = benchmark(rec, batches, snr=10.0, mesh=m, device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    return res


def _worker(name, out):
    rank, _ = tdist.initialize(device=os.environ["LPT_DEVICE"])
    res = {"w4": _worker4, "w2": _worker2}[name]()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    tdist.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])


# --- the tests ----------------------------------------------------------------------------


class _Ranks:
    """A worker's ranks, started at once; ``result(rank)`` waits for them."""

    def __init__(self, name, n, n_local, tmp):
        self.out, self.n = str(tmp / name), n
        self.started = tdist.spawn_cpu_ranks(["-m", "tests.test_torch_parallel", name,
                                              self.out], n, n_local, timeout=300)
        self.done = None

    def result(self, rank=0):
        if self.done is None:
            tdist.wait_ranks(self.started)
            self.done = []
            for r in range(self.n):
                with open(f"{self.out}.{r}", "rb") as f:
                    self.done.append(pickle.load(f))
        return self.done[rank]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    started = {"w4": _Ranks("w4", 4, 2, tmp), "w2": _Ranks("w2", 2, 2, tmp)}
    yield started
    for r in started.values():
        for p in r.started[0]:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def dryrun():
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(tdist.run_cpu_dryrun, n_local=2)


def _mesh(n, axis="sp"):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), (axis,))


@pytest.fixture(scope="module")
def jax_dp_step():
    """One JAX single-device SGD step of UnrolledADMM (test_sharding.py)."""
    import jax
    import jax.numpy as jnp
    import optax

    from lenslesspicam_tpu.models.unrolled import UnrolledADMM
    from lenslesspicam_tpu.train.steps import init_train_state, make_train_step

    psf, data, target = _dp_problem()
    model = UnrolledADMM(n_iter=2)
    conv = UnrolledADMM.make_convolver(psf)
    params = model.init(jax.random.PRNGKey(0), conv, jnp.asarray(data))
    opt = optax.sgd(1e-2)
    step = make_train_step(lambda p, c, d: model.apply(p, c, d), opt)
    state, loss = jax.jit(step)(init_train_state(params, opt), conv, jnp.asarray(data),
                                jnp.asarray(target))
    return float(loss), {k: np.asarray(state.params["params"][k]) for k in SCHEDULES}


@pytest.mark.parametrize("key", list(DP_MESHES))
def test_data_parallel_step_matches_jax(ranks, dryrun, jax_dp_step, key):
    """The gradients averaged over the mesh: the loss and the updated
    schedules of every rank equal JAX's single-device step; the step's
    all-reduce moves the 4 schedules' gradients and the loss."""
    loss, params = jax_dp_step
    for r in range(4):
        got = ranks["w4"].result(r)[key]
        assert abs(got["loss"] - loss) <= TOL_LOSS * abs(loss)
        for k in SCHEDULES:
            np.testing.assert_allclose(got[k], params[k], rtol=TOL_PARAMS)
        assert got["bytes"] == 4 * (4 * 2 + 1)


@pytest.mark.parametrize("grid", COUNTER_GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_collective_counters_match_the_model_and_jax(ranks, grid):
    """Per iteration: the op counts of JAX's compiled rpallas loop, and each
    byte count within 10 % of ici_traffic_model and of JAX's HLO audit."""
    from lenslesspicam_tpu.parallel.spatial import hlo_collective_bytes_per_iter
    from lenslesspicam_tpu_torch.parallel.spatial import ici_traffic_model

    ph, pw, planes, batch = grid
    hlo = hlo_collective_bytes_per_iter(_mesh(4), ph, pw, nplanes=planes, batch=batch)
    model = ici_traffic_model(ph, pw, 4, nplanes=planes, batch=batch)
    got = ranks["w4"].result()[f"counters_{ph}x{pw}"]
    assert got["op_counts"] == hlo["op_counts"] == {
        "all-to-all": 2, "all-gather": 4, "collective-permute": 2}
    for k in ("a2a_bytes_per_iter", "gather_bytes_per_iter", "halo_bytes_per_iter",
              "total_ici_bytes_per_iter"):
        assert abs(got[k] - model[k]) <= TOL_BYTES * model[k], k
        assert abs(got[k] - hlo[k]) <= TOL_BYTES * hlo[k], k


@pytest.mark.parametrize("backend", list(SPATIAL_SEEDS))
def test_spatial_sharded_admm_matches_jax(ranks, backend):
    """Each backend at 4 ranks against the JAX package's at 4 devices."""
    from lenslesspicam_tpu.parallel.spatial import spatial_sharded_admm
    from lenslesspicam_tpu.recon import admm

    psf, data = _spatial_problem(SPATIAL_SEEDS[backend])
    ref = np.asarray(spatial_sharded_admm(_mesh(4), admm.make_convolver(psf), data,
                                          n_iter=N_ITER, backend=backend))
    out = ranks["w4"].result()[f"spatial_{backend}"]
    assert out.shape == ref.shape == (2, 1, 32, 48, 3)
    tol = TOL_XLA if backend == "xla" else TOL_KERNEL
    np.testing.assert_allclose(out, ref, atol=tol)
    for r in range(1, 4):       # every rank returns the whole reconstruction
        np.testing.assert_array_equal(ranks["w4"].result(r)[f"spatial_{backend}"], out)


def test_spatial_auto_picks_xla_on_the_cpu(ranks):
    assert ranks["w4"].result()["auto_backend"] == "xla"


def test_filtered_synthesis_sharded_matches_jax(ranks):
    """The JAX round trip (tests/test_sharding.py) at 4 shards."""
    import jax.numpy as jnp

    from lenslesspicam_tpu.ops.fft_conv import filtered_synthesis

    x, H, _ = _fs_problem()
    ref = np.asarray(filtered_synthesis(jnp.asarray(x), jnp.asarray(H), (64, 96)))
    np.testing.assert_allclose(ranks["w4"].result()["fs"], ref, atol=TOL_FS)


@pytest.mark.parametrize("key,shape", [("batch", (1, 8, 4, 1, 5)), ("depth", (4, 4, 2, 2, 3))])
def test_sharded_admm_run_matches_jax(ranks, key, shape):
    """Batch over data = 4; 4 depths over (data, depth) = (2, 2)."""
    from lenslesspicam_tpu.recon import admm

    depth, batch, _, _, n = shape
    psf, data = _admm_problem(depth, batch)
    ref = np.asarray(admm.run_jit(admm.make_convolver(psf), data, n_iter=n))
    np.testing.assert_allclose(ranks["w4"].result()[f"sharded_{key}"], ref, atol=TOL_SHARDED)


def test_ici_traffic_model_is_the_jax_model():
    from lenslesspicam_tpu.parallel.spatial import ici_traffic_model as jmodel
    from lenslesspicam_tpu_torch.parallel.spatial import ici_traffic_model

    for args in ((6144, 8192, 8), (1536, 2048, 4, 3, 2), (64, 96, 1)):
        assert ici_traffic_model(*args) == jmodel(*args)


def test_benchmark_mesh_matches_jax_and_mesh_none(ranks):
    """Two ranks each evaluate half of every batch; every rank returns the
    JAX benchmark's numbers on a 2-device mesh, and its own mesh=None
    numbers (shot noise included)."""
    import jax.numpy as jnp

    from lenslesspicam_tpu.eval import benchmark as jbench
    from lenslesspicam_tpu.recon import admm
    from lenslesspicam_tpu.recon.base import ADMM

    psf, batches = _bench_problem()
    conv = admm.make_convolver(psf)
    ref = jbench.benchmark(lambda x: admm.run_jit(conv, jnp.asarray(x), n_iter=3), batches,
                           model=ADMM(psf, n_iter=3), mesh=_mesh(2, "data"))
    for r in range(2):
        got = ranks["w2"].result(r)
        assert list(got["mesh"]) == list(ref)
        for k in ref:
            assert abs(got["mesh"][k] - ref[k]) <= TOL_BENCH * abs(ref[k]), k
        for key in ("mesh", "snr_mesh"):
            none = got[key.replace("mesh", "none")]
            assert list(got[key]) == list(none)
            for k in none:
                assert abs(got[key][k] - none[k]) <= TOL_BENCH_SELF * abs(none[k]), (key, k)


def test_meshes_over_simulated_hosts(ranks):
    """Two hosts of 2 ranks: the data dim spans hosts and sp does not; a
    mesh whose sp dim crosses hosts is refused; the hybrid layout; a
    placed array's blocks and their gather."""
    got = ranks["w4"].result(3)
    m = got["multihost"]
    assert m["grid"] == [[0, 1], [2, 3]] and m["hybrid"] == [[0, 1], [2, 3]]
    assert m["data_spans"] and not m["sp_spans"] and m["refused"]
    p = got["placement"]
    assert p["shape"] == (4, 3) and p["err"] == 0.0
    np.testing.assert_array_equal(p["gathered"], np.arange(48, dtype=np.float32).reshape(8, 6))


def test_cpu_dryrun_two_hosts_of_two_ranks(dryrun):
    r = dryrun.result(timeout=300)
    assert r["ok"] and r["processes"] == 4 and r["hosts"] == 2
    assert r["spatial_rel_err"] < 1e-5
    assert r["dp_rel_err"] < 1e-5
    assert r["grad_psum_rel_err"] < 1e-5
    assert r["allreduce_bytes"] == 4 * (8 + 1)       # the gradient and the loss
    assert r["dcn_grad_bytes_per_host"] == 32


def test_dcn_traffic_model_is_the_jax_model():
    from lenslesspicam_tpu.parallel import distributed as jdist

    for args in ((100_000_000, 4), (1000, 1), (4 * 8_000_000, 8, 123)):
        assert tdist.dcn_traffic_model(*args) == jdist.dcn_traffic_model(*args)
    for hosts in (1, 2, 8):
        assert tdist.dcn_scaling_efficiency(0.5, 4 * 8_000_000, hosts) == \
            jdist.dcn_scaling_efficiency(0.5, 4 * 8_000_000, hosts)


# rank 1 prints 1 MB, more than a pipe holds, then leaves a mark; rank 0 waits
# for the mark, as a rank waits for its peers in a collective
_CHATTY_RANKS = """
import os, sys, time
mark = os.environ["LPT_TEST_MARK"]
if os.environ["LPT_PROCESS_ID"] == "1":
    sys.stdout.write("x" * (1 << 20))
    sys.stdout.flush()
    open(mark, "w").close()
else:
    t0 = time.monotonic()
    while not os.path.exists(mark):
        if time.monotonic() - t0 > 60:
            sys.exit(3)
        time.sleep(0.01)
    print("rank 0 done")
"""


def test_wait_ranks_drains_every_pipe_at_once(tmp_path):
    """A rank that writes 1 MB while rank 0 waits for it does not stall the
    group: ``wait_ranks`` reads every rank's pipe at once and returns in
    seconds, with each rank's whole output."""
    import time

    t0 = time.monotonic()
    outs = tdist.wait_ranks(tdist.spawn_cpu_ranks(
        ["-c", _CHATTY_RANKS], 2, timeout=30, env={"LPT_TEST_MARK": str(tmp_path / "mark")}))
    assert time.monotonic() - t0 < 15
    assert outs[0].strip() == "rank 0 done" and outs[1] == "x" * (1 << 20)


def test_wait_ranks_reports_the_rank_that_failed():
    """A rank that exits non-zero is named with the tail of its output,
    while a peer still runs; the peer is killed."""
    prog = ("import os, sys, time\n"
            "if os.environ['LPT_PROCESS_ID'] == '1':\n"
            "    print('rank 1 gives up'); sys.exit(5)\n"
            "time.sleep(60)\n")
    started = tdist.spawn_cpu_ranks(["-c", prog], 2, timeout=30)
    with pytest.raises(RuntimeError, match=r"rank 1 failed \(rc=5\):\nrank 1 gives up"):
        tdist.wait_ranks(started)
    assert all(p.poll() is not None for p in started[0])
