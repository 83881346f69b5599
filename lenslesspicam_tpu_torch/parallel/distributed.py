"""Multi-host execution layer (port of lenslesspicam_tpu/parallel/distributed.py).

A ``torch.distributed`` process group (NCCL between CUDA cards, gloo on the
CPU), one process a device, and ``DeviceMesh``es with named dims whose
leading ``data`` dim spans hosts while the trailing dims stay inside one
host.  Ranks are grouped into hosts by ``LOCAL_WORLD_SIZE`` (torchrun sets
it; the CPU dryrun sets it to fake several hosts on one machine): rank r
lives on host ``r // LOCAL_WORLD_SIZE``.

Design rule: put the ``data`` dim on the network between hosts (one
gradient all-reduce a step, amortized over the whole batch) and keep the
chatty dims (the spatial solver's pencil all-to-alls, depth) on NVLink
inside a host.  :func:`axis_spans_processes` / :func:`assert_ici_axes`
make the rule checkable.

Every collective of the port goes through the counted helpers here
(:func:`all_to_all`, :func:`all_gather`, :func:`ring_shift`,
:func:`all_reduce_mean`, :func:`broadcast`): each adds its call and its
bytes to :func:`collective_counts`, as the kernels' wrappers count their
launches.  Byte conventions are those of the JAX package's HLO audits:
an all-to-all counts the (n-1)/n of its local bytes that leave the
device, an all-gather the (n-1)/n of its output that arrives, a ring
shift its whole payload, an all-reduce and a broadcast their tensor's
bytes.

Verified end to end by :func:`run_cpu_dryrun` (``python -m
lenslesspicam_tpu_torch.parallel.distributed``): 2 hosts x 2 gloo ranks
rebuild the (data, sp), (data, depth) and (data, chip) meshes, run the
row-sharded spatial ADMM with the batch over hosts, the batch- and
depth-sharded solver and a data-parallel gradient all-reduce, and match
one process's results to 1e-5 (``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "data"
COLLECTIVES = ("all-to-all", "all-gather", "collective-permute", "all-reduce", "broadcast")
_COUNTS = {op: [0, 0.0] for op in COLLECTIVES}
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device=None):
    """Join the process group and return ``(rank, world_size)``.

    ``coordinator_address`` is ``host:port`` of rank 0's store.  Fallbacks:
    ``LPT_COORDINATOR`` / ``LPT_NUM_PROCESSES`` / ``LPT_PROCESS_ID`` (the
    JAX package's names), then torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``; with none of them, a group of one process on
    a free local port.  ``device`` None is the CUDA card (NCCL; the card is
    ``LOCAL_RANK``, else ``rank % device_count``), ``"cpu"`` gloo.  A
    process that has joined a group already gets its rank and size back."""
    from .._device import resolve_device

    env = os.environ
    coordinator_address = coordinator_address or env.get("LPT_COORDINATOR")
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env.get("LPT_NUM_PROCESSES") or env.get("WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(env.get("LPT_PROCESS_ID") or env.get("RANK") or 0)
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError("a group of several processes needs a coordinator address")
        coordinator_address = f"127.0.0.1:{_free_port()}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{coordinator_address}",
                                rank=int(process_id), world_size=int(num_processes))
    return dist.get_rank(), dist.get_world_size()


def shutdown():
    """Leave the process group (``jax.distributed.shutdown``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def device_type() -> str:
    """"cuda" in an NCCL group, "cpu" in a gloo one."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def local_device() -> torch.device:
    """This rank's device: its current card in an NCCL group, else the CPU."""
    if device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def ranks_per_host() -> int:
    """Ranks on one host: ``LOCAL_WORLD_SIZE``, else the whole world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def host_of(rank):
    """The host index of a global rank (or of an array of ranks)."""
    return np.asarray(rank) // ranks_per_host()


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def device_mesh(grid, axis_names):
    """A ``DeviceMesh`` over the global ranks ``grid`` (an int array, one
    dim a name): ``init_device_mesh`` where the grid is every rank in
    order, else a mesh of the given ranks.  Every rank of the world calls
    it (it makes the dims' process groups)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    grid = np.asarray(grid, dtype=np.int64)
    names = tuple(axis_names)
    if np.array_equal(grid.reshape(-1), np.arange(dist.get_world_size())):
        return init_device_mesh(device_type(), grid.shape, mesh_dim_names=names)
    return DeviceMesh(device_type(), torch.as_tensor(grid), mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """The size of the mesh dim named ``axis``."""
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


_GROUPS = {}


def mesh_group(mesh):
    """The process group of all the mesh's ranks: the world's where the
    mesh holds every rank, else a group made once for those ranks (every
    rank of the world calls it the first time)."""
    ranks = tuple(sorted(int(r) for r in mesh.mesh.reshape(-1).tolist()))
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def _sorted_ranks(devices):
    ranks = list(range(dist.get_world_size()) if devices is None else devices)
    return sorted(int(r) for r in ranks)


def multihost_mesh(inner_axes=("sp",), inner_shape=None, data_axis=AXIS_DATA,
                   devices=None):
    """(hosts x ranks of a host) mesh: ``data_axis`` spans hosts (the
    network), ``inner_axes`` factor each host's ranks (NVLink).

    ``devices`` are global ranks (None: all), ordered by host so that each
    row of the mesh is one host's ranks, the invariant that keeps every
    ``inner_axes`` collective inside a host.  A single host gives a data
    dim of size 1, so call sites need no branching."""
    ranks = _sorted_ranks(devices)
    hosts = host_of(ranks)
    nhosts = len(set(hosts.tolist()))
    per_host = len(ranks) // nhosts
    assert nhosts * per_host == len(ranks), "uneven ranks per host"
    if inner_shape is None:
        inner_shape = (per_host,)
    assert int(np.prod(inner_shape)) == per_host, (
        f"inner_shape {inner_shape} != {per_host} ranks of a host")
    grid = np.array(ranks).reshape((nhosts,) + tuple(inner_shape))
    mesh = device_mesh(grid, (data_axis,) + tuple(inner_axes))
    assert_ici_axes(mesh, inner_axes)
    return mesh


def hybrid_mesh(ici_shape, dcn_shape, axis_names, devices=None):
    """A mesh whose dim i has ``dcn_shape[i]`` host blocks of
    ``ici_shape[i]`` ranks of one host each (``mesh_utils.
    create_hybrid_device_mesh``'s layout): the ranks, ordered by host, are
    laid out as (dcn..., ici...) and each dcn factor is put outside its ici
    factor."""
    ranks = _sorted_ranks(devices)
    k = len(axis_names)
    grid = np.array(ranks).reshape(tuple(dcn_shape) + tuple(ici_shape))
    grid = grid.transpose([a for i in range(k) for a in (i, k + i)])
    return device_mesh(grid.reshape([d * i for d, i in zip(dcn_shape, ici_shape)]),
                       axis_names)


def axis_spans_processes(mesh, axis) -> bool:
    """True when a shift along ``axis`` crosses a host boundary: that
    dim's collectives ride the network between hosts, not NVLink."""
    hosts = host_of(mesh.mesh.numpy())
    ax = mesh.mesh_dim_names.index(axis)
    return bool((hosts != np.roll(hosts, 1, axis=ax)).any())


def assert_ici_axes(mesh, axes):
    """Fail loudly if a chatty dim (spatial pencils, depth) spans hosts:
    the one layout mistake that silently turns every per-iteration
    all-to-all into a transfer over the network between hosts."""
    for ax in axes:
        if ax in mesh.mesh_dim_names and axis_spans_processes(mesh, ax):
            raise ValueError(
                f"mesh dim '{ax}' spans hosts; per-iteration collectives must stay "
                "inside a host: put only the data dim across hosts (multihost_mesh "
                "does this by construction)")


# ---------------------------------------------------------------------------
# placement of host arrays
# ---------------------------------------------------------------------------


class NamedSharding(NamedTuple):
    """Placement of an array over a mesh: ``spec[d]`` names the mesh dim (or
    a tuple of dims, the first the major one) that splits array dim d, None
    (or a missing entry) for a dim every rank holds whole."""

    mesh: object
    spec: tuple


class LocalShard(NamedTuple):
    """This rank's block of a global array: its tensor, its index (slices
    into the global array) and the global shape (the JAX array's one
    addressable shard)."""

    data: torch.Tensor
    index: tuple
    shape: tuple
    sharding: NamedSharding


def _axes(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _index_at(sharding: NamedSharding, shape, coord) -> tuple:
    """The slices of the block of a ``shape`` array at mesh coordinate
    ``coord`` (one int a mesh dim)."""
    mesh, names = sharding.mesh, sharding.mesh.mesh_dim_names
    index = []
    for d, n_el in enumerate(shape):
        axes = _axes(sharding.spec[d] if d < len(sharding.spec) else None)
        n, k = 1, 0
        for a in axes:
            i = names.index(a)
            size = int(mesh.mesh.shape[i])
            n, k = n * size, k * size + int(coord[i])
        if n_el % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes} ({n})")
        chunk = n_el // n
        index.append(slice(k * chunk, (k + 1) * chunk))
    return tuple(index)


def local_index(sharding: NamedSharding, shape) -> tuple:
    """This rank's slices of a ``shape`` array placed by ``sharding``."""
    return _index_at(sharding, shape, sharding.mesh.get_coordinate())


def put_global(arr, sharding: NamedSharding) -> LocalShard:
    """Place a global array: every rank holds the full host array (cheap
    for precomputed planes) and slices its own block out of it, onto its
    device.  ``arr`` is a numpy array or a tensor on any device."""
    shape = tuple(arr.shape)
    index = local_index(sharding, shape)
    if isinstance(arr, torch.Tensor):
        data = arr[index].to(local_device())
    else:
        data = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)[index])).to(local_device())
    return LocalShard(data.contiguous(), index, shape, sharding)


def gather_global(x) -> np.ndarray:
    """A global array as a host numpy array on EVERY rank: a
    :class:`LocalShard` through one all-gather over the world (every rank
    of the world in the mesh), a tensor or an array as it is."""
    if not isinstance(x, LocalShard):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    mesh = x.sharding.mesh
    world = dist.get_world_size()
    local = x.data.contiguous()
    parts = torch.empty((world * local.shape[0],) + tuple(local.shape[1:]),
                        dtype=local.dtype, device=local.device)
    _count("all-gather", parts.numel() * parts.element_size() * (world - 1) / world)
    dist.all_gather_into_tensor(parts, local)
    parts = parts.reshape((world,) + tuple(local.shape))
    out = np.empty(x.shape, dtype=parts.cpu().numpy().dtype)
    grid = mesh.mesh.numpy()
    for r in range(world):
        coord = np.argwhere(grid == r)[0]
        out[_index_at(x.sharding, x.shape, coord)] = parts[r].cpu().numpy()
    return out


def max_local_shard_err(global_arr: LocalShard, ref: np.ndarray) -> float:
    """max |shard - ref[shard.index]| over this rank's block: the
    collective-free way to check a placed result against a host reference
    (every rank checks its own block)."""
    return float(np.abs(global_arr.data.detach().cpu().numpy() - ref[global_arr.index]).max())


# ---------------------------------------------------------------------------
# counted collectives
# ---------------------------------------------------------------------------


def _count(op: str, nbytes: float):
    _COUNTS[op][0] += 1
    _COUNTS[op][1] += float(nbytes)


def reset_collective_counts():
    for c in _COUNTS.values():
        c[0], c[1] = 0, 0.0


def collective_counts() -> dict:
    """{op: {"calls": n, "bytes": b}} since the last reset."""
    return {op: {"calls": c[0], "bytes": c[1]} for op, c in _COUNTS.items()}


def _group_size(group) -> int:
    return dist.get_world_size(group)


def _real(x):
    """A complex tensor as its real view (..., 2); a real one as it is."""
    return torch.view_as_real(x) if x.is_complex() else x


def all_to_all(x, split_axis: int, concat_axis: int, group=None):
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over
    ``group``: ``split_axis`` is cut into n chunks, chunk j goes to the
    group's rank j, and the chunks received are concatenated along
    ``concat_axis`` in rank order.  One ``all_to_all_single`` on a
    contiguous (n, ...)-leading layout."""
    n = _group_size(group)
    nd = x.dim()
    split_axis, concat_axis = split_axis % nd, concat_axis % nd
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not "
                         f"divide over {n} ranks")
    xs = x.unflatten(split_axis, (n, x.shape[split_axis] // n)).movedim(split_axis, 0)
    send = _real(xs.contiguous())
    recv = torch.empty_like(send)
    _count("all-to-all", send.numel() * send.element_size() * (n - 1) / n)
    dist.all_to_all_single(recv, send, group=group)
    if x.is_complex():
        recv = torch.view_as_complex(recv)
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1).contiguous()


def all_gather(x, axis: int, group=None):
    """``lax.all_gather(x, axis, tiled=True)`` over ``group``: the ranks'
    blocks concatenated along ``axis`` in rank order (one
    ``all_gather_into_tensor``)."""
    n = _group_size(group)
    axis = axis % x.dim()
    send = _real(x.movedim(axis, 0).contiguous())
    out = torch.empty((n * send.shape[0],) + tuple(send.shape[1:]), dtype=send.dtype,
                      device=send.device)
    _count("all-gather", out.numel() * out.element_size() * (n - 1) / n)
    dist.all_gather_into_tensor(out, send, group=group)
    if x.is_complex():
        out = torch.view_as_complex(out)
    return out.movedim(0, axis).contiguous()


def ring_shift(x, forward: bool, group=None):
    """``lax.ppermute`` one step round the group's ring: forward, rank i
    receives rank i-1's ``x``; backward, rank i+1's.  One
    ``batch_isend_irecv`` of a send and a receive.  gloo refuses a pair
    from a rank to itself, so in a gloo group of one the ring is the copy
    it equals; NCCL takes the send to itself."""
    n = _group_size(group)
    send = x.contiguous()
    _count("collective-permute", send.numel() * send.element_size())
    if n == 1 and dist.get_backend(group) == "gloo":
        return send.clone()
    k = dist.get_rank(group)
    dst, src = ((k + 1) % n, (k - 1) % n) if forward else ((k - 1) % n, (k + 1) % n)
    recv = torch.empty_like(send)
    g = group or dist.group.WORLD
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(g, dst), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(g, src), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def all_reduce_mean(tensors, group=None):
    """Replace each tensor by its mean over ``group`` (a sum all-reduce
    and a division), in place; returns the tensors."""
    n = _group_size(group)
    for t in tensors:
        _count("all-reduce", t.numel() * t.element_size())
        with torch.no_grad():
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            t.div_(n)
    return tensors


def broadcast(t, src: int, group=None):
    """``t`` from global rank ``src`` to every rank of ``group``, in place
    (counted at its tensor's bytes)."""
    _count("broadcast", t.numel() * t.element_size())
    with torch.no_grad():
        dist.broadcast(t, src, group=group)
    return t


# ---------------------------------------------------------------------------
# traffic models between hosts (pair with spatial.ici_traffic_model)
# ---------------------------------------------------------------------------


def dcn_traffic_model(param_bytes: int, n_hosts: int,
                      input_bytes_per_host: int = 0) -> dict:
    """Per-step bytes between hosts for data parallelism over hosts.

    The gradient all-reduce is a ring reduce-scatter + all-gather over the
    ``data`` dim: each host sends AND receives ``2 * (H-1)/H *
    param_bytes`` a step, whatever the batch, which is why the data dim
    belongs on the network between hosts while the spatial pencils (2
    all-to-alls x 2 transforms an iteration, ``ici_traffic_model``) must
    not.  Returns bytes per host per step."""
    if n_hosts <= 1:
        grad = 0
    else:
        grad = int(2 * (n_hosts - 1) / n_hosts * param_bytes)
    return {
        "n_hosts": n_hosts,
        "grad_allreduce_bytes_per_host": grad,
        "input_bytes_per_host": input_bytes_per_host,
        "total_bytes_per_host": grad + input_bytes_per_host,
    }


def dcn_scaling_efficiency(step_time_1host_s: float, param_bytes: int,
                           n_hosts: int, dcn_gbps: float = 25.0) -> float:
    """Predicted data-parallel scaling efficiency to ``n_hosts`` hosts:
    compute time unchanged, plus the (not overlapped, worst case) gradient
    all-reduce at ``dcn_gbps`` GB/s per host."""
    t_comm = dcn_traffic_model(param_bytes, n_hosts)[
        "grad_allreduce_bytes_per_host"] / (dcn_gbps * 1e9)
    return step_time_1host_s / (step_time_1host_s + t_comm)


def allreduce_bytes(fn, *args) -> float:
    """The all-reduce bytes that ``fn(*args)`` issues through the counted
    collectives (the data-parallel gradient all-reduce when ``fn`` is a
    train step), each all-reduce counted at its tensor's bytes as the JAX
    package's HLO audit counts them."""
    before = _COUNTS["all-reduce"][1]
    fn(*args)
    return _COUNTS["all-reduce"][1] - before


# ---------------------------------------------------------------------------
# CPU dryrun: hosts x ranks of gloo processes on one machine
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_cpu_ranks(argv, n_procs: int, n_local: int | None = None,
                    timeout: int = 600, env=None):
    """Start ``n_procs`` gloo ranks on this machine, each running ``argv``
    (after ``sys.executable``) from the repository's root with the
    group's address, size and its rank in ``LPT_COORDINATOR`` /
    ``LPT_NUM_PROCESSES`` / ``LPT_PROCESS_ID``, ``LPT_DEVICE=cpu``,
    ``LOCAL_WORLD_SIZE=n_local`` (ranks a simulated host; default all) and
    one thread each.  Returns the ranks' ``Popen``s with the timeout, for
    :func:`wait_ranks`."""
    import subprocess
    import sys

    port = _free_port()
    procs = []
    for pid in range(n_procs):
        penv = dict(os.environ, **(env or {}),
                    LPT_COORDINATOR=f"127.0.0.1:{port}",
                    LPT_NUM_PROCESSES=str(n_procs), LPT_PROCESS_ID=str(pid),
                    LPT_DEVICE="cpu", LOCAL_WORLD_SIZE=str(n_local or n_procs),
                    LOCAL_RANK=str(pid % (n_local or n_procs)),
                    OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, *argv], env=penv,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, cwd=_REPO))
    return procs, timeout


def wait_ranks(started) -> list:
    """Wait for the ranks of :func:`spawn_cpu_ranks`; returns their
    outputs, and raises (with the tail of the output) if one fails or the
    group outlasts the timeout, killing the others.  Every rank's pipe is
    drained at once, by a thread each: a rank that writes more than a pipe
    holds never blocks while another rank is waited on."""
    import threading
    import time

    procs, timeout = started
    outs = [""] * len(procs)

    def drain(pid, p):
        outs[pid] = p.stdout.read()
        p.wait()

    threads = [threading.Thread(target=drain, args=(pid, p), daemon=True)
               for pid, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            for pid, (p, t) in enumerate(zip(procs, threads)):
                if not t.is_alive() and p.returncode != 0:
                    raise RuntimeError(
                        f"rank {pid} failed (rc={p.returncode}):\n{outs[pid][-3000:]}")
            alive = [pid for pid, t in enumerate(threads) if t.is_alive()]
            if not alive:
                return outs
            if time.monotonic() > deadline:
                pid = alive[0]
                procs[pid].kill()
                threads[pid].join()
                raise RuntimeError(f"rank {pid} timed out:\n{outs[pid][-2000:]}")
            threads[alive[0]].join(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join()


def run_cpu_dryrun(n_procs: int = 2, n_local: int = 4, timeout: int = 600) -> dict:
    """Run the dryrun worker on ``n_procs`` simulated hosts of ``n_local``
    gloo ranks each (``n_procs * n_local`` processes) and return rank 0's
    result dict.  Raises on any rank's failure."""
    import json

    outs = wait_ranks(spawn_cpu_ranks(
        ["-m", "lenslesspicam_tpu_torch.parallel.distributed"], n_procs * n_local,
        n_local, timeout))
    line = [ln for ln in outs[0].splitlines() if ln.startswith("MULTIHOST_RESULT ")]
    assert line, f"no result line from rank 0:\n{outs[0][-2000:]}"
    return json.loads(line[-1].split(" ", 1)[1])


def _dryrun_worker():
    """One rank of the dryrun (``python -m ...parallel.distributed``).

    1. join the group; the (data, sp) mesh: data across the simulated
       hosts, sp over each host's ranks;
    2. the row-sharded spatial ADMM with the batch sharded across hosts,
       against one process's exact solver;
    3. the (data, depth) batch- and depth-sharded solve (a 2-depth PSF,
       depth over each host's ranks), against the same;
    4. the data-parallel gradient all-reduce over every rank of a (data,
       chip) mesh against one process's autograd, with the all-reduce
       bytes and the model's prediction between hosts."""
    import json

    from ..recon import admm
    from ..train.steps import init_train_state, make_train_step
    from . import spatial
    from .sharding import replicate, sharded_admm_run

    rank, world = initialize(device=os.environ.get("LPT_DEVICE"))
    dev = local_device()
    per_host = ranks_per_host()
    nhosts = world // per_host

    rng = np.random.RandomState(0)
    psf = rng.rand(48, 64).astype(np.float32)
    psf /= np.linalg.norm(psf)
    data = rng.rand(nhosts, 1, 48, 64, 1).astype(np.float32)    # one image a host
    psf3 = rng.rand(per_host, 48, 64, 1).astype(np.float32)
    psf3 /= np.linalg.norm(psf3)
    data3 = rng.rand(nhosts, per_host, 48, 64, 1).astype(np.float32)

    conv = admm.make_convolver(psf[None, :, :, None], pad_policy="tpu", device=dev)
    ref = admm.run(conv, data, n_iter=10).cpu().numpy()
    conv3 = admm.make_convolver(psf3, pad_policy="tpu", device=dev)
    ref3 = admm.run(conv3, data3, n_iter=10).cpu().numpy()
    result = {"processes": world, "hosts": nhosts, "ranks_per_host": per_host}

    mesh_sp = multihost_mesh(inner_axes=("sp",))
    assert nhosts == 1 or axis_spans_processes(mesh_sp, AXIS_DATA)
    assert not axis_spans_processes(mesh_sp, "sp")
    out = spatial.spatial_sharded_admm(mesh_sp, conv, data, n_iter=10, backend="xla",
                                       batch_axis=AXIS_DATA).cpu().numpy()
    err_sp = float(np.abs(out - ref).max() / np.abs(ref).max())
    result["spatial_rel_err"] = err_sp
    assert err_sp < 1e-5, f"multihost spatial solve diverges: {err_sp}"

    mesh_dd = multihost_mesh(inner_axes=("depth",))
    out3 = sharded_admm_run(mesh_dd, conv3, data3, n_iter=10).cpu().numpy()
    err_dd = float(np.abs(out3 - ref3).max() / np.abs(ref3).max())
    result["dp_rel_err"] = err_dd
    assert err_dd < 1e-5, f"multihost DP solve diverges: {err_dd}"

    mesh_flat = multihost_mesh(inner_axes=("chip",))
    x_global = rng.rand(world * 2, 8).astype(np.float32)
    xs = put_global(x_global, NamedSharding(mesh_flat, ((AXIS_DATA, "chip"),))).data
    w0 = torch.arange(8.0)
    params = replicate(mesh_flat, {"w": torch.nn.Parameter(w0.clone().to(dev))})
    opt = torch.optim.SGD(list(params.values()), lr=0.0)
    step = make_train_step(lambda p, c, d: d @ p["w"], opt,
                           loss_fn=lambda pred, _: torch.mean(pred ** 2))
    state = init_train_state(params, opt)
    grad_bytes = allreduce_bytes(step, state, None, xs, None)
    g_dist = params["w"].grad.cpu().numpy()
    wl = w0.clone().requires_grad_(True)
    torch.mean((torch.from_numpy(x_global) @ wl) ** 2).backward()
    g_local = wl.grad.numpy()
    err_g = float(np.abs(g_dist - g_local).max() / max(np.abs(g_local).max(), 1e-9))
    result["grad_psum_rel_err"] = err_g
    assert err_g < 1e-5, f"cross-host gradient all-reduce diverges: {err_g}"
    result["allreduce_bytes"] = grad_bytes
    result["dcn_grad_bytes_per_host"] = dcn_traffic_model(
        param_bytes=w0.numel() * 4, n_hosts=nhosts)["grad_allreduce_bytes_per_host"]
    result["ok"] = True
    if rank == 0:
        print("MULTIHOST_RESULT " + json.dumps(result), flush=True)
    shutdown()


if __name__ == "__main__":
    # the package's module, not this ``__main__`` copy: the collective
    # counters and classes must be the ones the other modules use
    from lenslesspicam_tpu_torch.parallel import distributed

    distributed._dryrun_worker()
