"""Device-mesh sharding for reconstruction and training (port of
lenslesspicam_tpu/parallel/sharding.py).

A ``("data", "depth")`` ``DeviceMesh``, one rank a device:

* ``data`` -- the batch of measurements (dataset-scale evaluation,
  data-parallel training);
* ``depth`` -- the depths of a 3-D PSF stack.

Each rank holds its block of the batch and of the depths.  Depths and
batch elements are independent in every solver of the port, so a
sharded solve needs no collective until its result is gathered; a
data-parallel train step averages its gradients over the mesh
(``train/steps.py``, for parameters placed by :func:`replicate`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .distributed import (NamedSharding, all_gather, broadcast, device_mesh, local_device,
                          mesh_group, put_global)


def make_mesh(n_data: int | None = None, n_depth: int = 1, devices=None):
    """A ``(data, depth)`` mesh of the ranks ``devices`` (None: all), the
    first ``n_data * n_depth`` of them, data major."""
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if n_data is None:
        n_data = len(ranks) // n_depth
    assert n_data * n_depth <= len(ranks), "not enough ranks"
    grid = np.asarray(ranks[: n_data * n_depth]).reshape(n_data, n_depth)
    return device_mesh(grid, ("data", "depth"))


def batch_spec() -> tuple:
    """(batch, depth, H, W, C): the batch split over 'data', the depths
    over 'depth'."""
    return ("data", "depth")


def conv_spec() -> tuple:
    """``FFTConvolver.H`` is (depth, Ph, Pw/2+1, C): the depths split."""
    return ("depth",)


def shard_convolver(mesh, conv):
    """The convolver of this rank's block of depths: its spectrum's depth
    slice, and its shapes' depth the block's."""
    H = put_global(conv.H, NamedSharding(mesh, conv_spec())).data
    d = H.shape[0]
    return dataclasses.replace(conv, H=H, psf_shape=(d,) + tuple(conv.psf_shape[1:]),
                               padded_shape=(d,) + tuple(conv.padded_shape[1:]))


def shard_batch(mesh, data):
    """This rank's (batch, depth) block of a (B, D, H, W, C) array."""
    return put_global(data, NamedSharding(mesh, batch_spec())).data


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh, tree):
    """Every tensor of ``tree`` (a tensor, or dicts, lists and tuples of
    them) broadcast in place from the mesh's first rank to all of its
    ranks, on the rank's device, and marked as placed on ``mesh``: a train
    step (``train/steps.make_train_step``) averages the gradients of such
    parameters over the mesh.  Returns the tree."""
    group = mesh_group(mesh)
    src = int(mesh.mesh.reshape(-1)[0])
    dev = local_device()

    def place(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.device != dev:
            raise ValueError(f"replicate: a tensor on {t.device}, the mesh's rank is on {dev}")
        broadcast(t, src, group)
        t._lpt_mesh = mesh
        return t

    return _map(place, tree)


def sharded_admm_run(mesh, conv, data, params=None, n_iter=100):
    """Batch- and depth-sharded classical ADMM over the mesh: each rank
    solves its (batch, depth) block with ``recon/admm.run``, and the blocks
    are all-gathered (depths, then batch), so every rank returns the
    whole (B, D, H, W, C) reconstruction.  No collective in the loop."""
    from ..recon import admm

    if params is None:
        params = admm.ADMMParams()
    conv_l = shard_convolver(mesh, conv)
    data_l = shard_batch(mesh, data)
    out = admm.run(conv_l, data_l, params, n_iter)
    out = all_gather(out, 1, mesh.get_group("depth"))
    return all_gather(out, 0, mesh.get_group("data"))
