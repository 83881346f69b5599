"""Carry solver constants, state and weights across from the JAX package.

The single-image solvers have no learned weights: what stands in for
them is the loop-invariant operator set and the solver state.  The LPIPS
metric has weights (:func:`lpips_state_dict`), and so do the learned
models (:func:`state_dict`, :func:`to_variables`, :func:`random_variables`).
These functions take plain numpy arrays (``np.asarray`` of the JAX arrays,
keyed by the JAX field names) and build the port's structures; nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ._device import resolve_device
from .ops.fft_conv import FFTConvolver
from .recon.admm import ADMMParams, ADMMPrecomp, ADMMState
from .recon.admm_split import ARRAY_FIELDS, SPLIT_FIELDS, RSplitPrecomp, SplitPrecomp


def _t(x, device, dtype=None):
    return torch.from_numpy(np.array(x, dtype)).to(device)


def tensor(x, device=None) -> torch.Tensor:
    """A numpy array (``np.asarray`` of a JAX array) as a tensor of the
    same dtype on ``device``.  bfloat16 arrays (numpy dtype
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) travel
    bit for bit as int16 and are viewed back as ``torch.bfloat16``."""
    device = resolve_device(device)
    a = np.array(x, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def admm_params(params) -> ADMMParams:
    """The port's ADMMParams from any (mu1, mu2, mu3, tau) record."""
    return ADMMParams(*(float(getattr(params, f)) for f in ADMMParams._fields))


def rsplit_precomp(arrays: dict, psf_shape, padded_shape, start,
                   device=None) -> RSplitPrecomp:
    """The port's RSplitPrecomp from the JAX RSplitPrecomp's arrays."""
    device = resolve_device(device)
    return RSplitPrecomp(
        *[_t(arrays[f], device, np.float32) for f in ARRAY_FIELDS],
        psf_shape=tuple(psf_shape), padded_shape=tuple(padded_shape),
        start=tuple(start))


def rsplit_general_precomp(arrays: dict, info: dict, psf_shape, padded_shape, start,
                           device=None):
    """``(pre, info)`` of the port's batched solver (``run_rsplit_general``)
    from the JAX ``precompute_rsplit_general`` result: its stacked
    RSplitPrecomp's arrays (a leading axis over the D * C planes) and its
    info dict."""
    pre = rsplit_precomp(arrays, psf_shape, padded_shape, start, device)
    return pre, {k: int(info[k]) for k in ("batch", "depth", "channels")}


def split_precomp(arrays: dict, psf_shape, padded_shape, start,
                  device=None) -> SplitPrecomp:
    """The port's SplitPrecomp (full-width solver) from the JAX
    SplitPrecomp's arrays: one plane, or a stack on a leading axis."""
    device = resolve_device(device)
    return SplitPrecomp(
        *[_t(arrays[f], device, np.float32) for f in SPLIT_FIELDS],
        psf_shape=tuple(psf_shape), padded_shape=tuple(padded_shape),
        start=tuple(start))


def split_general_precomp(arrays: dict, info: dict, psf_shape, padded_shape, start,
                          device=None):
    """``(pre, info)`` of the port's batched full-width solver
    (``run_split_general``) from the JAX ``precompute_split_general``
    result: its stacked SplitPrecomp's arrays and its info dict."""
    pre = split_precomp(arrays, psf_shape, padded_shape, start, device)
    return pre, {k: int(info[k]) for k in ("batch", "depth", "channels")}


def convolver(H, psf_shape, padded_shape, start, pad, norm, shift_folded,
              device=None) -> FFTConvolver:
    """The port's FFTConvolver from the JAX FFTConvolver's spectrum and
    geometry."""
    device = resolve_device(device)
    return FFTConvolver(H=_t(H, device, np.complex64),
                        psf_shape=tuple(psf_shape),
                        padded_shape=tuple(padded_shape), start=tuple(start),
                        pad=bool(pad), norm=norm,
                        shift_folded=bool(shift_folded))


def admm_precomp(arrays: dict, device=None) -> ADMMPrecomp:
    """The exact solver's ADMMPrecomp from the JAX one's arrays."""
    device = resolve_device(device)
    return ADMMPrecomp(*[_t(arrays[f], device, np.float32)
                         for f in ADMMPrecomp._fields])


def admm_state(arrays: dict, device=None) -> ADMMState:
    """The exact solver's ADMMState from the JAX one's arrays."""
    device = resolve_device(device)
    return ADMMState(*[_t(arrays[f], device, np.float32)
                       for f in ADMMState._fields])


def lpips_state_dict(variables) -> dict:
    """The port's LPIPS ``state_dict`` (``eval.lpips.LPIPS``) from the JAX
    package's LPIPS variables as numpy arrays: the flax tree ``{"params":
    {net: {conv: {"kernel": HWIO, "bias"}}, "lin<i>": (C,)}}`` (or the
    tree under "params").  Kernels become OIHW."""
    params = variables.get("params", variables)
    sd = {}
    for key, value in params.items():
        if isinstance(value, dict):
            for conv, leaves in value.items():
                kernel = np.transpose(np.asarray(leaves["kernel"], np.float32), (3, 2, 0, 1))
                sd[f"{key}.{conv}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
                sd[f"{key}.{conv}.bias"] = torch.from_numpy(np.array(leaves["bias"], np.float32))
        else:
            sd[key] = torch.from_numpy(np.array(value, np.float32).reshape(-1))
    return sd


# --- the learned models ------------------------------------------------------
#
# One table per model maps each leaf of the JAX package's flax variables to
# the port's state_dict key: (collection, flax path, torch key, kind).  The
# port's keys are those of the reference LenslessPiCam torch modules, which
# the JAX package's zoo/convert.py reads; the kind says how the array is laid
# out on each side.

def _to_torch(kind, a):
    if kind == "conv":           # flax (kH, kW, I, O) -> torch (O, I, kH, kW)
        return np.transpose(a, (3, 2, 0, 1))
    if kind == "conv_t":         # flax ConvTranspose (kH, kW, I, O) -> torch (I, O, kH, kW),
        # unflipped: zoo/convert.py flips torch's kernel (torch correlates
        # where lax.conv_transpose convolves)
        return np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    if kind == "nhwc":           # MultiWiener's gain: flax (1, 1, 1, P) -> torch (1, P, 1, 1)
        return np.transpose(a, (0, 3, 1, 2))
    return a


def _to_flax(kind, t):
    if kind == "conv":
        return np.transpose(t, (2, 3, 1, 0))
    if kind == "conv_t":
        return np.transpose(t[:, :, ::-1, ::-1], (2, 3, 0, 1))
    if kind == "nhwc":
        return np.transpose(t, (0, 2, 3, 1))
    return t


def _double_conv(fp, tp):
    """flax DoubleConv / _DoubleConvPool (Conv_0, BatchNorm_0, Conv_1,
    BatchNorm_1) <-> a torch Sequential with convs at 0, 3, BNs at 1, 4."""
    out = []
    for conv, bn, i in (("Conv_0", "BatchNorm_0", 0), ("Conv_1", "BatchNorm_1", 3)):
        out += [("params", fp + (conv, "kernel"), f"{tp}.{i}.weight", "conv"),
                ("params", fp + (bn, "scale"), f"{tp}.{i + 1}.weight", "plain"),
                ("params", fp + (bn, "bias"), f"{tp}.{i + 1}.bias", "plain"),
                ("batch_stats", fp + (bn, "mean"), f"{tp}.{i + 1}.running_mean", "plain"),
                ("batch_stats", fp + (bn, "var"), f"{tp}.{i + 1}.running_var", "plain"),
                (None, None, f"{tp}.{i + 1}.num_batches_tracked", "count")]
    return out


def _unetres(m, fp, tp):
    nb = len(m.m_down1) - 1
    out = []

    def conv(path, key, kind="conv"):
        out.append(("params", fp + path, tp + key, kind))

    def res(path, key):
        conv(path + ("conv1", "kernel"), key + ".res.0.weight")
        conv(path + ("conv2", "kernel"), key + ".res.2.weight")

    for enc, sfx in (("encoder", ""), ("encoder_background", "_background")):
        if sfx and not m.background_subtraction:
            continue
        conv((enc, "head", "kernel"), f"m_head{sfx}.weight")
        for s in range(3):
            for j in range(nb):
                res((enc, f"down{s}_res{j}"), f"m_down{s + 1}{sfx}.{j}")
            conv((enc, f"down{s}_conv", "kernel"), f"m_down{s + 1}{sfx}.{nb}.weight")
    off = 0
    if m.concatenate_compensation:     # conv + ReLU at m_body.0, 1
        conv(("body_concat_conv", "kernel"), "m_body.0.weight")
        off = 2
    for j in range(nb):
        res((f"body_res{j}",), f"m_body.{j + off}")
    for s in range(3):
        conv((f"up{s}_conv", "kernel"), f"m_up{s + 1}.0.weight", "conv_t")
        for j in range(nb):
            res((f"up{s}_res{j}",), f"m_up{s + 1}.{j + 1}")
    conv(("tail", "kernel"), "m_tail.weight")
    if m.background_subtraction:
        conv(("subtraction_weights",), "subtraction_weights", "plain")
    return out


def _unet(m, fp, tp):
    nb = (len(m.m_down1) - 2) // 2
    out = []

    def kb(path, key, kind="conv"):
        out.extend([("params", fp + (path, "kernel"), f"{tp}{key}.weight", kind),
                    ("params", fp + (path, "bias"), f"{tp}{key}.bias", "plain")])

    kb("head", "m_head.0")
    for s in range(3):
        for j in range(nb):
            kb(f"down{s}_conv{j}", f"m_down{s + 1}.{2 * j}")
        kb(f"down{s}_down", f"m_down{s + 1}.{2 * nb}")
    for j in range(nb + 1):
        kb(f"body_conv{j}", f"m_body.{2 * j}")
    for s in range(3):
        kb(f"up{s}_up", f"m_up{s + 1}.0", "conv_t")
        for j in range(nb):
            kb(f"up{s}_conv{j}", f"m_up{s + 1}.{2 * (j + 1)}")
    kb("tail", "m_tail")
    return out


def _restormer(m, fp, tp):
    """Keyed as zoo/convert.py's torch_restormer_to_flax: a block
    ``encoder_level1.0.*`` is ``encoder_level1_0``, a layernorm's
    ``body.weight`` its ``scale``, a convolution's ``weight`` its kernel."""
    out = []
    for key in m.state_dict():
        parts = key.split(".")
        if parts[0] == "patch_embed" or parts[0].startswith(("down", "up")) \
                or parts[0].startswith("reduce_chan") or parts[0] == "output":
            path = (parts[0], "kernel" if parts[-1] == "weight" else "bias")
        else:
            parts = [f"{parts[0]}_{parts[1]}"] + parts[2:]
            if parts[-2] == "body":
                path = tuple(parts[:-2]) + ("scale" if parts[-1] == "weight" else "bias",)
            elif parts[-1] == "weight":
                path = tuple(parts[:-1]) + ("kernel",)
            else:
                path = tuple(parts)
        kind = "conv" if path[-1] == "kernel" else "plain"
        out.append(("params", fp + path, tp + key, kind))
    return out


def _multi_wiener(m, fp, tp):
    out = _double_conv(fp + ("inc",), f"{tp}inc.double_conv") + \
        _double_conv(fp + ("inc0",), f"{tp}inc0.double_conv")
    for i in range(len(m.down_layers)):
        out += _double_conv(fp + (f"down{i}", "DoubleConv_0"),
                            f"{tp}down_layers.{i}.pool_conv.1.double_conv")
    for i in range(len(m.psf_down)):
        out += _double_conv(fp + (f"psf_down{i}", "DoubleConv_0"),
                            f"{tp}psf_down.{i}.pool_conv.1.double_conv")
    for i in range(len(m.up_layers)):
        out += _double_conv(fp + (f"up{i}", "DoubleConv_0"), f"{tp}up_layers.{i}.conv.double_conv")
    return out + [("params", fp + ("outc", "kernel"), f"{tp}outc.conv.weight", "conv"),
                  ("params", fp + ("outc", "bias"), f"{tp}outc.conv.bias", "plain"),
                  ("params", fp + ("delta",), f"{tp}delta", "plain"),
                  ("params", fp + ("w",), f"{tp}w", "nhwc")]


def _compensation(m, fp, tp):
    from .models.compensation import ResPool

    out = []
    for i in range(len(m.branch_layers)):
        out += _double_conv(fp + (f"branch{i}",), f"{tp}branch_layers.{i}")
    for i, layer in enumerate(m.residual_layers):
        if isinstance(layer, ResPool):
            out += _double_conv(fp + (f"res{i}", "_DoubleConvPool_0"),
                                f"{tp}residual_layers.{i}.double_conv")
        else:
            out += _double_conv(fp + (f"res{i}",), f"{tp}residual_layers.{i}")
    return out


def _inversion(m, fp, tp):
    from .models.inversion import SVDeconvNet
    from .models.unrolled import UnrolledADMM, UnrolledFISTA

    names = ()
    if isinstance(m, UnrolledADMM) and m.learn_params:
        names = (("mu1", "_mu1_p"), ("mu2", "_mu2_p"), ("mu3", "_mu3_p"), ("tau", "_tau_p"))
    elif isinstance(m, UnrolledFISTA) and m.learn_params:
        names = (("alpha", "_alpha_p"),) + (
            (("tk", "_tk_p"),) if isinstance(m._tk_p, nn.Parameter) else ())
    elif isinstance(m, SVDeconvNet) and m.learn_multipsf:
        names = (("multipsf", "multipsf"),)
    return [("params", fp + (f,), tp + t, "plain") for f, t in names]


def _entries(m, fp=(), tp=""):
    """The (collection, flax path, torch key, kind) table of a port module."""
    from .models.background import IntegratedBackgroundSub
    from .models.compensation import CompensationBranch
    from .models.multi_wiener import MultiWiener
    from .models.restormer import Restormer
    from .models.trainable_recon import TrainableRecon
    from .models.unet import UNet, UNetRes

    if isinstance(m, UNetRes):
        return _unetres(m, fp, tp)
    if isinstance(m, IntegratedBackgroundSub):
        return _unetres(m.unet, fp + ("unet",), tp + "unet.")
    if isinstance(m, UNet):
        return _unet(m, fp, tp)
    if isinstance(m, Restormer):
        return _restormer(m, fp, tp)
    if isinstance(m, MultiWiener):
        return _multi_wiener(m, fp, tp)
    if isinstance(m, CompensationBranch):
        return _compensation(m, fp, tp)
    if isinstance(m, TrainableRecon):
        out = []
        if m.camera_inversion is not None:
            out += _inversion(m.camera_inversion, fp + ("camera_inversion",),
                              tp + "camera_inversion.")
        for name, block in (("pre_process", "pre_block"), ("post_process", "post_block"),
                            ("psf_network", "psf_block"),
                            ("background_network", "background_block")):
            net = getattr(m, f"{name}_model")
            if net is not None:
                out += _entries(net, fp + (name,), f"{tp}{name}_model.")
                out.append(("params", fp + (block, "noise_level"), f"{tp}{name}_param",
                            "plain"))
        if m.compensation_branch is not None:
            out += _entries(m.compensation_branch, fp + ("compensation_branch",),
                            tp + "compensation_branch.")
        return out
    return _inversion(m, fp, tp)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def state_dict(module, variables) -> dict:
    """The port's ``state_dict`` for ``module`` (a ``UNetRes``, ``UNet``,
    ``IntegratedBackgroundSub``, ``UnrolledADMM``, ``UnrolledFISTA``,
    ``SVDeconvNet``, ``MultiWiener``, ``CompensationBranch``, ``Restormer`` or
    a whole ``TrainableRecon``) from the JAX package's variables of the same
    model as numpy arrays (``{"params": ..., "batch_stats": ...}``, as
    ``flax.serialization.to_state_dict`` gives them).  BatchNorm counters are
    0.  ``module.load_state_dict`` takes the result."""
    sd = {}
    for coll, path, key, kind in _entries(module):
        if kind == "count":
            sd[key] = torch.zeros((), dtype=torch.long)
            continue
        a = _to_torch(kind, np.asarray(_leaf(variables[coll], path), np.float32))
        sd[key] = torch.from_numpy(np.array(a, order="C"))     # a writable copy
    return sd


def to_variables(module, sd=None) -> dict:
    """The JAX package's variables (numpy arrays in the flax layout) of
    ``module``'s weights, or of the state dict ``sd``: the inverse of
    :func:`state_dict`."""
    sd = module.state_dict() if sd is None else sd
    out: dict = {}
    for coll, path, key, kind in _entries(module):
        if kind == "count":
            continue
        node = out.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(
            _to_flax(kind, sd[key].detach().cpu().numpy().astype(np.float32)))
    return out


def random_variables(module, seed: int = 0) -> dict:
    """Seeded JAX-layout variables for ``module``, drawn with numpy on the
    host (tests and plumbing, not trained weights): convolution kernels
    normal with variance 1 / fan_in, biases and BatchNorm means 0.1 times a
    normal, every other leaf (scales, variances, schedules, gains) its
    initial value times a uniform factor in [0.75, 1.25].  A parameter made
    on the first call (``UnrolledFISTA``'s steps, ``SVDeconvNet``'s PSFs)
    must exist first."""
    rng = np.random.RandomState(seed)
    init = module.state_dict()
    sd = {}
    for _, _, key, kind in _entries(module):
        if kind == "count":
            continue
        shape = init[key].shape
        if kind in ("conv", "conv_t"):     # torch (O, I, kH, kW) / (I, O, kH, kW)
            fan_in = shape[1] * shape[2] * shape[3] if kind == "conv" else \
                shape[0] * shape[2] * shape[3]
            value = rng.randn(*shape) / np.sqrt(fan_in)
        elif key.endswith((".bias", "running_mean")):
            value = 0.1 * rng.randn(*shape)
        else:
            value = init[key].detach().cpu().numpy() * rng.uniform(0.75, 1.25, shape)
        sd[key] = torch.from_numpy(value.astype(np.float32))
    return to_variables(module, sd)
