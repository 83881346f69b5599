"""LPIPS with a VGG16 or AlexNet trunk (port of
lenslesspicam_tpu/eval/lpips.py).

Zhang et al. 2018: inputs in [0, 1] are mapped to [-1, 1], shifted and
scaled by the ImageNet statistics and passed through the conv trunk; the
features after each of the 5 relu taps are unit-normalized over channels
(the eps outside the sqrt), squared-differenced, weighted by the
non-negative heads ``lin0`` .. ``lin4``, averaged over space and summed.
The convolutions are ``torch.nn.functional.conv2d`` (cuDNN on the card).

No pretrained weights are in the repository or can be fetched here: the
weights are random (:func:`random_params`), a stand-in file
(:func:`make_standin_weights`), a torch ``lpips`` checkpoint
(:func:`load_torch_lpips`) or the JAX package's parameters carried over
by ``convert.lpips_state_dict``.  The port's ``state_dict`` keys are
``<net>.<conv>.weight`` (OIHW), ``<net>.<conv>.bias`` and ``lin<i>``, the
flax tree's names; the .npz fixture format is the JAX package's (flax
keys joined by '/', HWIO kernels), so one file serves both packages.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import as_tensor, resolve_device

# VGG16: (out_channels, n_convs) per stage, a 2 x 2 max pool between stages
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# AlexNet: (out_channels, kernel, stride, padding) per conv; a 3 x 3
# stride-2 max pool after relu1 and relu2
_ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
               (256, 3, 1, 1), (256, 3, 1, 1)]
# torchvision ``features.N`` indices of AlexNet's 5 convs
_ALEX_FEAT_IDX = [0, 3, 6, 8, 10]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def conv_plan(net: str = "vgg"):
    """``(name, in_ch, out_ch, kernel, stride, padding, tap)`` of each conv
    of the trunk, in order; ``tap`` is the index of the feature read after
    its relu, or None."""
    plan, cin = [], 3
    if net == "alex":
        for i, (ch, k, s, p) in enumerate(_ALEX_CONVS):
            plan.append((f"conv{i}", cin, ch, k, s, p, i))
            cin = ch
        return plan
    for stage, (ch, n_convs) in enumerate(_VGG_STAGES):
        for c in range(n_convs):
            plan.append((f"conv{stage}_{c}", cin, ch, 3, 1, 1,
                         stage if c == n_convs - 1 else None))
            cin = ch
    return plan


def torchvision_feature_index(net: str = "vgg"):
    """conv name -> index N of torchvision's ``features.N`` for the trunk."""
    if net == "alex":
        return {f"conv{i}": idx for i, idx in enumerate(_ALEX_FEAT_IDX)}
    out, idx = {}, 0
    for stage, (_, n_convs) in enumerate(_VGG_STAGES):
        for c in range(n_convs):
            out[f"conv{stage}_{c}"] = idx
            idx += 2      # conv + relu
        idx += 1          # max pool
    return out


class _Features(nn.Module):
    def __init__(self, net: str):
        super().__init__()
        self.net = net
        self._plan = conv_plan(net)
        for name, cin, cout, k, s, p, _ in self._plan:
            self.add_module(name, nn.Conv2d(cin, cout, k, stride=s, padding=p))

    def forward(self, x):
        feats = []
        for name, *_, tap in self._plan:
            x = F.relu(getattr(self, name)(x))
            if tap is None:
                continue
            feats.append(x)
            if self.net == "alex" and tap < 2:
                x = F.max_pool2d(x, 3, stride=2)
            elif self.net != "alex" and tap < len(_VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, stride=2)
        return feats


class LPIPS(nn.Module):
    """``forward(pred, target)`` on (B, H, W, 3) images in [0, 1]; returns
    the (B,) distances."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        if net not in ("vgg", "alex"):
            raise ValueError(f"net must be 'vgg' or 'alex', not {net!r}")
        self.net = net
        self.add_module(net, _Features(net))
        taps = [cout for _, _, cout, *_, tap in conv_plan(net) if tap is not None]
        for i, ch in enumerate(taps):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(ch)))
        self.register_buffer("_shift", torch.from_numpy(_SHIFT), persistent=False)
        self.register_buffer("_scale", torch.from_numpy(_SCALE), persistent=False)

    def _prep(self, img):
        img = (2.0 * img - 1.0 - self._shift) / self._scale
        return img.permute(0, 3, 1, 2)

    def forward(self, pred, target):
        trunk = getattr(self, self.net)
        total = 0.0
        for i, (fp, ft) in enumerate(zip(trunk(self._prep(pred)), trunk(self._prep(target)))):
            fp = fp / (torch.sqrt(torch.sum(fp ** 2, dim=1, keepdim=True)) + 1e-10)
            ft = ft / (torch.sqrt(torch.sum(ft ** 2, dim=1, keepdim=True)) + 1e-10)
            w = torch.abs(getattr(self, f"lin{i}"))[None, :, None, None]
            total = total + torch.mean(torch.sum(w * (fp - ft) ** 2, dim=1), dim=(-1, -2))
        return total


def random_params(seed: int = 0, net: str = "vgg") -> dict:
    """A seeded random ``state_dict`` (tests and plumbing only, not a
    perceptual metric): conv kernels from flax's default initializer (a
    normal truncated at 2 sigma, variance 1 / fan_in), zero biases, heads
    of ones.  Drawn on the host with numpy, so the same seed gives the
    same weights on every device."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, cin, cout, k, *_ in conv_plan(net):
        std = np.sqrt(1.0 / (cin * k * k)) / 0.87962566103423978
        z = rng.randn(cout, cin, k, k)
        while np.any(bad := np.abs(z) > 2.0):
            z[bad] = rng.randn(int(bad.sum()))
        sd[f"{net}.{name}.weight"] = torch.from_numpy((z * std).astype(np.float32))
        sd[f"{net}.{name}.bias"] = torch.zeros(cout)
    for i, (_, _, cout, *_, tap) in enumerate(p for p in conv_plan(net) if p[-1] is not None):
        sd[f"lin{i}"] = torch.ones(cout)
    return sd


def _flax_flat(state_dict) -> dict:
    """The port's ``state_dict`` as the JAX package's flat flax keys
    ('params/<net>/<conv>/kernel' HWIO, '.../bias', 'params/lin<i>')."""
    flat = {}
    for key, v in state_dict.items():
        v = v.detach().cpu().numpy()
        parts = key.split(".")
        if parts[-1] == "weight":
            flat["/".join(["params", *parts[:-1], "kernel"])] = np.transpose(v, (2, 3, 1, 0))
        else:
            flat["/".join(["params", *parts])] = v
    return flat


def save_params_npz(state_dict, path):
    """Write LPIPS weights as a flat .npz in the JAX package's fixture
    format (flax keys joined by '/')."""
    np.savez(path, **_flax_flat(state_dict))


def load_params_npz(path) -> dict:
    """The port's ``state_dict`` from a .npz fixture of either package."""
    from ..convert import lpips_state_dict

    tree = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return lpips_state_dict(tree)


def make_standin_weights(path, net: str = "vgg", seed: int = 0):
    """A deterministic stand-in weights file (seeded :func:`random_params`
    as .npz): exercises the whole fixture path, but is not a perceptual
    metric."""
    save_params_npz(random_params(seed, net), path)
    return path


def load_torch_lpips(path, net: str = "vgg") -> dict:
    """The port's ``state_dict`` from a torch LPIPS checkpoint: the
    ``lpips`` package's heads (``lin<i>.model.1.weight``) with the
    torchvision trunk (``features.N`` or ``net.features.N``), or one
    merged dict."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for name, idx in torchvision_feature_index(net).items():
        for prefix in ("", "net."):
            if f"{prefix}features.{idx}.weight" in sd:
                out[f"{net}.{name}.weight"] = sd[f"{prefix}features.{idx}.weight"].float()
                out[f"{net}.{name}.bias"] = sd[f"{prefix}features.{idx}.bias"].float()
                break
        else:
            raise KeyError(f"conv features.{idx} not found in checkpoint")
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                out[f"lin{i}"] = sd[key].float().reshape(-1)
    return out


def load_weights_file(path, net: str = "vgg") -> dict:
    """LPIPS weights from a file of either supported format."""
    if str(path).endswith(".npz"):
        return load_params_npz(path)
    return load_torch_lpips(path, net=net)


def model_from_state_dict(state_dict, net: str = "vgg", device=None) -> LPIPS:
    """An evaluation-only LPIPS on ``device`` (None: the CUDA card)."""
    model = LPIPS(net)
    model.load_state_dict(state_dict)
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def metric_from_weights(path, net: str = "vgg", device=None):
    """``(pred_4d, target_4d) -> per-image LPIPS``, the contract of
    ``benchmark(lpips_fn=...)``; a grayscale pair is repeated to 3
    channels."""
    model = model_from_state_dict(load_weights_file(path, net), net, device)
    dev = next(model.parameters()).device

    def fn(pred, target):
        pred = as_tensor(pred, device=dev)
        target = as_tensor(target, device=dev)
        if pred.shape[-1] == 1:
            pred = pred.repeat_interleave(3, dim=-1)
            target = target.repeat_interleave(3, dim=-1)
        return model(pred, target)

    return fn


def metrics_from_env(device=None):
    """``(lpips_vgg_fn, lpips_alex_fn)`` from the LPT_LPIPS_WEIGHTS and
    LPT_LPIPS_ALEX_WEIGHTS environment variables; None for each unset."""
    vgg_path = os.environ.get("LPT_LPIPS_WEIGHTS")
    alex_path = os.environ.get("LPT_LPIPS_ALEX_WEIGHTS")
    return (metric_from_weights(vgg_path, "vgg", device) if vgg_path else None,
            metric_from_weights(alex_path, "alex", device) if alex_path else None)
