"""Dataset-scale benchmark harness (port of
lenslesspicam_tpu/eval/benchmark.py).

``benchmark(reconstruct, batches, ...)`` evaluates a reconstruction
callable over (lensless, lensed) pairs with the reference's semantics:

* metrics MSE / PSNR / SSIM, LPIPS_Vgg and LPIPS_Alex when a metric
  callable is given (or named by the LPT_LPIPS_WEIGHTS /
  LPT_LPIPS_ALEX_WEIGHTS environment variables), ReconstructionError when
  ``model`` is given;
* optional shot noise on the measurement (``snr``, drawn from a
  ``torch.Generator``), ROI crop, per-image max-normalization;
* ``<name>_unrolled`` metrics and ``ReconstructionError_PreProc`` when the
  reconstructor returns its intermediates;
* Parameterize-and-Perturb adaptation per batch (``pnp``);
* the predictions of the samples numbered in ``save_idx`` (counted over
  all batches) written to ``save_dir/recon_<i>.png`` by
  ``data.io.save_image``;
* MSE and LPIPS averaged by batch sum over samples, the others by
  per-image mean.

The batches go to ``device`` (None: the CUDA card) and every metric is
computed there.

Mesh-sharded evaluation: with ``mesh`` (a ``DeviceMesh`` with a 'data'
dim, ``parallel.sharding.make_mesh``) each rank of the dim reconstructs
its block of every batch (the shot noise is drawn on the whole batch
first, so it is the noise of ``mesh=None``), the per-image metrics are
all-gathered over the dim, and every rank returns what ``mesh=None``
returns.  Every metric must then be per image (shape ``(batch,)``).
"""

from __future__ import annotations

import inspect
from typing import Callable, Iterable, Optional

import torch

from .._device import as_tensor, resolve_device
from ..ops.noise import add_shot_noise
from .metrics import _collapse_depth, max_normalize, psnr, ssim


def _batch_metrics(pred, lensed, normalize=True):
    pred, lensed = _collapse_depth(pred), _collapse_depth(lensed)
    if normalize:
        pred = max_normalize(pred)
        lensed = max_normalize(lensed)
    return {"MSE": torch.mean((pred - lensed) ** 2, dim=(-1, -2, -3)),
            "PSNR": psnr(pred, lensed),
            "SSIM": ssim(pred, lensed)}


def _apply_crop(arr, crop):
    v0, v1 = crop["vertical"]
    h0, h1 = crop["horizontal"]
    return arr[..., v0:v1, h0:h1, :]


def _lpips_pair(pred, target):
    p4 = max_normalize(pred.reshape(-1, *pred.shape[-3:]))
    t4 = max_normalize(target.reshape(-1, *target.shape[-3:]))
    if p4.shape[-1] == 1:     # LPIPS needs 3 channels
        p4, t4 = p4.repeat_interleave(3, dim=-1), t4.repeat_interleave(3, dim=-1)
    return p4, t4


class _Shard:
    """This rank's block of each batch along the mesh's 'data' dim, and
    the all-gather of its per-image metrics (no mesh: the whole batch)."""

    def __init__(self, mesh):
        self.group, self.n, self.k = None, 1, 0
        if mesh is not None:
            from ..parallel.distributed import axis_size

            if "data" not in (getattr(mesh, "mesh_dim_names", None) or ()):
                raise ValueError("mesh must be a DeviceMesh with a 'data' dim")
            self.group = mesh.get_group("data")
            self.n, self.k = axis_size(mesh, "data"), mesh.get_local_rank("data")

    def start(self, batch: int) -> int:
        return self.k * (batch // self.n)

    def block(self, x):
        if self.group is None or x is None:
            return x
        if x.shape[0] % self.n:
            raise ValueError(f"a batch of {x.shape[0]} does not divide over {self.n} ranks")
        b = x.shape[0] // self.n
        return x[self.k * b:(self.k + 1) * b]

    def gather(self, name, values):
        if self.group is None:
            return values
        from ..parallel.distributed import all_gather

        if values.dim() != 1:
            raise ValueError(f"metric {name}: a mesh needs per-image values, got shape "
                             f"{tuple(values.shape)}")
        return all_gather(values, 0, self.group)


def benchmark(reconstruct: Callable, batches: Iterable, snr: Optional[float] = None,
              crop: Optional[dict] = None, normalize: bool = True,
              generator: Optional[torch.Generator] = None,
              extra_metrics: Optional[dict] = None, save_idx=None,
              save_dir: Optional[str] = None, model=None,
              lpips_fn: Optional[Callable] = None, lpips_alex_fn: Optional[Callable] = None,
              unrolled_output_factor: bool = False, pre_process_aux: bool = False,
              pnp: Optional[dict] = None, mesh=None, device=None) -> dict:
    """Evaluate ``reconstruct(lensless, ...) -> prediction`` over batches;
    returns metric name -> average over all samples.

    batches: iterable of dicts with 'lensless' and 'lensed' (B, D, H, W, C)
    arrays or tensors; 'psfs' and 'background' entries are passed on to
    ``reconstruct`` when it takes them.
    generator: the ``torch.Generator`` (on ``device``) of the shot noise;
    None: one seeded with 0.
    model: an object with ``reconstruction_error(prediction, lensless)``
    (a ``ReconstructionAlgorithm``) for the ReconstructionError metric.
    lpips_fn / lpips_alex_fn: ``(pred_4d, target_4d) -> per-image LPIPS``
    (``eval.lpips.metric_from_weights``).
    unrolled_output_factor / pre_process_aux: ``reconstruct`` returns
    ``(prediction, unrolled, pre_processed, psfs_out)``.
    pnp: {'mu', 'lr', 'n_iter', 'apply_fn', 'params0', 'forward_conv'}:
    Parameterize-and-Perturb adaptation per batch, in place of
    ``reconstruct``.
    """
    device = resolve_device(device)
    shard = _Shard(mesh)
    if lpips_fn is None and lpips_alex_fn is None:
        from .lpips import metrics_from_env

        lpips_fn, lpips_alex_fn = metrics_from_env(device)
    if pnp is not None:
        missing = [k for k in ("mu", "lr", "n_iter", "apply_fn", "params0", "forward_conv")
                   if k not in pnp]
        if missing:
            raise ValueError(f"pnp requires {missing}")
    if snr is not None and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    try:
        accepted = set(inspect.signature(reconstruct).parameters)
    except (TypeError, ValueError):
        accepted = set()

    sums: dict = {}
    counts: dict = {}
    total = 0

    def add(name, values, n):
        values = shard.gather(name, as_tensor(values, None, device))
        sums[name] = sums.get(name, 0.0) + float(torch.sum(values))
        counts[name] = counts.get(name, 0) + n

    def add_metrics(pred, target, n, suffix=""):
        vals = _batch_metrics(pred, target, normalize)
        for name in ("MSE", "PSNR", "SSIM"):
            add(name + suffix, vals[name], n)
        if lpips_fn is not None or lpips_alex_fn is not None:
            p4, t4 = _lpips_pair(pred, target)
            if lpips_fn is not None:
                add("LPIPS_Vgg" + suffix, lpips_fn(p4, t4), n)
            if lpips_alex_fn is not None:
                add("LPIPS_Alex" + suffix, lpips_alex_fn(p4, t4), n)

    for batch in batches:
        lensless = as_tensor(batch["lensless"], device=device)
        lensed = as_tensor(batch["lensed"], device=device)
        psfs, background = batch.get("psfs"), batch.get("background")
        if snr is not None:
            lensless = add_shot_noise(lensless, snr, generator)
        n = int(lensless.shape[0])
        lensless, lensed, psfs, background = (shard.block(a) for a in
                                              (lensless, lensed, psfs, background))

        if pnp is not None:
            from .pnp import parameterize_perturb

            pred, _ = parameterize_perturb(pnp["apply_fn"], pnp["params0"],
                                           pnp["forward_conv"], lensless, mu=pnp["mu"],
                                           lr=pnp["lr"], n_iter=pnp["n_iter"])
        else:
            kwargs = {}
            if psfs is not None and "psfs" in accepted:
                kwargs["psfs"] = as_tensor(psfs, device=device)
            if background is not None and "background" in accepted:
                kwargs["background"] = as_tensor(background, device=device)
            pred = reconstruct(lensless, **kwargs)

        unrolled_out = pre_process_out = None
        if isinstance(pred, (tuple, list)):
            # the reference's output_intermediate order
            if len(pred) > 1:
                unrolled_out = pred[1]
            if len(pred) > 2:
                pre_process_out = pred[2]
            pred = pred[0]
        pred_original = pred
        if save_idx is not None and save_dir is not None:
            from ..data.io import save_image

            for local_i in range(pred.shape[0]):
                i = total + shard.start(n) + local_i
                if i in save_idx:
                    save_image(pred[local_i], f"{save_dir}/recon_{i}.png")
        if crop is not None:
            pred = _apply_crop(pred, crop)
            lensed = _apply_crop(lensed, crop)

        add_metrics(pred, lensed, n)
        if model is not None and hasattr(model, "reconstruction_error"):
            add("ReconstructionError",
                model.reconstruction_error(prediction=pred_original, lensless=lensless), n)
        if unrolled_output_factor and unrolled_out is not None:
            u = _apply_crop(unrolled_out, crop) if crop is not None else unrolled_out
            add_metrics(u, lensed, n, "_unrolled")
        if pre_process_aux and pre_process_out is not None and model is not None:
            add("ReconstructionError_PreProc",
                model.reconstruction_error(prediction=pred_original,
                                           lensless=pre_process_out), n)
        if extra_metrics:
            for name, fn in extra_metrics.items():
                add(name, fn(pred, lensless, lensed), n)
        total += n

    return {name: s / counts[name] for name, s in sums.items()}
