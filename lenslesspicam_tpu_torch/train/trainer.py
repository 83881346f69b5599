"""Training engine for learned reconstruction (port of
lenslesspicam_tpu/train/trainer.py; reference: Trainer,
lensless/recon/utils.py:531-1496).

One step is forward, loss, ``torch.autograd.grad`` and the update, on a
model that lies on one device (None: the CUDA card).  Feature parity with
the JAX package:

* losses: L1/L2 on max-normalized, ROI-cropped outputs, an optional LPIPS
  term, an optional L1 penalty on the trainable mask's parameters;
* auxiliary losses: the unrolled-output factor and the pre-processor's
  measurement consistency ``||H x_caminv - pre(y)||``;
* optimizers: Adam, or AdamW with weight decay on the parameters of more
  than one dimension; the LR schedules (slow_start, final_lr, exp_decay,
  cosine with 5 % warm-up, step) through ``LambdaLR``; global-norm
  clipping and the skip of non-finite updates, both as optax computes them
  (:class:`TrainOptimizer`);
* the processor schedule: a delayed processor is left out of the forward
  and gets zero gradients, a frozen block's parameters stay where they are
  while its Adam moments advance;
* trainable-mask co-optimization with the mask's own optimizer and its
  projection after each step (hardware/trainable_mask.py's protocol);
* per-epoch evaluation through ``eval.benchmark``, best-model tracking by
  a configurable metric, ``torch.save`` checkpoints of the model's state
  dict with a config snapshot and metrics.json.

Blocks are named as in the JAX package's parameter tree (``pre_block``,
``post_block``, ``pre_process``, ``camera_inversion``, ...), through the
flax paths of ``convert``; the JAX package's freeze acts on those names.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from .._device import as_device, as_host, resolve_device

# optax.apply_if_finite's max_consecutive_errors
MAX_CONSECUTIVE_ERRORS = 100


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 10
    # optimizer (utils.py:841-861)
    optimizer: str = "Adam"
    lr: float = 1e-4
    weight_decay: float = 0.01
    # schedules (utils.py:863-945); at most one active
    slow_start: Optional[float] = None
    final_lr: Optional[float] = None
    exp_decay: Optional[float] = None
    cosine_decay_warmup: bool = False
    step: Optional[int] = None
    gamma: float = 0.1
    lr_step_epoch: bool = True  # epoch-level vs step-level schedules
    # losses
    loss: str = "l2"
    lpips_weight: Optional[float] = None
    l1_mask: Optional[float] = None
    unrolled_output_factor: Optional[float] = None
    pre_proc_aux: Optional[float] = None
    # stability
    clip_grad: Optional[float] = 1.0
    skip_nan: bool = False
    # ROI crop before loss {'vertical': (v0,v1), 'horizontal': (h0,h1)}
    crop: Optional[dict] = None
    # augmentation: rotate data+lensed+PSF by uniform(-deg, +deg) per
    # batch (utils.py:983-993)
    random_rotate: Optional[float] = None
    # per-epoch processor schedule (utils.py:1375-1400): epoch at which
    # the pre/post processor starts being applied / stops / resumes
    # receiving gradient updates.  None = from the start / never.
    pre_process_delay: Optional[int] = None
    post_process_delay: Optional[int] = None
    pre_process_freeze: Optional[int] = None
    post_process_freeze: Optional[int] = None
    pre_process_unfreeze: Optional[int] = None
    post_process_unfreeze: Optional[int] = None
    # eval / checkpoints
    # metric_for_best=None replicates the reference composite eval loss
    # (utils.py:1235-1253): MSE + lpips*LPIPS + aux terms, lower-better.
    metric_for_best: Optional[str] = "PSNR"
    save_dir: Optional[str] = None
    save_examples: bool = False  # per-epoch example reconstruction PNGs
    eval_batch_size: int = 4
    # known number of train batches per epoch (avoids materializing the
    # loader to count it; falls back to len(train_loader()) if sized)
    steps_per_epoch: Optional[int] = None


_HIGHER_BETTER = {"PSNR", "SSIM"}


def make_lr_schedule(config: TrainerConfig, steps_per_epoch: int) -> Callable:
    """step -> learning rate (utils.py:863-945), the JAX package's optax
    schedule: evaluated at the number of updates made before the one it
    scales."""
    spe = max(steps_per_epoch, 1)

    def epoch_of(step):
        return step // spe if config.lr_step_epoch else step

    total = config.epochs * (1 if config.lr_step_epoch else spe)

    if config.slow_start:
        def sched(step):
            e = epoch_of(step)
            return config.lr * (config.slow_start if e == 0 else
                                math.sqrt(config.slow_start) if e == 1 else 1.0)
    elif config.final_lr:
        final_decay = (config.final_lr / config.lr) ** (1.0 / max(config.epochs - 1, 1))

        def sched(step):
            return config.lr * final_decay ** epoch_of(step)
    elif config.exp_decay:
        def sched(step):
            return config.lr * config.exp_decay ** epoch_of(step)
    elif config.cosine_decay_warmup:
        warmup = int(0.05 * total)

        def sched(step):
            s = epoch_of(step)
            if s < warmup:
                return config.lr * s / max(warmup, 1)
            progress = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
            return config.lr * 0.5 * (1 + math.cos(math.pi * progress))
    elif config.step:
        def sched(step):
            return config.lr * config.gamma ** (epoch_of(step) // config.step)
    else:
        def sched(step):
            return config.lr
    return sched


class TrainOptimizer:
    """The JAX package's optax chain (``make_optimizer``) on ``torch.optim``.

    * Adam, or AdamW in two parameter groups, weight decay on the
      parameters of more than one dimension (optax's mask) and none on the
      rest; the learning rate 1.0 times the schedule through ``LambdaLR``,
      advanced once per applied update as optax's count.
    * ``clip``: optax's ``clip_by_global_norm``, ``g / norm * clip`` when
      the global norm is not below ``clip`` (``clip_grad_norm_`` divides by
      ``norm + 1e-6`` and is not used).
    * ``skip_nan``: optax's ``apply_if_finite``: an update with a non-finite
      gradient is dropped whole (no moment, count or schedule advances),
      but for the one after MAX_CONSECUTIVE_ERRORS in a row.
    * ``step(grads, frozen)`` leaves the tensors of ``frozen`` where they
      were, their moments advancing: the JAX package zeroes their updates.
    """

    def __init__(self, config: TrainerConfig, steps_per_epoch: int, params):
        self.params = list(params)
        if config.optimizer == "AdamW":
            groups = [{"params": [p for p in self.params if p.ndim > 1],
                       "weight_decay": config.weight_decay},
                      {"params": [p for p in self.params if p.ndim <= 1],
                       "weight_decay": 0.0}]
            self.optimizer = torch.optim.AdamW(groups, lr=1.0)
        else:     # a group, which may be empty (a model without parameters)
            self.optimizer = torch.optim.Adam([{"params": self.params}], lr=1.0)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, make_lr_schedule(config, steps_per_epoch))
        self.clip = config.clip_grad
        self.skip_nan = config.skip_nan
        self.notfinite_count = 0

    def step(self, grads, frozen=()) -> bool:
        """One update from ``grads`` (a tensor for each of ``params``, in
        order); returns whether it was applied."""
        if self.skip_nan:
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return False
        if self.clip and grads:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            grads = [torch.where(norm < self.clip, g, g / norm * self.clip) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        kept = [(p, p.detach().clone()) for p in frozen]
        self.optimizer.step()
        with torch.no_grad():
            for p, value in kept:
                p.copy_(value)
        self.scheduler.step()
        return True


def make_optimizer(config: TrainerConfig, steps_per_epoch: int,
                   module: torch.nn.Module) -> TrainOptimizer:
    """The optimizer of ``module``'s parameters that require grad."""
    return TrainOptimizer(config, steps_per_epoch,
                          [p for p in module.parameters() if p.requires_grad])


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [leaf for t in tree for leaf in _leaves(t)]


def measure_gradient(grads) -> float:
    """Global L2 norm of a tensor, or of the tensors of a (nested) dict,
    list or tuple (reference recon/utils.py:397-418 measure_gradient)."""
    return float(torch.sqrt(sum(torch.sum(torch.square(g)) for g in _leaves(grads))))


def gradient_norms(grads) -> dict:
    """Per-top-level-key L2 gradient norms of a dict — the per-component
    view the reference prints when diagnosing training (utils.py:397-418
    applied per submodule); :meth:`Trainer.grads_by_block` keys a model's
    gradients by block."""
    out = {}
    for key, sub in (grads.items() if isinstance(grads, dict) else []):
        out[key] = measure_gradient(sub)
    return out


def _norm_crop(img, crop, eps=1e-12):
    """Max-normalize per sample then ROI-crop (utils.py:1006-1051)."""
    m = torch.amax(img, dim=(-1, -2, -3), keepdim=True) + eps
    img = img / m
    if crop is not None:
        img = img[..., crop["vertical"][0]:crop["vertical"][1],
                  crop["horizontal"][0]:crop["horizontal"][1], :]
    return img


def _blocks(model) -> dict:
    """Parameter name -> the top-level key of its flax path in the JAX
    package's parameter tree (``convert``'s tables); a model ``convert``
    has no table for keys its parameters by their first attribute."""
    from ..convert import _entries

    table = {key: path[0] for coll, path, key, _ in _entries(model) if coll == "params"}
    return {name: table.get(name, name.split(".")[0]) for name, _ in model.named_parameters()}


class Trainer:
    """Trains a ``TrainableRecon``-style ``nn.Module``.

    Parameters
    ----------
    model : module with ``forward(data, psf, background=None)``; moved to
        ``device`` (None: the CUDA card)
    psf : (D, H, W, C) array or tensor (ignored per-batch if batches carry
        'psfs')
    train_loader : callable -> iterable of dict batches with keys
        'lensless', 'lensed' and optional 'psfs', 'background' (arrays or
        tensors)
    test_batches : list of the same dict format (held-out eval)
    lpips_apply : optional ``(pred_nhwc, target_nhwc) -> (B,)`` callable
    mask : optional trainable-mask protocol object (see
        hardware/trainable_mask.py): ``params``, ``get_psf(params)``,
        ``project(params)``, ``make_optimizer(params)``; its tensors lie on
        ``device``
    """

    def __init__(self, model, psf, train_loader, test_batches,
                 config: TrainerConfig = TrainerConfig(),
                 lpips_apply=None, mask=None, seed=0,
                 extra_eval_sets: Optional[dict] = None,
                 loggers: Optional[list] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        # inputs take the model's dtype: float32 unless it was converted
        self.dtype = next((p.dtype for p in self.model.parameters() if p.is_floating_point()),
                          torch.float32)
        self.psf = as_device(psf, self.dtype, self.device)
        self.train_loader = train_loader
        self.test_batches = test_batches
        self.config = config
        self.lpips_apply = lpips_apply
        self.mask = mask
        # extra held-out sets (utils.py:1259-1301): name -> dict with
        # 'batches' and optional 'psf' (used when the set is not
        # multimask, i.e. its batches don't carry per-sample 'psfs')
        self.extra_eval_sets = extra_eval_sets or {}
        # observability sinks: callables (data_dict, step) -> None with
        # the wandb.log signature (see train/loggers.py; reference
        # utils.py:729-733, 1228-1307).  Per-step loss/lr and per-epoch
        # train loss + eval metrics flow through every logger.
        self.loggers: list = list(loggers or [])
        self.metrics_log: dict = {}
        # per-step scalar log (local wandb equivalent): appended as JSON
        # lines to <save_dir>/train_log.jsonl by train() each epoch
        self._step_log: list = []
        self._global_step = 0
        self.best_metric = None
        self.best_params = None
        self._np_rng = np.random.RandomState(seed)
        # processor schedule state; delays mean "skip until that epoch"
        self._skip_pre = config.pre_process_delay is not None
        self._skip_post = config.post_process_delay is not None
        self._frozen: frozenset = frozenset()
        self._model_skips = (getattr(model, "skip_pre", False), getattr(model, "skip_post", False))

        if config.steps_per_epoch is not None:
            steps_per_epoch = config.steps_per_epoch
        else:
            # only use len() when the loader's iterable is sized — never
            # materialize it (an HITL loader may block per item)
            try:
                steps_per_epoch = len(train_loader())
            except TypeError:
                steps_per_epoch = max(len(test_batches), 1)
        # make_optimizer's parameters, in its order
        self.named_params = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.block_of = _blocks(self.model)
        self.tx = make_optimizer(config, steps_per_epoch, self.model)
        if self.mask is not None:
            self.mask_tx = self.mask.make_optimizer(self.mask.params)

    # ------------------------------------------------------------------

    def _input(self, x):
        return None if x is None else as_device(x, self.dtype, self.device)

    def _batch_psf(self, batch):
        if batch.get("psfs") is not None:
            return self._input(batch["psfs"])
        if self.mask is not None:
            return self.mask.get_psf(self.mask.params)
        return self.psf

    def _set_skips(self, skip_pre, skip_post):
        """The schedule's skip flags on the model (the JAX package's
        ``model.clone(skip_pre=..., skip_post=...)``): a skipped block is
        left out of the forward, so its parameters get zero gradients."""
        if hasattr(self.model, "skip_pre"):
            self.model.skip_pre = skip_pre or self._model_skips[0]
            self.model.skip_post = skip_post or self._model_skips[1]

    def grads_by_block(self, grads) -> dict:
        """``grads`` (one tensor per trainable parameter, in
        ``named_params`` order) as block -> {parameter name -> gradient}."""
        out: dict = {}
        for (name, _), g in zip(self.named_params, grads):
            out.setdefault(self.block_of[name], {})[name] = g
        return out

    def _loss(self, out, lensed, psf, mask_params):
        cfg = self.config
        base_loss = (lambda a, b: torch.mean(torch.abs(a - b))) if cfg.loss == "l1" \
            else (lambda a, b: torch.mean((a - b) ** 2))
        if cfg.unrolled_output_factor or cfg.pre_proc_aux:
            y_pred, cam_inv, pre_out = out[0], out[1], out[2]
        else:
            y_pred = out if not isinstance(out, tuple) else out[0]
            cam_inv = pre_out = None

        yp = _norm_crop(y_pred, cfg.crop)
        yt = _norm_crop(lensed, cfg.crop)
        loss = base_loss(yp, yt)

        def lpips(a, b):
            return torch.mean(self.lpips_apply(a.reshape((-1,) + a.shape[-3:]),
                                               b.reshape((-1,) + b.shape[-3:])))

        if cfg.lpips_weight and self.lpips_apply is not None:
            loss = loss + cfg.lpips_weight * lpips(yp, yt)

        if cfg.l1_mask and mask_params is not None:
            for p in _leaves(mask_params):
                loss = loss + cfg.l1_mask * torch.mean(torch.abs(p))

        if cfg.unrolled_output_factor:
            ci = _norm_crop(cam_inv, cfg.crop)
            aux = base_loss(ci, yt)
            if cfg.lpips_weight and self.lpips_apply is not None:
                aux = aux + cfg.lpips_weight * lpips(ci, yt)
            loss = loss + cfg.unrolled_output_factor * aux

        if cfg.pre_proc_aux:
            from ..ops.fft_conv import FFTConvolver

            conv = FFTConvolver.from_psf(psf, pad=True, norm="ortho", dtype=psf.dtype,
                                         device=psf.device)
            eps = 1e-12
            ci_norm = cam_inv / (torch.amax(cam_inv, dim=(-1, -2, -3), keepdim=True) + eps)
            Hx = conv.convolve(ci_norm)
            Hx = Hx - torch.amin(Hx, dim=(-1, -2, -3), keepdim=True)
            Hx = Hx / torch.clamp(torch.amax(Hx, dim=(-1, -2, -3), keepdim=True), min=eps)
            err = torch.sum((Hx - pre_out) ** 2, dim=(-1, -2, -3, -4)) / math.prod(psf.shape)
            loss = loss + cfg.pre_proc_aux * torch.mean(err)
        return loss

    def loss_and_grads(self, batch):
        """The loss of ``batch`` in ``train()`` mode under the current
        schedule and its gradients: (loss, one gradient per trainable
        parameter in ``named_params`` order, {mask parameter name ->
        gradient} or None).  Every gradient is a tensor, zeros where the
        loss does not reach the parameter."""
        data = self._input(batch["lensless"])
        lensed = self._input(batch["lensed"])
        background = self._input(batch.get("background"))
        psf = self._batch_psf(batch)
        if self.config.random_rotate:
            # random-rotate augmentation of data + truth + PSF
            # (utils.py:983-993), on the host as the data layer's other
            # geometry ops
            from ..data.image import rotate_HWC

            angle = self._np_rng.uniform(-self.config.random_rotate,
                                         self.config.random_rotate)
            data, lensed, psf = (self._input(rotate_HWC(as_host(t), angle))
                                 for t in (data, lensed, psf))
        mask_params = self.mask.params if self.mask is not None else None
        if mask_params is not None:
            psf = self.mask.get_psf(mask_params)

        self.model.train()
        self._set_skips(self._skip_pre, self._skip_post)
        out = self.model(data, psf, background=background)
        loss = self._loss(out, lensed, psf, mask_params)

        leaves = [p for _, p in self.named_params]
        names = sorted(mask_params) if mask_params is not None else []
        leaves += [mask_params[k] for k in names]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        n = len(self.named_params)
        mask_grads = dict(zip(names, grads[n:])) if mask_params is not None else None
        return loss.detach(), grads[:n], mask_grads

    def apply_grads(self, grads, mask_grads=None):
        """One update of the model (frozen blocks held) and, with a mask,
        of its parameters followed by its projection."""
        frozen = [p for name, p in self.named_params if self.block_of[name] in self._frozen]
        self.tx.step(grads, frozen)
        if self.mask is not None:
            for k, g in mask_grads.items():
                self.mask.params[k].grad = g
            self.mask_tx.step()
            with torch.no_grad():
                projected = self.mask.project(self.mask.params)
                for k, v in projected.items():
                    self.mask.params[k].copy_(v)

    def train_step(self, batch) -> torch.Tensor:
        """One optimization step on ``batch``; returns its loss (a 0-d
        tensor on the device, before the update)."""
        loss, grads, mask_grads = self.loss_and_grads(batch)
        self.apply_grads(grads, mask_grads)
        return loss

    # ------------------------------------------------------------------

    def train_epoch(self) -> float:
        losses = []
        for batch in self.train_loader():
            loss = float(self.train_step(batch))
            losses.append(loss)
            self._global_step += 1
            self._step_log.append({"step": self._global_step, "loss": loss})
            self._log({"train/loss_step": loss}, self._global_step)
        return float(np.mean(losses)) if losses else float("nan")

    def _log(self, data: dict, step: int):
        """Fan a scalar dict out to every registered logger; a failing
        sink must never take training down (observability is additive)."""
        for logger in self.loggers:
            try:
                logger(data, step)
            except Exception as e:  # pragma: no cover - defensive
                import warnings

                warnings.warn(f"logger {logger!r} failed: {e}")

    def _flush_step_log(self, epoch: int):
        """Append this epoch's per-step scalars to train_log.jsonl —
        the local equivalent of the reference's wandb.log stream
        (utils.py:1348-1354)."""
        if not self.config.save_dir or not self._step_log:
            self._step_log = []
            return
        os.makedirs(self.config.save_dir, exist_ok=True)
        path = os.path.join(self.config.save_dir, "train_log.jsonl")
        with open(path, "a") as f:
            for rec in self._step_log:
                f.write(json.dumps(dict(rec, epoch=epoch)) + "\n")
        self._step_log = []

    def _forward_eval(self, data, psf, background=None):
        """The model in ``eval()`` mode under the current schedule, without
        gradients; the first output where it returns its intermediates."""
        self.model.eval()
        self._set_skips(self._skip_pre, self._skip_post)
        kwargs = {} if background is None else {"background": background}
        with torch.no_grad():
            out = self.model(data, psf, **kwargs)
        return out[0] if isinstance(out, tuple) else out

    def save_examples(self, epoch: int, n_examples: int = 4):
        """Save example (lensless, reconstruction, truth) PNG triplets
        from the first eval batch — the reference logs these images to
        wandb each epoch (utils.py:1248-1258)."""
        if not self.config.save_dir:
            return
        from ..data.io import save_image

        batch = next(iter(self.test_batches())) if callable(self.test_batches) \
            else self.test_batches[0]
        data = self._input(batch["lensless"])[:n_examples]
        with torch.no_grad():
            psf = self._batch_psf(batch)
        if psf.ndim > 4 and psf.shape[0] == batch["lensless"].shape[0]:
            psf = psf[:n_examples]
        background = batch.get("background")
        if background is not None:
            background = self._input(background)[:n_examples]
        recon = as_host(self._forward_eval(data, psf, background))
        out_dir = os.path.join(self.config.save_dir, f"epoch{epoch}")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(min(n_examples, recon.shape[0])):
            img = np.squeeze(recon[i])
            save_image(img / max(img.max(), 1e-12),
                       os.path.join(out_dir, f"recon_{i}.png"))
            truth = np.squeeze(as_host(batch["lensed"][i]))
            save_image(truth / max(truth.max(), 1e-12),
                       os.path.join(out_dir, f"lensed_{i}.png"))
        return out_dir

    def _eval_batches(self, batches, psf_default) -> dict:
        """benchmark() over one eval set with per-batch PSFs and
        backgrounds forwarded (multimask / background-subtraction models
        are evaluated with the same inputs they train on)."""
        from ..eval.benchmark import benchmark

        def reconstruct(lensless, psfs=None, background=None):
            return self._forward_eval(lensless, psfs if psfs is not None else psf_default,
                                      background)

        return benchmark(reconstruct, batches, crop=self.config.crop,
                         lpips_fn=self.lpips_apply, device=self.device)

    def evaluate(self) -> dict:
        """Held-out metrics + extra eval sets (utils.py:1186-1309).
        Extra-set metrics are namespaced ``<set>_<metric>``; sets whose
        batches carry per-sample 'psfs' (multimask) use those, otherwise
        the set's own 'psf' (or the training PSF)."""
        with torch.no_grad():
            psf = self._batch_psf({})
        metrics = self._eval_batches(self.test_batches, psf)
        for name, spec in self.extra_eval_sets.items():
            set_psf = spec.get("psf")
            set_psf = psf if set_psf is None else self._input(set_psf)
            extra = self._eval_batches(spec["batches"], set_psf)
            for k, v in extra.items():
                metrics[f"{name}_{k}"] = v
        return metrics

    def _schedule_epoch(self, e) -> bool:
        """Apply the processor schedule's changes at 0-based epoch ``e``;
        returns whether anything changed."""
        cfg = self.config
        changed = False
        if cfg.pre_process_delay is not None and e == cfg.pre_process_delay:
            self._skip_pre, changed = False, True
        if cfg.post_process_delay is not None and e == cfg.post_process_delay:
            self._skip_post, changed = False, True
        frozen = set(self._frozen)
        for name, fz, uf in (("pre_block", cfg.pre_process_freeze, cfg.pre_process_unfreeze),
                             ("post_block", cfg.post_process_freeze,
                              cfg.post_process_unfreeze)):
            if fz is not None and e == fz:
                frozen.add(name)
                changed = True
            if uf is not None and e == uf:
                frozen.discard(name)
                changed = True
        self._frozen = frozenset(frozen)
        return changed

    def train(self, verbose: bool = True, start_epoch: int = 0) -> dict:
        """Full loop: eval at epoch 0, then train/eval per epoch with the
        processor add/freeze/unfreeze schedule and best-model tracking
        (utils.py:1356-1419).  ``start_epoch`` (e.g. from :meth:`resume`)
        skips completed epochs AND replays the processor schedule up to
        that point so delayed/frozen processors resume in the right
        state."""
        if start_epoch == 0:
            metrics0 = self.evaluate()
            self.metrics_log[0] = {"eval": metrics0}
            self._maybe_update_best(metrics0)
            self._log(dict({"epoch": 0},
                           **{f"eval/{k}": v for k, v in metrics0.items()}), 0)
        for e in range(start_epoch):
            self._schedule_epoch(e)
        for epoch in range(start_epoch + 1, self.config.epochs + 1):
            # schedule epochs are 0-based like the reference's loop index
            if self._schedule_epoch(epoch - 1) and verbose:
                print(f"epoch {epoch}: schedule change — "
                      f"skip_pre={self._skip_pre} skip_post={self._skip_post} "
                      f"frozen={sorted(self._frozen)}")

            train_loss = self.train_epoch()
            eval_metrics = self.evaluate()
            self.metrics_log[epoch] = {"loss": train_loss, "eval": eval_metrics}
            self._maybe_update_best(eval_metrics)
            self._flush_step_log(epoch)
            self._log(dict({"epoch": epoch, "train/loss": train_loss},
                           **{f"eval/{k}": v for k, v in eval_metrics.items()}),
                      self._global_step)
            if verbose:
                print(f"epoch {epoch}: loss={train_loss:.6f} {eval_metrics}")
            if self.config.save_dir:
                self.save(epoch)
                if self.config.save_examples:
                    ex_dir = self.save_examples(epoch)
                    if ex_dir:
                        self._log({"examples_dir": ex_dir}, self._global_step)
        return self.metrics_log

    def _eval_loss(self, metrics: dict) -> float:
        """Reference composite eval loss when no best-metric is named
        (utils.py:1235-1253): MSE + lpips*LPIPS + l1*|mask| (+ aux
        terms); lower is better."""
        cfg = self.config
        loss = metrics.get("MSE", 0.0)
        if cfg.lpips_weight and "LPIPS_Vgg" in metrics:
            loss += cfg.lpips_weight * metrics["LPIPS_Vgg"]
        if cfg.l1_mask and self.mask is not None:
            for p in _leaves(self.mask.params):
                loss += cfg.l1_mask * float(torch.mean(torch.abs(p.detach())))
        if cfg.unrolled_output_factor and "MSE_unrolled" in metrics:
            aux = metrics["MSE_unrolled"]
            if cfg.lpips_weight and "LPIPS_Vgg_unrolled" in metrics:
                aux += cfg.lpips_weight * metrics["LPIPS_Vgg_unrolled"]
            loss += cfg.unrolled_output_factor * aux
        if cfg.pre_proc_aux and "ReconstructionError_PreProc" in metrics:
            loss += cfg.pre_proc_aux * metrics["ReconstructionError_PreProc"]
        return float(loss)

    def _maybe_update_best(self, metrics: dict):
        key = self.config.metric_for_best
        if key is None:
            val, higher = self._eval_loss(metrics), False
        elif key in metrics:
            val, higher = metrics[key], key in _HIGHER_BETTER
        else:
            return
        better = (self.best_metric is None
                  or (val > self.best_metric if higher else val < self.best_metric))
        if better:
            self.best_metric = val
            self.best_params = {k: v.detach().clone()
                                for k, v in self.model.state_dict().items()}

    def save(self, epoch, best: bool = True):
        """Checkpoint the model's state dict (+ best) with config + metrics
        snapshot (utils.py:1421-1496 analog): ``recon_epoch{epoch}`` and
        ``recon_epochBEST`` by ``torch.save``."""
        path = os.path.abspath(self.config.save_dir)
        os.makedirs(path, exist_ok=True)
        torch.save(self.model.state_dict(), os.path.join(path, f"recon_epoch{epoch}"))
        if best and self.best_params is not None:
            torch.save(self.best_params, os.path.join(path, "recon_epochBEST"))
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump(self.metrics_log, f, indent=2, default=float)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self.config), f, indent=2, default=str)
        if self.mask is not None:
            np.save(os.path.join(path, "mask_params.npy"),
                    as_host(_leaves(self.mask.params)[0]))
            # learned PSF alongside the raw mask params (utils.py:1421-1496
            # saves psf.npy / psf.png per checkpoint)
            with torch.no_grad():
                np.save(os.path.join(path, "psf.npy"),
                        as_host(self.mask.get_psf(self.mask.params)))

    def restore(self, ckpt_dir: Optional[str] = None, epoch="BEST"):
        """Load the model's state dict from a checkpoint written by
        ``save`` — the resume path the reference lacks (its Trainer can
        only load final weights through model_dict).  ``epoch`` is an int
        or 'BEST'.  Returns the loaded state dict."""
        path = os.path.abspath(ckpt_dir or self.config.save_dir)
        sd = torch.load(os.path.join(path, f"recon_epoch{epoch}"), map_location=self.device,
                        weights_only=True)
        self.model.load_state_dict(sd)
        metrics_path = os.path.join(path, "metrics.json")
        if os.path.exists(metrics_path):
            with open(metrics_path) as f:
                self.metrics_log = {int(k): v for k, v in json.load(f).items()}
        return sd

    def resume(self, ckpt_dir: Optional[str] = None) -> int:
        """Restore the latest epoch checkpoint + metrics log and return
        the epoch to continue from."""
        path = os.path.abspath(ckpt_dir or self.config.save_dir)
        epochs = sorted(int(d.rsplit("epoch", 1)[1])
                        for d in os.listdir(path)
                        if d.startswith("recon_epoch")
                        and d.rsplit("epoch", 1)[1].isdigit())
        if not epochs:
            return 0
        self.restore(path, epochs[-1])
        return epochs[-1]
