"""Learned-reconstruction training app (the port of
``scripts/recon/train_learning_based.py``).

Builds the modular model (pre-processor -> camera inversion ->
post-processor, with the optional PSF network, background subtraction and
compensation branch) from the config, gives it to the port's ``Trainer``
with its features (auxiliary losses, rotations, the processors' delay /
freeze schedule, checkpoints and resume, per-step logs) and trains.

    python -m lenslesspicam_tpu_torch.scripts.recon.train_learning_based \
        reconstruction.method=unrolled_admm \
        reconstruction.post_process.network=UnetRes training.epoch=5

Reads ``configs/train.yaml``.  The torch layers take their input widths
where flax infers them: a UNetRes processor reads the image and the
processor's noise-level channel (4), as ``zoo.load_model`` builds it, and
``multi_wiener``'s PSF layers the PSF's channels: flax infers those and
keeps one gain ``w`` for all of them, the port one gain a channel.
Returns the trainer's metrics log.
"""

import os

import numpy as np

from .._common import app, config_path

_CONFIG = config_path("train.yaml")


def _processor(sub, device):
    """Config -> processor module (the reference's create_process_network,
    recon/utils.py:419-528)."""
    from ...models.restormer import Restormer
    from ...models.unet import UNetRes

    net = sub.get("network")
    if net in ("UnetRes", "DruNet"):
        return UNetRes(in_nc=4, out_nc=3, nc=tuple(sub["nc"]), nb=sub.get("depth", 4),
                       device=device)
    if net == "Restormer":
        return Restormer(out_channels=3, device=device)
    return None


def _build_model(config, device, psf_channels: int = 3):
    from ...models.compensation import CompensationBranch
    from ...models.inversion import SVDeconvNet, TrainableInversion
    from ...models.multi_wiener import MultiWiener
    from ...models.trainable_recon import TrainableRecon
    from ...models.unet import UNetRes
    from ...models.unrolled import UnrolledADMM, UnrolledFISTA

    rc = config.reconstruction
    method = rc.method

    if method == "multi_wiener":
        return MultiWiener(in_channels=3, out_channels=3, psf_channels=psf_channels,
                           device=device)

    inversion = {
        "unrolled_admm": lambda: UnrolledADMM(
            n_iter=rc.unrolled_admm.n_iter,
            mu1=float(rc.unrolled_admm.mu1), mu2=float(rc.unrolled_admm.mu2),
            mu3=float(rc.unrolled_admm.mu3), tau=float(rc.unrolled_admm.tau),
            remat=True, device=device,
        ),
        "unrolled_fista": lambda: UnrolledFISTA(n_iter=rc.unrolled_admm.n_iter,
                                                device=device),
        "trainable_inversion": lambda: TrainableInversion(),
        "sv_deconvnet": lambda: SVDeconvNet(device=device),
    }[method]()

    background_network = None
    if rc.get("learned_background_subtraction") or \
            rc.get("integrated_background_subtraction"):
        background_network = UNetRes(in_nc=4, out_nc=3, nc=(8, 16, 32, 64), nb=2,
                                     device=device)

    compensation = None
    if rc.get("compensation"):
        compensation = CompensationBranch(
            nc=tuple(int(c) for c in rc.compensation), device=device)

    return TrainableRecon(
        camera_inversion=inversion,
        pre_process=_processor(rc.pre_process, device),
        post_process=_processor(rc.post_process, device),
        psf_network=(UNetRes(in_nc=4, out_nc=3, nc=(4, 8, 16, 32), nb=2, device=device)
                     if rc.psf_network else None),
        psf_residual=bool(rc.get("psf_network_residual", True)),
        background_network=background_network,
        compensation_branch=compensation,
        direct_background_subtraction=bool(
            rc.get("direct_background_subtraction", False)),
        integrated_background_subtraction=bool(
            rc.get("integrated_background_subtraction", False)),
        skip_unrolled=bool(rc.get("skip_unrolled", False)),
        device=device,
    )


@app(_CONFIG)
def main(config, device):
    from ...data.datasets import get_dataset, simulate_dataset
    from ...hardware.trainable_mask import prep_trainable_mask
    from ...train.trainer import Trainer, TrainerConfig

    # dataset
    if config.dataset.name == "simulated":
        rng = np.random.RandomState(config.seed)
        psf = rng.rand(1, 64, 96, 3).astype(np.float32)
        psf /= np.linalg.norm(psf)
        ds = simulate_dataset({"dataset": "random",
                               "n_files": config.dataset.n_files}, psf=psf, device=device)
    else:
        kwargs = {}
        if config.dataset.get("random_flip"):
            kwargs["random_flip"] = True
        if config.dataset.get("input_snr") is not None:
            kwargs["input_snr"] = float(config.dataset.input_snr)
        ds = get_dataset(config.dataset.name, split="train",
                         downsample=config.dataset.downsample, device=device, **kwargs)
        psf = ds.psf

    batches = list(ds.batches(batch_size=config.dataset.batch_size))
    n_test = max(len(batches) // 5, 1)
    train_batches, test_batches = batches[n_test:], batches[:n_test]

    mask_cfg = dict(config.trainable_mask or {})
    if mask_cfg.get("mask_type"):
        mask_cfg.setdefault("device", device)
    mask = prep_trainable_mask(mask_cfg, psf=psf)
    model = _build_model(config, device, psf_channels=np.shape(psf)[-1])

    rc = config.reconstruction
    tr = config.training
    tcfg = TrainerConfig(
        epochs=tr.epoch,
        lr=float(tr.lr),
        optimizer=tr.optimizer,
        loss=tr.loss,
        lpips_weight=tr.lpips,
        unrolled_output_factor=(float(tr.unrolled_output_factor)
                                if tr.get("unrolled_output_factor") else None),
        pre_proc_aux=(float(tr.pre_proc_aux)
                      if tr.get("pre_proc_aux") else None),
        crop=tr.crop,
        skip_nan=tr.skip_nan,
        clip_grad=tr.clip_grad,
        random_rotate=(float(tr.random_rotate)
                       if tr.get("random_rotate") else None),
        pre_process_delay=rc.pre_process.get("delay"),
        post_process_delay=rc.post_process.get("delay"),
        pre_process_freeze=rc.pre_process.get("freeze"),
        post_process_freeze=rc.post_process.get("freeze"),
        pre_process_unfreeze=rc.pre_process.get("unfreeze"),
        post_process_unfreeze=rc.post_process.get("unfreeze"),
        metric_for_best=tr.metric_for_best,
        cosine_decay_warmup=tr.get("cosine_decay_warmup", False),
        save_dir=os.path.join(config.run_dir, "checkpoints"),
        save_examples=bool(tr.get("save_examples", False)),
        steps_per_epoch=len(train_batches),
    )
    trainer = Trainer(model, psf, lambda: iter(train_batches), test_batches,
                      tcfg, mask=mask, seed=config.seed, device=device)
    start = 0
    if tr.get("resume"):
        # resume=true needs an explicit prior checkpoint dir (each run
        # gets a fresh timestamped run_dir): training.resume=<path>
        resume_dir = tr.resume if isinstance(tr.resume, str) else None
        assert resume_dir and os.path.isdir(resume_dir), (
            "training.resume must be the checkpoints dir of a previous "
            "run (e.g. outputs/<date>/<time>/checkpoints)")
        start = trainer.resume(resume_dir)
        print(f"resumed at epoch {start}")
    log = trainer.train(start_epoch=start)
    print(f"best {tcfg.metric_for_best}: {trainer.best_metric}")
    return log


if __name__ == "__main__":
    main()
