"""The model zoo's registry and ``build_model``, the host-only part (port of
lenslesspicam_tpu/zoo/model_dict.py).

The registry maps camera -> dataset -> model name -> Hugging Face repo, a
copy of the JAX package's (its naming grammar is the reference's
configs/benchmark/README.md:18-24):

    [Unet{X}M+]  pre-processor UNetRes of ~X M params
    U{N}         unrolled ADMM with N iterations
    TrainInv     FlatNet trainable inversion
    MWDN{X}M     multi-Wiener deconvolution network
    MMCN         compensation-branch network
    [+Unet{X}M]  post-processor
    _psfNN       PSF-correction network

``parse_model_name`` turns a name into an architecture spec and
``build_model`` makes the untrained module on a device.  ``load_model``
rebuilds a model from a reference checkpoint folder (its Hydra config and
torch weights); ``download_model`` fetches one from the Hugging Face hub
(``huggingface_hub``, imported at the call).
"""

from __future__ import annotations

import re

from .._device import resolve_device

model_dict = {
    "diffusercam": {
        "mirflickr": {
            # -- only unrolled20
            "U20": "bezzam/diffusercam-mirflickr-unrolled-admm20",
            "U20_0db": "bezzam/diffusercam-mirflickr-unrolled-admm20-0db",
            "U20_10db": "bezzam/diffusercam-mirflickr-unrolled-admm20-10db",
            "U20_20db": "bezzam/diffusercam-mirflickr-unrolled-admm20-20db",
            # -- only pre-process
            "Unet+U20": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20",
            "Unet+U20_0dB": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20-0db",
            "Unet+U20_10db": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20-10db",
            "Unet+U20_20db": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20-20db",
            # -- only post-process
            "U20+Unet": "bezzam/diffusercam-mirflickr-unrolled-admm20-unet2",
            "U20+Unet_0db": "bezzam/diffusercam-mirflickr-unrolled-admm20-unet2-0db",
            "U20+Unet_10db": "bezzam/diffusercam-mirflickr-unrolled-admm20-unet2-10db",
            "U20+Unet_20db": "bezzam/diffusercam-mirflickr-unrolled-admm20-unet2-20db",
            "U20+Drunet": "bezzam/diffusercam-mirflickr-unrolled-admm20-drunet",
            "TrainInv+Drunet": "bezzam/diffusercam-mirflickr-trainable-inv-drunet",
            # -- both
            "Unet+TrainInv+Unet": "bezzam/diffusercam-mirflickr-unet2-trainable-inv-unet2",
            "Unet+U20+Unet": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20-unet2",
            "Unet+U20+Unet_aux0.01": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20-unet2-aux0.01",
            "Unet+U20+Unet_aux0.03": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20-unet2-aux0.03",
            "Unet+U20+Unet_aux0.1": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20-unet2-aux0.1",
            "Unet+U20+Unet_aux1": "bezzam/diffusercam-mirflickr-unet2-unrolled-admm20-unet2-aux1",
            # baseline benchmarks which don't have a model file but use ADMM
            "admm_fista": "bezzam/diffusercam-mirflickr-admm-fista",
            "admm_pnp": "bezzam/diffusercam-mirflickr-admm-pnp",
            # -- TCI submission
            "TrainInv+Unet8M": "bezzam/diffusercam-mirflickr-trainable-inv-unet8M",
            "Unet4M+U5+Unet4M": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M",
            "MWDN8M": "bezzam/diffusercam-mirflickr-mwdn-8M",
            "Unet2M+MWDN6M": "bezzam/diffusercam-mirflickr-unet2M-mwdn-6M",
            "Unet4M+TrainInv+Unet4M": "bezzam/diffusercam-mirflickr-unet4M-trainable-inv-unet4M",
            "MMCN4M+Unet4M": "bezzam/diffusercam-mirflickr-mmcn-unet4M",
            "U5+Unet8M": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet8M",
            "Unet8M+U5": "bezzam/diffusercam-mirflickr-unet8M-unrolled-admm5",
            "Unet2M+MMCN+Unet2M": "bezzam/diffusercam-mirflickr-unet2M-mmcn-unet2M",
            "Unet4M+U20+Unet4M": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm20-unet4M",
            "Unet4M+U10+Unet4M": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm10-unet4M",
            "Unet4M+U5+Unet4M_psfNN": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psfNN",
            # training with PSF noise
            "U5+Unet8M_psf0dB": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet8M-psf0dB",
            "U5+Unet8M_psf-5dB": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet8M-psf-5dB",
            "U5+Unet8M_psf-10dB": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet8M-psf-10dB",
            "U5+Unet8M_psf-20dB": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet8M-psf-20dB",
            "Unet4M+U5+Unet4M_psf-0dB": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psf-0dB",
            "Unet4M+U5+Unet4M_psf-5dB": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psf-5dB",
            "Unet4M+U5+Unet4M_psf-10dB": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psf-10dB",
            "Unet4M+U5+Unet4M_psf-20dB": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psf-20dB",
            "Unet4M+U5+Unet4M_psfNN_psf-0dB": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psfNN-psf-0dB",
            "Unet4M+U5+Unet4M_psfNN_psf-10dB": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psfNN-psf-10dB",
            "Unet4M+U5+Unet4M_psfNN_psf-20dB": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psfNN-psf-20dB",
            # training with noise
            "U5+Unet8M_10db": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet8M-10db",
            "U5+Unet8M_40db": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet8M-40db",
            "Unet4M+U5+Unet4M_10db": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-10db",
            "Unet4M+U5+Unet4M_40db": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-40db",
            # fine-tuning tapecam
            "Unet4M+U5+Unet4M_ft_tapecam": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-ft-tapecam",
            "Unet4M+U5+Unet4M_ft_tapecam_post": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-ft-tapecam-post",
            "Unet4M+U5+Unet4M_ft_tapecam_pre": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-ft-tapecam-pre",
            # transformers, ADAMW optimizer
            "U5+Unet8M_adamw": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet8M-adamw",
            "Unet4M+U5+Unet4M_adamw": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-adamw",
            "Unet4M+U5+Unet4M_psfNN_adamw": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psfNN-adamw",
            "U5+Transformer8M": "bezzam/diffusercam-mirflickr-unrolled-admm5-transformer8M",
            "Transformer4M+U5+Transformer4M": "bezzam/diffusercam-mirflickr-transformer4M-unrolled-admm5-transformer4M",
            "Transformer4M+U5+Transformer4M_psfNN": "bezzam/difusercam-mirflickr-transformer4M-unrolled-admm5-transformer4M-psfNN",
            # SVDeconvNet comparison (full resolution)
            "U5+Unet12M_fullres": "bezzam/diffusercam-mirflickr-unrolled-admm5-unet12M-fullres",
            "Unet6M+U5+Unet6M_fullres": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-fullres",
            "Unet6M+U5+Unet6M_psfNN_fullres": "bezzam/diffusercam-mirflickr-unet4M-unrolled-admm5-unet4M-psfNN-fullres",
            "SVDecon+UNet8M": "bezzam/diffusercam-mirflickr-svdecon-unet4M",
            "Unet4M+SVDecon+Unet4M": "bezzam/diffusercam-mirflickr-unet4M-svdecon-unet4M",
        },
        "mirflickr_sim": {
            "Unet4M+U5+Unet4M": "bezzam/diffusercam-mirflickr-sim-unet4M-unrolled-admm5-unet4M",
            "Unet4M+U5+Unet4M_ft_tapecam": "bezzam/diffusercam-mirflickr-sim-unet4M-unrolled-admm5-unet4M-ft-tapecam",
            "Unet4M+U5+Unet4M_ft_tapecam_post": "bezzam/diffusercam-mirflickr-sim-unet4M-unrolled-admm5-unet4M-ft-tapecam-post",
            "Unet4M+U5+Unet4M_ft_tapecam_pre": "bezzam/diffusercam-mirflickr-sim-unet4M-unrolled-admm5-unet4M-ft-tapecam-pre",
            "Unet4M+U5+Unet4M_ft_digicam_multi_post": "bezzam/diffusercam-mirflickr-sim-unet4M-unrolled-admm5-unet4M-ft-digicam-multi-post",
            "Unet4M+U5+Unet4M_ft_digicam_multi_pre": "bezzam/diffusercam-mirflickr-sim-unet4M-unrolled-admm5-unet4M-ft-digicam-multi-pre",
            "Unet4M+U5+Unet4M_ft_digicam_multi": "bezzam/diffusercam-mirflickr-sim-unet4M-unrolled-admm5-unet4M-ft-digicam-multi",
        },
    },
    "digicam": {
        "celeba_26k": {
            "unrolled_admm10": "bezzam/digicam-celeba-unrolled-admm10",
            "unrolled_admm10_ft_psf": "bezzam/digicam-celeba-unrolled-admm10-ft-psf",
            "unet8M": "bezzam/digicam-celeba-unet8M",
            "TrainInv+Unet8M": "bezzam/digicam-celeba-trainable-inv-unet8M",
            "unrolled_admm10_post8M": "bezzam/digicam-celeba-unrolled-admm10-post8M",
            "unrolled_admm10_ft_psf_post8M": "bezzam/digicam-celeba-unrolled-admm10-ft-psf-post8M",
            "pre8M_unrolled_admm10": "bezzam/digicam-celeba-pre8M-unrolled-admm10",
            "pre4M_unrolled_admm10_post4M": "bezzam/digicam-celeba-pre4M-unrolled-admm10-post4M",
            "pre4M_unrolled_admm10_ft_psf_post4M": "bezzam/digicam-celeba-pre4M-unrolled-admm10-ft-psf-post4M",
            "Unet4M+TrainInv+Unet4M": "bezzam/digicam-celeba-unet4M-trainable-inv-unet4M",
            # ADMM baselines (no model file)
            "admm_measured_psf": "bezzam/digicam-celeba-admm-measured-psf",
            "admm_simulated_psf": "bezzam/digicam-celeba-admm-simulated-psf",
            # TCI submission (waveprop simulation)
            "U5+Unet8M_wave": "bezzam/digicam-celeba-unrolled-admm5-unet8M",
            "Unet8M+U5_wave": "bezzam/digicam-celeba-unet8M-unrolled-admm5",
            "TrainInv+Unet8M_wave": "bezzam/digicam-celeba-trainable-inv-unet8M_wave",
            "MWDN8M_wave": "bezzam/digicam-celeba-mwnn-8M",
            "MMCN4M+Unet4M_wave": "bezzam/digicam-celeba-mmcn-unet4M",
            "Unet2M+MWDN6M_wave": "bezzam/digicam-celeba-unet2M-mwdn-6M",
            "Unet4M+TrainInv+Unet4M_wave": "bezzam/digicam-celeba-unet4M-trainable-inv-unet4M_wave",
            "Unet2M+MMCN+Unet2M_wave": "bezzam/digicam-celeba-unet2M-mmcn-unet2M",
            "Unet4M+U5+Unet4M_wave": "bezzam/digicam-celeba-unet4M-unrolled-admm5-unet4M",
            "Unet4M+U10+Unet4M_wave": "bezzam/digicam-celeba-unet4M-unrolled-admm10-unet4M",
            "Unet4M+U5+Unet4M_wave_psfNN": "bezzam/digicam-celeba-unet4M-unrolled-admm5-unet4M-wave-psfNN",
        },
        "mirflickr_single_25k": {
            # simulated PSF (without waveprop, with deadspace)
            "U10": "bezzam/digicam-mirflickr-single-25k-unrolled-admm10",
            "Unet8M": "bezzam/digicam-mirflickr-single-25k-unet8M",
            "TrainInv+Unet8M": "bezzam/digicam-mirflickr-single-25k-trainable-inv-unet8M",
            "U10+Unet8M": "bezzam/digicam-mirflickr-single-25k-unrolled-admm10-unet8M",
            "Unet4M+TrainInv+Unet4M": "bezzam/digicam-mirflickr-single-25k-unet4M-trainable-inv-unet4M",
            "Unet4M+U10+Unet4M": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm10-unet4M",
            # simulated PSF (with waveprop, with deadspace)
            "U10_wave": "bezzam/digicam-mirflickr-single-25k-unrolled-admm10-wave",
            "U10+Unet8M_wave": "bezzam/digicam-mirflickr-single-25k-unrolled-admm10-unet8M-wave",
            "Unet8M_wave": "bezzam/digicam-mirflickr-single-25k-unet8M-wave",
            "Unet8M_wave_v2": "bezzam/digicam-mirflickr-single-25k-unet8M-wave-v2",
            "Unet4M+U10+Unet4M_wave": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm10-unet4M-wave",
            "TrainInv+Unet8M_wave": "bezzam/digicam-mirflickr-single-25k-trainable-inv-unet8M-wave",
            "U5+Unet8M_wave": "bezzam/digicam-mirflickr-single-25k-unrolled-admm5-unet8M-wave",
            "Unet8M+U5_wave": "bezzam/digicam-mirflickr-single-25k-unet8M-unrolled-admm5-wave",
            "Unet4M+U5+Unet4M_wave": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm5-unet4M-wave",
            "Unet4M+U5+Unet4M_wave_psfNN": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm5-unet4M-wave-psfNN",
            "MWDN8M_wave": "bezzam/digicam-mirflickr-single-25k-mwdn-8M",
            "MMCN4M+Unet4M_wave": "bezzam/digicam-mirflickr-single-25k-mmcn-unet4M",
            "Unet2M+MMCN+Unet2M_wave": "bezzam/digicam-mirflickr-single-25k-unet2M-mmcn-unet2M-wave",
            "Unet4M+TrainInv+Unet4M_wave": "bezzam/digicam-mirflickr-single-25k-unet4M-trainable-inv-unet4M-wave",
            "Unet2M+MWDN6M_wave": "bezzam/digicam-mirflickr-single-25k-unet2M-mwdn-6M",
            "Unet4M+U5+Unet4M_wave_aux1": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm5-unet4M-wave-aux1",
            "Unet4M+U5+Unet4M_wave_flips": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm5-unet4M-wave-flips",
            "Unet4M+U5+Unet4M_wave_flips_rotate10": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm5-unet4M-wave-flips-rotate10",
            # measured PSF
            "Unet4M+U10+Unet4M_measured": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm10-unet4M-measured",
            # simulated PSF (with waveprop, no deadspace)
            "Unet4M+U10+Unet4M_wave_nodead": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm10-unet4M-wave-nodead",
            # simulated PSF (without waveprop, no deadspace)
            "Unet4M+U10+Unet4M_nodead": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm10-unet4M-nodead",
            # finetune
            "Unet4M+U5+Unet4M_ft_flips": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm5-unet4M-ft-flips",
            "Unet4M+U5+Unet4M_ft_flips_rotate10": "bezzam/digicam-mirflickr-single-25k-unet4M-unrolled-admm5-unet4M-ft-flips-rotate10",
        },
        "mirflickr_multi_25k": {
            # simulated PSFs (without waveprop, with deadspace)
            "Unet8M": "bezzam/digicam-mirflickr-multi-25k-unet8M",
            "Unet8M_wave_v2": "bezzam/digicam-mirflickr-multi-25k-unet8M-wave-v2",
            "Unet4M+U10+Unet4M": "bezzam/digicam-mirflickr-multi-25k-unet4M-unrolled-admm10-unet4M",
            # simulated PSF (with waveprop, with deadspace)
            "Unet4M+U10+Unet4M_wave": "bezzam/digicam-mirflickr-multi-25k-unet4M-unrolled-admm10-unet4M-wave",
            "Unet4M+U5+Unet4M_wave": "bezzam/digicam-mirflickr-multi-25k-unet4M-unrolled-admm5-unet4M-wave",
            "Unet4M+U5+Unet4M_wave_psfNN": "bezzam/digicam-mirflickr-multi-25k-unet4M-unrolled-admm5-unet4M-wave-psfNN",
            "Unet4M+U5+Unet4M_wave_aux1": "bezzam/digicam-mirflickr-multi-25k-unet4M-unrolled-admm5-unet4M-wave-aux1",
            "Unet4M+U5+Unet4M_wave_flips": "bezzam/digicam-mirflickr-multi-25k-unet4M-unrolled-admm5-unet4M-wave-flips",
        },
    },
    "tapecam": {
        "mirflickr": {
            "U5+Unet8M": "bezzam/tapecam-mirflickr-unrolled-admm5-unet8M",
            "Unet8M+U5": "bezzam/tapecam-mirflickr-unet8M-unrolled-admm5",
            "TrainInv+Unet8M": "bezzam/tapecam-mirflickr-trainable-inv-unet8M",
            "MMCN4M+Unet4M": "bezzam/tapecam-mirflickr-mmcn-unet4M",
            "MWDN8M": "bezzam/tapecam-mirflickr-mwdn-8M",
            "Unet4M+TrainInv+Unet4M": "bezzam/tapecam-mirflickr-unet4M-trainable-inv-unet4M",
            "Unet4M+U5+Unet4M": "bezzam/tapecam-mirflickr-unet4M-unrolled-admm5-unet4M",
            "Unet2M+MMCN+Unet2M": "bezzam/tapecam-mirflickr-unet2M-mmcn-unet2M",
            "Unet2M+MWDN6M": "bezzam/tapecam-mirflickr-unet2M-mwdn-6M",
            "Unet4M+U10+Unet4M": "bezzam/tapecam-mirflickr-unet4M-unrolled-admm10-unet4M",
            "Unet4M+U5+Unet4M_flips": "bezzam/tapecam-mirflickr-unet4M-unrolled-admm5-unet4M-flips",
            "Unet4M+U5+Unet4M_flips_rotate10": "bezzam/tapecam-mirflickr-unet4M-unrolled-admm5-unet4M-flips-rotate10",
            "Unet4M+U5+Unet4M_aux1": "bezzam/tapecam-mirflickr-unet4M-unrolled-admm5-unet4M-aux1",
            "Unet4M+U5+Unet4M_psfNN": "bezzam/tapecam-mirflickr-unet4M-unrolled-admm5-unet4M-psfNN",
        },
    },
    "multilens": {
        "mirflickr_ambient": {
            "U5+Unet8M": "lensless/multilens-mirflickr-ambient-unrolled-admm5-unet8M",
            "U5+Unet8M_direct_sub": "lensless/multilens-mirflickr-ambient-unrolled-admm5-unet8M-direct-sub",
            "U5+Unet8M_learned_sub": "lensless/multilens-mirflickr-ambient-unrolled-admm5-unet8M-learned-sub",
            "Unet4M+U5+Unet4M": "lensless/multilens-mirflickr-ambient-unet4M-unrolled-admm5-unet4M",
            "Unet4M+U5+Unet4M_direct_sub": "lensless/multilens-mirflickr-ambient-unet4M-unrolled-admm5-unet4M-direct-sub",
            "Unet4M+U5+Unet4M_learned_sub": "lensless/multilens-mirflickr-ambient-unet4M-unrolled-admm5-unet4M-learned-sub",
            "Unet4M+U5+Unet4M_concat": "lensless/multilens-mirflickr-ambient-unet4M-unrolled-admm5-unet4M-concat-ext",
            "Unet4M+U5+Unet4M_concat_psfNN": "lensless/multilens-mirflickr-ambient-unet4M-unrolled-admm5-unet4M-concat-psfNN",
            "TrainInv+Unet8M": "lensless/multilens-mirflickr-ambient-trainable-inv-unet8M",
            "TrainInv+Unet8M_learned_sub": "lensless/multilens-mirflickr-ambient-trainable-inv-unet8M-learned-sub",
            "Unet4M+TrainInv+Unet4M": "lensless/multilens-mirflickr-ambient-unet4M-trainable-inv-unet4M",
            "Unet4M+TrainInv+Unet4M_learned_sub": "lensless/multilens-mirflickr-ambient-unet4M-trainable-inv-unet4M-learned-sub",
            "Unet4M+TrainInv+Unet4M_concat": "lensless/multilens-mirflickr-ambient-unet4M-trainable-inv-unet4M-concat-ext",
            "TrainInv+Unet8M_direct_sub": "lensless/multilens-mirflickr-ambient-trainable-inv-unet8M-direct-sub",
            "Unet4M+TrainInv+Unet4M_direct_sub": "lensless/multilens-mirflickr-ambient-unet4M-trainable-inv-unet4M-direct-sub",
        },
    },
}

# UNetRes channel plans sized to approximate parameter budgets
# (reference train configs; e.g. Unet4M ~ nc=[32,64,116,128])
_UNET_NC = {
    None: (32, 64, 112, 128),
    "2": (16, 32, 64, 128),
    "2M": (23, 46, 92, 128),
    "4M": (32, 64, 116, 128),
    "6M": (44, 88, 176, 222),
    "8M": (51, 102, 204, 256),
}


def parse_model_name(name: str) -> dict:
    """Parse the model-name grammar into an architecture spec.

    Covers the ``Unet4M+U5+Unet4M`` camel grammar, the digicam-celeba
    lowercase grammar (``pre8M_unrolled_admm10_post8M``, ``unet8M``),
    transformer (Restormer) processors, SVDeconvNet, and the
    classical-baseline entries (``admm_*`` — no model file; the
    reference special-cases these the same way, model_dict.py:297-306).
    """
    spec = {
        "pre": None, "post": None, "inversion": None, "n_iter": 5,
        "psf_network": False, "mwdn": None, "compensation": False,
        "baseline": None, "pre_kind": "unetres", "post_kind": "unetres",
    }
    if name.startswith("admm"):
        spec["baseline"] = name
        return spec
    # digicam-celeba lowercase grammar
    m = re.fullmatch(
        r"(?:pre(\d+M?)_)?unrolled_admm(\d+)(?:_ft_psf)?(?:_post(\d+M?))?",
        name)
    if m:
        spec["pre"], spec["post"] = m.group(1), m.group(3)
        spec["inversion"] = "unrolled_admm"
        spec["n_iter"] = int(m.group(2))
        return spec
    m = re.fullmatch(r"unet(\d+M?)", name)
    if m:
        spec["post"] = m.group(1)
        return spec
    base = name.split("_")[0]
    spec["psf_network"] = "psfNN" in name
    parts = base.split("+")
    seen_inv = False
    for part in parts:
        m_unet = re.fullmatch(r"U[Nn]et(\d+M?)?", part)
        m_tf = re.fullmatch(r"Transformer(\d+M?)?", part)
        m_u = re.fullmatch(r"U(\d+)", part)
        m_mwdn = re.fullmatch(r"MWDN(\d+M?)?", part)
        m_mmcn = re.fullmatch(r"MMCN(\d+M?)?", part)
        if m_u:
            spec["inversion"] = "unrolled_admm"
            spec["n_iter"] = int(m_u.group(1))
            seen_inv = True
        elif part == "TrainInv":
            spec["inversion"] = "trainable_inversion"
            seen_inv = True
        elif part == "SVDecon":
            spec["inversion"] = "svdeconvnet"
            seen_inv = True
        elif m_mwdn:
            spec["inversion"] = "multi_wiener"
            spec["mwdn"] = m_mwdn.group(1)
            seen_inv = True
        elif m_mmcn:
            spec["compensation"] = True
            seen_inv = True
        elif m_unet or m_tf or part == "Drunet":
            key = "post" if seen_inv else "pre"
            if m_tf:
                spec[key] = m_tf.group(1)
                spec[key + "_kind"] = "restormer"
            else:
                spec[key] = m_unet.group(1) if m_unet else "drunet"
        else:
            raise ValueError(f"cannot parse model component: {part!r}")
    return spec


def build_model(name: str, nb: int = 4, device=None):
    """The untrained module for a zoo name, as the JAX package builds it
    (UNetRes processors take RGB plus the noise channel), on ``device``
    (None: the CUDA card)."""
    from ..models.inversion import SVDeconvNet, TrainableInversion
    from ..models.multi_wiener import MultiWiener
    from ..models.restormer import Restormer
    from ..models.trainable_recon import TrainableRecon
    from ..models.unet import UNetRes
    from ..models.unrolled import UnrolledADMM

    spec = parse_model_name(name)
    if spec["baseline"]:
        raise ValueError(
            f"{name!r} is a classical baseline (no model file); run "
            "recon.admm / eval.pnp directly instead of build_model")
    device = resolve_device(device)

    def proc(size, kind):
        if size is None:
            return None
        if kind == "restormer":
            return Restormer(out_channels=3, device=device)
        nc = _UNET_NC.get(size if size != "drunet" else None, _UNET_NC[None])
        return UNetRes(in_nc=4, out_nc=3, nc=nc, nb=nb, device=device)

    if spec["inversion"] == "multi_wiener":
        return MultiWiener(in_channels=3, out_channels=3, device=device)

    inversion = None
    if spec["inversion"] == "unrolled_admm":
        inversion = UnrolledADMM(n_iter=spec["n_iter"], device=device)
    elif spec["inversion"] == "trainable_inversion":
        inversion = TrainableInversion()
    elif spec["inversion"] == "svdeconvnet":
        inversion = SVDeconvNet(device=device)

    return TrainableRecon(
        camera_inversion=inversion,
        pre_process=proc(spec["pre"], spec["pre_kind"]),
        post_process=proc(spec["post"], spec["post_kind"]),
        psf_network=proc("4M", "unetres") if spec["psf_network"] else None,
        skip_unrolled=inversion is None,
        device=device,
    )


def download_model(camera: str, dataset: str, model: str, local_model_dir=None):
    """Download a published checkpoint folder from the Hugging Face hub
    (``huggingface_hub.snapshot_download``, imported here; needs the
    network or the hub's cache) and return its local path, for
    :func:`load_model`."""
    from huggingface_hub import snapshot_download

    repo_id = model_dict[camera][dataset][model]
    return snapshot_download(repo_id=repo_id, cache_dir=local_model_dir)


def remove_data_parallel(state_dict):
    """Strip the ``module.`` prefixes that ``nn.DataParallel`` leaves."""
    return {k.replace("module.", ""): v for k, v in state_dict.items()}


def _build_processor(sub_cfg, device, input_background=False, concat_comp=False):
    """The processor of a pre/post_process config entry: a Restormer with
    the config's sizes, or a UNetRes (``UnetRes`` or ``DruNet``) of ``nc``
    channels and ``depth`` blocks a scale; None for no network."""
    from ..models.restormer import Restormer
    from ..models.unet import UNetRes

    if not sub_cfg or not sub_cfg.get("network"):
        return None
    if sub_cfg["network"] == "Restormer":
        rp = sub_cfg["restormer_params"]
        return Restormer(out_channels=3, dim=rp["dim"], num_blocks=tuple(rp["num_blocks"]),
                         num_refinement_blocks=rp["num_refinement_blocks"],
                         heads=tuple(rp["heads"]), expansion=rp["ffn_expansion_factor"],
                         device=device)
    return UNetRes(in_nc=4, out_nc=3, nc=tuple(sub_cfg.get("nc") or _UNET_NC[None]),
                   nb=sub_cfg.get("depth", 4), background_subtraction=input_background,
                   concatenate_compensation=concat_comp, device=device)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _load_strict(module, sub_sd, name):
    """Load ``sub_sd`` into ``module``: every key of the module present,
    no other, every shape equal, else a RuntimeError naming ``name``."""
    try:
        module.load_state_dict(sub_sd, strict=True)
    except RuntimeError as e:
        raise RuntimeError(f"checkpoint does not fit the config's {name}: {e}") from e


def load_model(model_path: str, psf=None, verbose: bool = False, skip_pre: bool = False,
               skip_post: bool = False, return_intermediate: bool = False, device=None):
    """Rebuild a model from a reference checkpoint folder: its Hydra
    config ``.hydra/config.yaml`` (``yaml.safe_load``, PyYAML imported
    here) and its weights ``recon_epoch*`` (``BEST`` if there is one,
    else the last in ``sorted()`` order), a torch state dict with the
    reference's keys (``module.`` prefixes stripped; the unrolled
    schedules ``_mu1_p``, ``_mu2_p``, ``_mu3_p``, ``_tau_p`` at the top
    level).

    Families: unrolled ADMM, trainable inversion, SVDeconvNet, MultiWiener;
    UNetRes / DruNet / Restormer pre- and post-processors; a PSF network
    (with its residual); background networks (direct, learned or
    integrated subtraction); the compensation branch; the learned-PSF
    (``psf_epochBEST.npy``, a TrainablePSF mask) and noisy-PSF (``psf.pt``,
    ``files.psf_snr``) overrides.  Each component that the checkpoint
    holds is loaded strictly (a missing or extra key, or a shape, raises);
    one it does not hold keeps its initial values.  ``psf`` is unused, as
    in the JAX package: the PSF goes to the model's forward.

    Returns ``(model, config)``, or ``(model, config, psf)`` when the
    checkpoint overrides the PSF (then pass that PSF to the forward):
    ``model`` an ``nn.Module`` in ``eval()`` mode on ``device`` (None: the
    CUDA card).  The one difference from the JAX package's signature: its
    ``(model, variables, config[, psf])`` carries the weights apart, here
    they live in the module.
    """
    import glob
    import os

    import numpy as np
    import torch
    import yaml

    from ..models.trainable_recon import TrainableRecon
    from ..models.unet import UNetRes

    device = resolve_device(device)
    cfg_path = os.path.join(model_path, ".hydra", "config.yaml")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"no embedded config at {cfg_path}")
    with open(cfg_path) as f:
        config = yaml.safe_load(f)

    ckpts = sorted(glob.glob(os.path.join(model_path, "recon_epoch*")))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint recon_epoch* in {model_path}")
    best = [c for c in ckpts if "BEST" in c]
    ckpt = best[0] if best else ckpts[-1]
    sd = remove_data_parallel(torch.load(ckpt, map_location="cpu", weights_only=True))

    recon_cfg = config.get("reconstruction", {}) or {}
    files_cfg = config.get("files", {}) or {}
    method = recon_cfg.get("method", "unrolled_admm")

    # PSF overrides
    psf_out = None
    if (config.get("trainable_mask") or {}).get("mask_type") == "TrainablePSF":
        p = os.path.join(model_path, "psf_epochBEST.npy")
        if os.path.isfile(p):
            psf_out = np.load(p)
    if files_cfg.get("psf_snr") is not None:
        p = os.path.join(model_path, "psf.pt")
        if os.path.isfile(p):
            psf_out = torch.load(p, map_location="cpu", weights_only=True).numpy()

    def loaded(model):
        model.eval()
        if verbose:
            print(f"loaded {method} from {ckpt}")
        return (model, config) + ((psf_out,) if psf_out is not None else ())

    if method == "multi_wiener":
        from ..models.multi_wiener import MultiWiener

        mw_nc = tuple(recon_cfg.get("multi_wiener", {}).get("nc", (64, 128, 256, 512, 512)))
        model = MultiWiener(in_channels=3, out_channels=3,
                            psf_channels=1 if files_cfg.get("single_channel_psf") else 3,
                            nc=mw_nc, device=device)
        _load_strict(model, {k.replace("avgpool_conv", "pool_conv"): v for k, v in sd.items()
                             if not k.startswith(("pre_process", "post_process"))},
                     "multi_wiener")
        return loaded(model)

    # the camera inversion; its weights under camera_inversion., the
    # unrolled schedules at the top level
    inv_sd = {**_sub(sd, "camera_inversion."),
              **{k: v for k, v in sd.items() if k.startswith(("_mu", "_tau"))}}
    if method == "unrolled_admm":
        from ..models.unrolled import UnrolledADMM

        inversion = UnrolledADMM(n_iter=recon_cfg.get("unrolled_admm", {}).get("n_iter", 5),
                                 device=device)
    elif method == "trainable_inv":
        from ..models.inversion import TrainableInversion

        inversion = TrainableInversion(K=recon_cfg.get("trainable_inv", {}).get("K", 1e-4))
    elif method == "svdeconvnet":
        from ..models.inversion import SVDeconvNet

        inversion = SVDeconvNet(K=recon_cfg.get("svdeconvnet", {}).get("K", 3), device=device)
        if psf_out is not None:
            inv_sd["multipsf"] = torch.from_numpy(np.asarray(psf_out, np.float32))
    else:
        raise ValueError(f"unknown reconstruction method: {method!r}")
    if inv_sd:
        _load_strict(inversion, inv_sd, "camera inversion")

    # background subtraction, processors, PSF network, compensation branch
    learned_bg_nc = recon_cfg.get("learned_background_subtraction") or None
    integrated_bg_nc = recon_cfg.get("integrated_background_subtraction") or None
    comp_nc = recon_cfg.get("compensation") or None
    pre_cfg = recon_cfg.get("pre_process") or {}
    post_cfg = recon_cfg.get("post_process") or {}
    psf_net_nc = recon_cfg.get("psf_network") or None
    pre = _build_processor(pre_cfg, device,
                           input_background=recon_cfg.get("unetres_input_background", False))
    post = _build_processor(post_cfg, device, concat_comp=comp_nc[-1] if comp_nc else False)
    comp_branch = None
    if comp_nc:
        from ..models.compensation import CompensationBranch

        comp_branch = CompensationBranch(nc=tuple(comp_nc),
                                         residual=recon_cfg.get("compensation_residual", False),
                                         device=device)

    def unet(nc):
        return None if not nc else UNetRes(in_nc=4, out_nc=3, nc=tuple(nc), nb=len(nc),
                                           device=device)

    model = TrainableRecon(
        camera_inversion=inversion, pre_process=pre, post_process=post,
        psf_network=unet(psf_net_nc), background_network=unet(learned_bg_nc),
        compensation_branch=comp_branch, psf_residual=recon_cfg.get("psf_residual", False),
        direct_background_subtraction=bool(
            recon_cfg.get("direct_background_subtraction", False)),
        integrated_background_subtraction=bool(integrated_bg_nc),
        skip_unrolled=recon_cfg.get("skip_unrolled", False), skip_pre=skip_pre,
        skip_post=skip_post, return_intermediate=return_intermediate, device=device)

    for name in ("pre_process", "post_process", "psf_network", "background_network"):
        net, sub = getattr(model, f"{name}_model"), _sub(sd, f"{name}_model.")
        if net is not None and sub:
            _load_strict(net, sub, name)
            if f"{name}_param" in sd:
                with torch.no_grad():
                    getattr(model, f"{name}_param").copy_(sd[f"{name}_param"])
    comp_sd = _sub(sd, "compensation_branch.")
    if comp_branch is not None and comp_sd:
        _load_strict(comp_branch, comp_sd, "compensation branch")
    return loaded(model)
