"""lenslesspicam_tpu_torch: the PyTorch/CUDA port of lenslesspicam_tpu.

Lensless reconstruction on an NVIDIA H100, gray or RGB, one image or a
batch, behind the JAX package's public surface: the classical solvers
(``ADMM``, ``GradientDescent``, ``NesterovGradientDescent``, ``FISTA``,
``APGD``, ``CodedApertureReconstruction``), the virtual sensors, and in
``recon.admm_split`` the fused half-spectrum solver (``precompute_rsplit``
/ ``run_rsplit``, both kernel placements of the JAX package) and the
full-width split solver (``precompute_split`` / ``run_split``,
``*_general``), whose kernels are hand-written CUDA C++ for ``sm_90a``
(``ops/csrc``), at the storage modes of the JAX package.  ``eval`` holds
the metrics (MSE, PSNR, SSIM, LPIPS), Parameterize-and-Perturb and the
benchmark harness; ``models`` the learned reconstructions (unrolled ADMM
and FISTA, the trainable inversions, MultiWiener, UNetRes / DRUNet,
Restormer and their composition ``TrainableRecon``) as ``nn.Module``s, and
``zoo.model_dict.build_model`` makes them from the zoo's names.  Entry points run on the CUDA card unless the caller
asks for ``device="cpu"``.
"""

__version__ = "0.1.0"

from .ops.fft_conv import FFTConvolver, make_convolver  # noqa: F401
from .recon.base import (  # noqa: F401
    ADMM,
    FISTA,
    GradientDescent,
    NesterovGradientDescent,
    ReconstructionAlgorithm,
    apply_admm,
)
from .recon.apgd import APGDPriors  # noqa: F401
from .recon.tikhonov import CodedApertureReconstruction  # noqa: F401
from .hardware.sensor import SensorOptions, VirtualSensor, sensor_dict  # noqa: F401

# the JAX package's lazy exports: the learned models (nn.Modules) and APGD
_LAZY = {
    "TrainableRecon": ("models.trainable_recon", "TrainableRecon"),
    "TrainableReconstructionAlgorithm": ("models.trainable_recon", "TrainableRecon"),
    "UnrolledADMM": ("models.unrolled", "UnrolledADMM"),
    "UnrolledFISTA": ("models.unrolled", "UnrolledFISTA"),
    "TrainableInversion": ("models.inversion", "TrainableInversion"),
    "SVDeconvNet": ("models.inversion", "SVDeconvNet"),
    "MultiWiener": ("models.multi_wiener", "MultiWiener"),
    "UNetRes": ("models.unet", "UNetRes"),
    "Restormer": ("models.restormer", "Restormer"),
    "APGD": ("recon.apgd", "run"),
}


def __getattr__(name):
    """The learned models and ``APGD`` (``recon.apgd.run``) on first use, as
    the JAX package exports them."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
