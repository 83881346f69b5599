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
benchmark harness.  Entry points run on the CUDA card unless the caller
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

# the JAX package's lazy model exports, which the port has not reached yet
_MODELS = ("TrainableRecon", "TrainableReconstructionAlgorithm", "UnrolledADMM",
           "UnrolledFISTA", "TrainableInversion", "SVDeconvNet", "MultiWiener", "UNetRes",
           "Restormer")


def __getattr__(name):
    """``APGD`` (``recon.apgd.run``) on first use, as the JAX package
    exports it; the learned models raise until they are ported."""
    if name == "APGD":
        from .recon.apgd import run

        return run
    if name in _MODELS:
        raise AttributeError(
            f"{name} is a learned model, which the port does not have yet "
            "(ROADMAP Queue 1 item 13)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
