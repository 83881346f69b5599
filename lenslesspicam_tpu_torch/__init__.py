"""lenslesspicam_tpu_torch: the PyTorch/CUDA port of lenslesspicam_tpu.

The ADMM reconstruction of lensless measurements on an NVIDIA H100,
gray or RGB, one image or a batch: the exact solver (``recon.admm``,
``torch.fft``), the fused half-spectrum solver (``recon.admm_split``
``precompute_rsplit`` / ``run_rsplit``, both kernel placements of the JAX
package) and the full-width split solver (``precompute_split`` /
``run_split``, ``*_general``, under the JAX package's names), whose
kernels are hand-written CUDA C++ for ``sm_90a`` (``ops/csrc``), at the
storage modes of the JAX package (f32 or bf16 spectra, f32, bf16 or int16
carries).  Entry points run on the CUDA card unless the caller asks for
``device="cpu"``.
"""

__version__ = "0.1.0"

from .ops.fft_conv import FFTConvolver  # noqa: F401
from .recon.base import ADMM, ReconstructionAlgorithm, apply_admm  # noqa: F401
