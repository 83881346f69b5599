"""The port's fused solver in each storage mode against its own exact
solver at n = 300: the quality gates of tests/test_pallas_fft.py:314-415
(within 0.2 dB PSNR, no saturation), on the CPU with the kernels' plain
versions; no JAX in this file.

They lived in ``tests/test_torch_modes.py``; here, in a file of their own,
``--dist loadfile`` gives them a worker of their own, and PyTorch runs on
one thread for them (``one_thread``): its thread pool spinning beside the
other workers made these 5 s cases take minutes.
"""

import numpy as np
import pytest
import torch

from lenslesspicam_tpu_torch.ops.fft_conv import FFTConvolver
from lenslesspicam_tpu_torch.recon import admm as tadmm
from lenslesspicam_tpu_torch.recon import admm_split as tsplit

from test_torch_scripts import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

P = tsplit.ADMMParams()
TOL_PSNR_DB = 0.2          # tests/test_pallas_fft.py:358, 415


def _gate_scene(seed, rects):
    """The structured scenes and sparse PSFs of tests/test_pallas_fft.py:
    314-415 at 96 x 128, measured with the port's own convolver."""
    h, w = 96, 128
    rng = np.random.RandomState(seed)
    scene = np.zeros((h, w), np.float32)
    for (y0, y1, x0, x1, val) in rects:
        scene[y0:y1, x0:x1] = val
    psf = np.zeros((h, w), np.float32)
    ys, xs = rng.randint(0, h, 200), rng.randint(0, w, 200)
    psf[ys, xs] = rng.rand(200)
    psf /= np.linalg.norm(psf)
    fwd = FFTConvolver.from_psf(psf[None, :, :, None], pad=True, norm="backward",
                                device="cpu")
    meas = fwd.convolve(torch.from_numpy(scene)[None, None, :, :, None])[0, 0, :, :, 0]
    return scene, psf, (meas / meas.max()).numpy().astype(np.float32)


SCENES = {"tv": (1, [(20, 40, 30, 60, 1.0), (50, 80, 70, 110, 0.6)]),
          "v": (2, [(25, 45, 20, 70, 0.9), (55, 75, 60, 120, 0.4)])}


@pytest.mark.parametrize("scene_key,io,tv,v", [("tv", "f32", "i16", "f32"),
                                               ("v", "f32", "f32", "i16"),
                                               ("tv", "bf16", "i16", "i16"),
                                               ("v", "bf16", "i16", "i16")])
def test_quality_gate_n300(scene_key, io, tv, v):
    """The fused solver in a storage mode (plain versions) within 0.2 dB
    PSNR of the port's exact solver at n = 300 (no JAX in this test)."""
    scene, psf, meas = _gate_scene(*SCENES[scene_key])

    def psnr_of(x):
        xn = x / max(float(x.max()), 1e-9)
        return -10 * np.log10(np.mean((xn - scene / scene.max()) ** 2) + 1e-12)

    conv = tadmm.make_convolver(psf[None, :, :, None], device="cpu")
    ref = tadmm.run(conv, meas[None, None, :, :, None], n_iter=300)[0, 0, :, :, 0].numpy()
    pre = tsplit.precompute_rsplit(psf, meas, device="cpu")
    out, sat = tsplit.run_rsplit(pre, P, 300, return_sat=True, io=io, carry_tv=tv, carry_v=v)
    assert sat < 1.0
    assert abs(psnr_of(ref) - psnr_of(out.numpy())) < TOL_PSNR_DB
