"""The port's entry points take tensors as well as numpy arrays, as the
JAX package's take its device arrays: a tensor that requires grad gives
the numpy input's result bit for bit, and the result does not require
grad.  A requires_grad tensor takes the path a CUDA tensor takes (no
numpy round trip), so the CPU holds it here; ``chip_smoke.py`` passes
CUDA tensors on the card.
"""

import numpy as np
import pytest
import torch

from lenslesspicam_tpu_torch.recon import admm_split as tsplit
from lenslesspicam_tpu_torch.recon.base import ADMM, apply_admm

GRAY = (48, 64)
SPLIT = (48, 256)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.rand(*s).astype(np.float32) for s in shapes]


def _grad(a):
    return torch.from_numpy(a.copy()).requires_grad_()


def _equal(a, b):
    assert not a.requires_grad and not b.requires_grad
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["set_data", "background", "batch_apply", "apply_admm"])
def test_admm_takes_tensors_that_require_grad(entry):
    psf, data, bg = _arrays(30, (1, *GRAY, 1), (1, *GRAY, 1), (1, *GRAY, 1))
    batch, = _arrays(31, (2, 1, *GRAY, 1))

    def run(conv):
        if entry == "apply_admm":
            return apply_admm(conv(psf), conv(data), n_iter=4, device="cpu")
        rec = ADMM(conv(psf), device="cpu")
        if entry == "batch_apply":
            return rec.batch_apply(conv(batch), n_iter=4)
        rec.set_data(conv(data))
        return rec.apply(n_iter=4, background=conv(bg) if entry == "background" else None)

    out, ref = run(_grad), run(lambda a: a)
    assert tuple(out.shape) == ((2, 1, *GRAY, 1) if entry == "batch_apply" else (1, *GRAY, 1))
    _equal(out, ref)


@pytest.mark.parametrize("general", [False, True], ids=["gray", "general"])
@pytest.mark.parametrize("solver", ["rsplit", "split"])
def test_precomputes_take_tensors_that_require_grad(solver, general):
    """precompute_{rsplit,split} at 48 x 64 / 48 x 256, and their _general
    forms on an RGB PSF and a batch of 2: every array bit-equal, nothing
    requiring grad; the solve from either gives one result."""
    shape = GRAY if solver == "rsplit" else SPLIT
    fields = tsplit.ARRAY_FIELDS if solver == "rsplit" else tsplit.SPLIT_FIELDS
    if general:
        psf, data = _arrays(32, (1, *shape, 3), (2, 1, *shape, 3))
        pre_fn = getattr(tsplit, f"precompute_{solver}_general")
    else:
        psf, data = _arrays(33, shape, shape)
        pre_fn = getattr(tsplit, f"precompute_{solver}")
    a, b = pre_fn(_grad(psf), _grad(data), device="cpu"), pre_fn(psf, data, device="cpu")
    if general:
        (a, info_a), (b, info_b) = a, b
        assert info_a == info_b
    for f in fields:
        _equal(getattr(a, f), getattr(b, f))
    if general:
        run = getattr(tsplit, f"run_{solver}_general")
        _equal(run(a, info_a, _grad(data), n_iter=2), run(b, info_b, data, n_iter=2))
    else:
        run = getattr(tsplit, f"run_{solver}")
        _equal(run(a, n_iter=2), run(b, n_iter=2))


def test_bf16_tensor_reaches_the_host_precompute_as_f32():
    """A bf16 tensor goes to the float64 host precompute through f32 (numpy
    has no bf16), as its numpy f32 copy does."""
    psf, data = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(34, GRAY, GRAY))
    a = tsplit.precompute_rsplit(psf, data, device="cpu")
    b = tsplit.precompute_rsplit(psf.float().numpy(), data.float().numpy(), device="cpu")
    for f in tsplit.ARRAY_FIELDS:
        _equal(getattr(a, f), getattr(b, f))
