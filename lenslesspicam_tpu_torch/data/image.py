"""Host image utilities (port of ``rgb2gray`` and ``resize`` from
lenslesspicam_tpu/data/image.py).

Host numpy code, as in the JAX package, without OpenCV: ``resize``
computes what ``cv2.resize`` computes for float images (INTER_CUBIC:
Keys' cubic with a = -0.75; INTER_LINEAR: linear; half-pixel centres,
replicated border, no antialiasing) as two products with float64 weight
matrices.
"""

from __future__ import annotations

import numpy as np

INTER_LINEAR = 1      # cv2's codes, which the JAX package's callers pass
INTER_CUBIC = 2
_KINDS = {INTER_LINEAR: "linear", INTER_CUBIC: "cubic"}


def _cubic_coeffs(x):
    """cv2's ``interpolateCubic`` (a = -0.75) at offsets x in [0, 1): the
    weights of the taps at -1, 0, 1, 2."""
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], axis=-1)


def resize_weights(n_in: int, n_out: int, kind: str = "cubic") -> np.ndarray:
    """(n_out, n_in) float64 weights of ``cv2.resize`` along one axis."""
    fx = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(fx)
    fx = fx - sx
    sx = sx.astype(np.int64)
    if kind == "linear":
        # cv2 pins the edge samples to the edge pixel
        lo, hi = sx < 0, sx >= n_in - 1
        fx = np.where(lo | hi, 0.0, fx)
        sx = np.where(lo, 0, np.where(hi, n_in - 1, sx))
        taps, coeffs = sx[:, None] + np.arange(2), np.stack([1.0 - fx, fx], axis=-1)
    else:
        taps, coeffs = sx[:, None] + np.arange(-1, 3), _cubic_coeffs(fx)
    w = np.zeros((n_out, n_in))
    rows = np.repeat(np.arange(n_out), taps.shape[1])
    np.add.at(w, (rows, np.clip(taps, 0, n_in - 1).ravel()), coeffs.ravel())
    return w


def resize_hw(img: np.ndarray, hw, kind: str = "cubic") -> np.ndarray:
    """An (H, W) or (H, W, C) image resized to ``hw`` as ``cv2.resize``
    resizes it, in the input's dtype (integer types rounded and
    saturated)."""
    src = np.asarray(img)
    out = np.einsum("yh,hw...->yw...", resize_weights(src.shape[0], hw[0], kind),
                    src.astype(np.float64))
    out = np.einsum("xw,yw...->yx...", resize_weights(src.shape[1], hw[1], kind), out)
    if np.issubdtype(src.dtype, np.integer):
        info = np.iinfo(src.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(src.dtype)
    return out.astype(src.dtype)


def resize(img: np.ndarray, factor=None, shape=None, interpolation=INTER_CUBIC):
    """Resize (D, H, W, C) by ``factor`` or to ``shape``, clipped to the
    input's range."""
    img = np.asarray(img)
    min_val, max_val = img.min(), img.max()
    img_shape = np.array(img.shape)[-3:-1]
    if factor is None and shape is None:
        raise ValueError("resize needs a factor or a shape")
    new_shape = tuple(img_shape * factor) if shape is None else tuple(shape[-3:-1])
    new_shape = [int(i) for i in new_shape]
    if np.array_equal(img_shape, new_shape):
        return img
    kind = _KINDS[interpolation]
    resized = np.array([resize_hw(img[i], new_shape, kind) for i in range(img.shape[-4])])
    return np.clip(resized, min_val, max_val)


def rgb2gray(rgb, weights=None, keepchanneldim=True):
    """Weighted channel sum; default ITU-R 601-2 luma weights."""
    if weights is None:
        weights = np.array([0.299, 0.587, 0.114])
    weights = np.asarray(weights, dtype=np.asarray(rgb).dtype if hasattr(rgb, "dtype")
                         else np.float32)
    if len(weights) != 3:
        raise ValueError("rgb2gray needs 3 weights")
    gray = np.tensordot(rgb, weights, axes=((-1,), (0,)))
    return gray[..., None] if keepchanneldim else gray
