"""Host image utilities (port of lenslesspicam_tpu/data/image.py).

Host numpy code, as in the JAX package, without OpenCV:

* ``resize`` computes what ``cv2.resize`` computes for float images
  (INTER_CUBIC: Keys' cubic with a = -0.75; INTER_LINEAR: linear;
  half-pixel centres, replicated border, no antialiasing) one axis after
  the other, each output pixel the float64 sum of its 2 (linear) or 4
  (cubic) weighted source pixels, and INTER_NEAREST (the source pixel
  ``floor(i * n_in / n_out)``) as a gather;
* ``demosaic`` is ``cv2.cvtColor(raw, cv2.COLOR_BayerRG2RGB)`` bit for
  bit, edges included (bilinear, integer sums rounded half up);
* ``rotate_bilinear`` is ``cv2.warpAffine`` with a rotation matrix, in
  float64.
"""

from __future__ import annotations

import numpy as np

SUPPORTED_BIT_DEPTH = np.array([8, 10, 12, 16])
FLOAT_DTYPES = (np.float32, np.float64)

INTER_NEAREST = 0     # cv2's codes, which the JAX package's callers pass
INTER_LINEAR = 1
INTER_CUBIC = 2
_KINDS = {INTER_NEAREST: "nearest", INTER_LINEAR: "linear", INTER_CUBIC: "cubic"}


def _cubic_coeffs(x):
    """cv2's ``interpolateCubic`` (a = -0.75) at offsets x in [0, 1): the
    weights of the taps at -1, 0, 1, 2."""
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], axis=-1)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The source pixel of each output pixel, as cv2's resizeNN picks it:
    cvFloor(x * (1 / (n_out / n_in)))."""
    return np.minimum(np.floor(np.arange(n_out) * (1.0 / (n_out / n_in))).astype(np.int64),
                      n_in - 1)


def _resize_taps(n_in: int, n_out: int, kind: str = "cubic"):
    """The source pixels (n_out, k) of each output pixel of ``cv2.resize``
    along one axis, clipped to the axis, and their float64 coefficients:
    k = 2 for "linear", 4 for "cubic"."""
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
    return np.clip(taps, 0, n_in - 1), coeffs


def _resize_axis(x: np.ndarray, n_out: int, axis: int, kind: str) -> np.ndarray:
    """``x`` resized along ``axis``: each output pixel the sum of its 2
    ("linear") or 4 ("cubic") source pixels of :func:`_resize_taps`, each
    times its coefficient, in float64."""
    taps, coeffs = _resize_taps(x.shape[axis], n_out, kind)
    shape = [1] * x.ndim
    shape[axis] = n_out
    out = np.zeros(x.shape[:axis] + (n_out,) + x.shape[axis + 1:])
    for k in range(taps.shape[1]):
        out += coeffs[:, k].reshape(shape) * np.take(x, taps[:, k], axis=axis)
    return out


def resize_hw(img: np.ndarray, hw, kind: str = "cubic") -> np.ndarray:
    """An (H, W) or (H, W, C) image resized to ``hw`` as ``cv2.resize``
    resizes it, in the input's dtype (integer types rounded and
    saturated)."""
    src = np.asarray(img)
    if kind == "nearest":
        return src[_nearest_index(src.shape[0], hw[0])][:, _nearest_index(src.shape[1], hw[1])]
    out = _resize_axis(src.astype(np.float64), hw[0], 0, kind)
    out = _resize_axis(out, hw[1], 1, kind)
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


def shift_with_pad(img, shift, pad_mode="constant", axis=(0, 1)):
    """Integer shift along ``axis`` by padding and slicing."""
    n_dim = img.ndim
    pad_width = [(0, 0)] * n_dim
    slice_obj = [slice(None)] * n_dim
    for i, s in zip(axis, shift):
        if s < 0:
            pad_width[i] = (0, -s)
            slice_obj[i] = slice(-s, None)
        elif s > 0:
            pad_width[i] = (s, 0)
            slice_obj[i] = slice(None, -s)
    shifted = np.pad(img, pad_width=tuple(pad_width), mode=pad_mode)
    return shifted[tuple(slice_obj)]


def rotate_bilinear(img: np.ndarray, angle: float, center=None) -> np.ndarray:
    """``img`` (H, W[, C]) rotated by ``angle`` degrees about ``center``
    (x, y), (w/2, h/2) by default, bilinear, zero outside: what
    ``cv2.warpAffine`` with ``cv2.getRotationMatrix2D(center, angle, 1)``
    computes (an integer image rounded and saturated)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    a = np.deg2rad(angle)
    c, s = np.cos(a), np.sin(a)
    cx, cy = (w / 2, h / 2) if center is None else center
    fwd = np.array([[c, s, (1 - c) * cx - s * cy], [-s, c, s * cx + (1 - c) * cy]])
    inv = np.linalg.inv(np.vstack([fwd, [0.0, 0.0, 1.0]]))[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = sx - x0, sy - y0
    src = img.reshape(h, w, -1).astype(np.float64)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(inside[..., None], src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], 0.0)

    fx, fy = fx[..., None], fy[..., None]
    out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
           + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    out = out.reshape(img.shape)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


def rotate_HWC(img: np.ndarray, angle: float) -> np.ndarray:
    """Rotate (..., H, W, C) by ``angle`` degrees about the centre
    (w / 2 - 0.5, h / 2 - 0.5) without expanding, bilinear, zero outside."""
    img = np.asarray(img)
    h, w = img.shape[-3], img.shape[-2]
    flat = img.reshape(-1, h, w, img.shape[-1])
    out = np.stack([rotate_bilinear(f, angle, (w / 2 - 0.5, h / 2 - 0.5)) for f in flat])
    return out.reshape(img.shape)


def gamma_correction(vals, gamma=2.2):
    """Rec. 709 gamma curve: linear below cc = 0.018 with matched slope,
    ``1.099 v^(1/gamma) - 0.099`` above."""
    cc = 0.018
    inv_gam = 1 / gamma
    clip_val = (1.099 * np.power(cc, inv_gam) - 0.099) / cc
    return np.where(vals < cc, vals * clip_val, 1.099 * np.power(vals, inv_gam) - 0.099)


def get_max_val(img, nbits=None):
    """The largest value of the image's bit depth (the next supported
    depth above its maximum when ``nbits`` is not given)."""
    if img.dtype in FLOAT_DTYPES:
        raise ValueError("get_max_val needs an integer image")
    if nbits is None:
        nbits = int(np.ceil(np.log2(img.max() + 1e-9))) if img.max() > 0 else 8
    if nbits not in SUPPORTED_BIT_DEPTH:
        nbits = SUPPORTED_BIT_DEPTH[nbits < SUPPORTED_BIT_DEPTH][0]
    return 2**nbits - 1


def autocorr2d(vals, pad_mode="reflect"):
    """2-D autocorrelation by FFT with reflect padding, normalized to a
    peak of 1 and cropped back to the input's shape."""
    shape = vals.shape
    padded = np.pad(vals, ((shape[0] // 2, shape[0] // 2), (shape[1] // 2, shape[1] // 2)),
                    mode=pad_mode)
    X = np.fft.rfft2(padded)
    autocorr = np.fft.ifftshift(np.fft.irfft2(X * np.conj(X), s=padded.shape))
    autocorr = autocorr / autocorr.max()
    sy, sx = shape[0] // 2, shape[1] // 2
    return autocorr[sy : sy + shape[0], sx : sx + shape[1]]


def rgb2bayer(img, pattern="RGGB"):
    """RGB -> 4-channel Bayer mosaic, one channel per site of ``pattern``."""
    pattern = pattern.upper()
    if len(pattern) != 4 or not set(pattern) <= set("RGB"):
        raise ValueError(f"bad Bayer pattern {pattern!r}")
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    img = img[:h, :w]
    chan = {"R": 0, "G": 1, "B": 2}
    bayer = np.zeros((h // 2, w // 2, 4), dtype=img.dtype)
    for i, p in enumerate(pattern):
        dy, dx = i // 2, i % 2
        bayer[:, :, i] = img[dy::2, dx::2, chan[p]]
    return bayer


def bayer2rgb(bayer, pattern="RGGB"):
    """4-channel Bayer -> RGB, the two greens averaged."""
    pattern = pattern.upper()
    h, w = bayer.shape[:2]
    rgb = np.zeros((h, w, 3), dtype=np.float32)
    counts = np.zeros(3, np.float32)
    chan = {"R": 0, "G": 1, "B": 2}
    for i, p in enumerate(pattern):
        rgb[:, :, chan[p]] += bayer[:, :, i].astype(np.float32)
        counts[chan[p]] += 1
    rgb /= np.maximum(counts, 1)
    return rgb.astype(bayer.dtype) if bayer.dtype in FLOAT_DTYPES else rgb


def demosaic(raw: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(raw, cv2.COLOR_BayerRG2RGB)`` for a 2-D integer
    mosaic: channel 0 from the sites (odd, odd), channel 2 from (even,
    even), green from the other two; each missing value the mean of its 2
    or 4 nearest sites of that colour, rounded half up; the first and last
    column copy their neighbour, then the first and last row; all zeros
    below 3 x 3."""
    raw = np.asarray(raw)
    h, w = raw.shape
    out = np.zeros((h, w, 3), np.int64)
    if h < 3 or w < 3:
        return out.astype(raw.dtype)
    x = raw.astype(np.int64)
    c = x[1:-1, 1:-1]
    up, dn, lf, rt = x[:-2, 1:-1], x[2:, 1:-1], x[1:-1, :-2], x[1:-1, 2:]
    cross = (up + dn + lf + rt + 2) >> 2
    diag = (x[:-2, :-2] + x[:-2, 2:] + x[2:, :-2] + x[2:, 2:] + 2) >> 2
    vert, horz = (up + dn + 1) >> 1, (lf + rt + 1) >> 1
    even_y = (np.arange(1, h - 1) % 2 == 0)[:, None]
    even_x = (np.arange(1, w - 1) % 2 == 0)[None, :]
    ee, oo = even_y & even_x, ~even_y & ~even_x       # the two non-green sites
    eo, oe = even_y & ~even_x, ~even_y & even_x       # green, on an even / odd row
    out[1:-1, 1:-1, 0] = np.select([oo, ee, eo, oe], [c, diag, vert, horz])
    out[1:-1, 1:-1, 1] = np.where(ee | oo, cross, c)
    out[1:-1, 1:-1, 2] = np.select([ee, oo, eo, oe], [c, diag, horz, vert])
    out[:, 0], out[:, -1] = out[:, 1], out[:, -2]
    out[0], out[-1] = out[1], out[-2]
    return out.astype(raw.dtype)


def bayer2rgb_cc(img, nbits, down=None, blue_gain=None, red_gain=None, black_level=None,
                 ccm=None, nbits_out=None):
    """The Raspberry Pi HQ ISP chain: demosaic (:func:`demosaic`) ->
    optional downsample -> black-level subtraction (no lower clip) ->
    white-balance gains -> normalize by ``2**nbits - 1 - black_level`` ->
    clip at 1 -> colour correction matrix -> clip to [0, 1] -> requantize to
    ``nbits_out`` bits."""
    from ..hardware.constants import RPI_HQ_CAMERA_BLACK_LEVEL, RPI_HQ_CAMERA_CCM_MATRIX

    if len(img.shape) != 2:
        raise ValueError("2D Bayer mosaic expected")
    if nbits_out is None:
        nbits_out = nbits
    dtype = np.uint16 if nbits_out > 8 else np.uint8
    if ccm is None:
        ccm = RPI_HQ_CAMERA_CCM_MATRIX
    if black_level is None:
        black_level = RPI_HQ_CAMERA_BLACK_LEVEL

    img = img.astype(np.uint16) if img.dtype not in (np.uint8, np.uint16) else img
    rgb = demosaic(img)
    if down is not None:
        rgb = resize(rgb[None, ...], factor=1 / down)[0]
    rgb = rgb.astype(np.float64) - black_level
    if red_gain:
        rgb[:, :, 0] *= red_gain
    if blue_gain:
        rgb[:, :, 2] *= blue_gain
    rgb = rgb / (2**nbits - 1 - black_level)
    rgb[rgb > 1] = 1
    rgb = rgb @ ccm.T
    rgb = np.clip(rgb, 0, 1)
    return (rgb * (2**nbits_out - 1)).astype(dtype)


def print_image_info(img):
    print(f"dimensions : {img.shape}")
    print(f"data type : {img.dtype}")
    print(f"max  : {img.max()}")
    print(f"min  : {img.min()}")
    print(f"mean : {img.mean()}")
