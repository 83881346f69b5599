"""Data I/O: load and save PSFs and measurements (port of
lenslesspicam_tpu/data/io.py).

Host numpy code returning numpy arrays, as in the JAX package:

* ``load_psf``: background from the mean of a corner patch ``bg_pix``,
  subtracted per channel, optional downsample, ``single_psf`` channel sum,
  L2 normalization, 3-D ``.npy`` / ``.npz`` stacks, (depth, H, W, C) out;
* ``load_data``: PSF and measurement loaded together, the measurement's
  background the PSF's, its shape matched to the PSF's grid;
* ``load_image``: one file, raw Bayer mosaics through the Raspberry Pi HQ
  ISP chain (``data.image.bayer2rgb_cc``), flips, background subtraction,
  float normalization;
* ``save_image``: float -> 8-bit, written as PNG by the encoder below.

``.npy`` and ``.npz`` files load with numpy alone.  PNG, JPG and TIFF
files are read with OpenCV (``cv2``) and DNG files with ``rawpy``, each
imported when such a file is read: without it that read raises an
``ImportError`` naming the format.  Writing a PNG needs neither; another
extension is written by OpenCV.
"""

from __future__ import annotations

import os.path
import struct
import warnings
import zlib

import numpy as np
import torch

from .._device import as_host
from .image import bayer2rgb_cc, get_max_val, print_image_info, resize, rgb2gray


def _need_file(fp):
    if not os.path.isfile(fp):
        raise FileNotFoundError(f"file not found: {fp}")


def _cv2(fp, action):
    try:
        import cv2
    except ImportError as e:
        ext = os.path.splitext(str(fp))[1] or "this"
        raise ImportError(f"{action} {ext} files needs OpenCV (cv2), which is not "
                          "installed; .npy and .npz files load without it") from e
    return cv2


def load_image(fp, verbose=False, flip=False, flip_ud=False, flip_lr=False, bayer=False,
               black_level=None, blue_gain=None, red_gain=None, ccm=None, back=None,
               nbits_out=None, as_4d=False, downsample=None, bg=None, return_float=False,
               shape=None, dtype=None, normalize=True, bgr_input=True):
    """Load an image file to a numpy array."""
    _need_file(fp)
    if fp.endswith(".npy"):
        img = np.load(fp)
    elif fp.lower().endswith(".dng"):
        try:
            import rawpy
        except ImportError as e:
            raise ImportError("reading .dng files needs rawpy, which is not installed") from e
        raw = rawpy.imread(fp)
        img = raw.raw_image
        ccm = raw.color_matrix[:, :3] if ccm is None else ccm
        black_level = np.min(raw.black_level_per_channel) if black_level is None else black_level
        bayer = True
    else:
        cv2 = _cv2(fp, "reading")
        img = cv2.imread(fp, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"could not read image: {fp}")

    if bayer:
        if len(img.shape) != 2:
            raise ValueError("a Bayer image must be 2D")
        nbits = int(np.ceil(np.log2(img.max() + 1)))
        img = bayer2rgb_cc(img, nbits=nbits, blue_gain=blue_gain, red_gain=red_gain,
                           black_level=black_level, ccm=ccm, nbits_out=nbits_out)
    elif len(img.shape) == 3 and img.shape[2] == 3 and bgr_input:
        img = np.ascontiguousarray(img[:, :, ::-1])      # BGR -> RGB

    original_dtype = img.dtype

    if flip:
        img = np.fliplr(np.flipud(img))
    if flip_ud:
        img = np.flipud(img)
    if flip_lr:
        img = np.fliplr(img)

    if bg is not None:
        bg = np.asarray(bg)
        # a normalized background for an integer image: rescale it to the
        # image's bit depth before subtracting
        if bg.max() <= 1 and img.dtype not in (np.float32, np.float64):
            bg = bg * get_max_val(img)
        img = img.astype(np.float32) - bg
        img = np.clip(img, a_min=0, a_max=img.max())

    if as_4d:
        if len(img.shape) == 3:
            img = img[np.newaxis]
        elif len(img.shape) == 2:
            img = img[np.newaxis, :, :, np.newaxis]

    if downsample is not None or shape is not None:
        factor = 1.0 / downsample if downsample is not None else None
        was_4d = len(img.shape) == 4
        img4 = img if was_4d else (img[np.newaxis] if img.ndim == 3
                                   else img[np.newaxis, :, :, np.newaxis])
        img4 = resize(img4, factor=factor, shape=shape)
        img = img4 if was_4d else (img4[0] if img.ndim >= 3 else img4[0, :, :, 0])

    if return_float:
        out_dtype = np.float32 if dtype is None else dtype
        if out_dtype not in (np.float32, np.float64):
            raise ValueError("return_float needs dtype float32 or float64")
        img = img.astype(out_dtype)
        if normalize:
            peak = img.max()
            if peak > 0:
                img /= peak
    else:
        img = img.astype(original_dtype if dtype is None else dtype)

    if verbose:
        print_image_info(img)
    return img


def load_psf(fp, downsample=1, return_float=True, bg_pix=(5, 25), return_bg=False, flip=False,
             flip_ud=False, flip_lr=False, verbose=False, bayer=False, blue_gain=None,
             red_gain=None, dtype=np.float32, nbits_out=None, single_psf=False, shape=None,
             use_3d=False, bgr_input=True, force_rgb=False):
    """Load and process a PSF to (depth, H, W, C)."""
    if use_3d:
        _need_file(fp)
        if fp.endswith(".npy"):
            psf = np.load(fp)
        elif fp.endswith(".npz"):
            archive = np.load(fp)
            if len(archive.files) == 0:
                raise ValueError("No arrays in .npz archive")
            if len(archive.files) > 1:
                warnings.warn("more than one array in .npz archive, using first")
            psf = archive[archive.files[0]]
        else:
            raise ValueError("3D PSF must be .npy or .npz")
    else:
        psf = load_image(fp, flip=flip, flip_ud=flip_ud, flip_lr=flip_lr, bayer=bayer,
                         blue_gain=blue_gain, red_gain=red_gain, nbits_out=nbits_out,
                         bgr_input=bgr_input)

    original_dtype = psf.dtype
    max_val = get_max_val(psf) if psf.dtype not in (np.float32, np.float64) else psf.max()
    psf = np.array(psf, dtype=dtype)

    if force_rgb and len(psf.shape) == 2:
        psf = np.stack([psf] * 3, axis=2)

    if use_3d:
        grayscale = len(psf.shape) == 3
        if grayscale:
            psf = psf[:, :, :, np.newaxis]
        elif len(psf.shape) != 4:
            raise ValueError("a 3D PSF must be (depth, H, W) or (depth, H, W, C)")
    elif len(psf.shape) == 3:
        grayscale = False
        psf = psf[np.newaxis]
    elif len(psf.shape) == 2:
        grayscale = True
        psf = psf[np.newaxis, :, :, np.newaxis]
    else:
        raise ValueError("a PSF image must be (H, W) or (H, W, C)")

    # background from the corner patch, subtracted per channel
    if bg_pix is None:
        bg = np.zeros(psf.shape[-1])
    else:
        bg = []
        for i in range(psf.shape[3]):
            bg_i = np.mean(psf[:, bg_pix[0]:bg_pix[1], bg_pix[0]:bg_pix[1], i])
            psf[:, :, :, i] -= bg_i
            bg.append(bg_i)
        psf = np.clip(psf, a_min=0, a_max=psf.max())
        bg = np.array(bg)

    if downsample != 1 or shape is not None:
        psf = resize(psf, shape=shape, factor=1 / downsample)

    if single_psf:
        if not grayscale:
            psf = np.sum(psf, axis=3, keepdims=True)
        else:
            warnings.warn("single_psf has no effect for grayscale psf")

    if return_float:
        psf /= np.linalg.norm(psf.ravel())
        bg = np.asarray(bg) / max_val
    else:
        psf = psf.astype(original_dtype)

    if verbose:
        print_image_info(psf)
    return (psf, bg) if return_bg else psf


def load_data(psf_fp, data_fp, return_float=True, downsample=None, bg_pix=(5, 25), flip=False,
              flip_ud=False, flip_lr=False, bayer=False, blue_gain=None, red_gain=None,
              gray=False, dtype=np.float32, single_psf=False, shape=None, normalize=False,
              bgr_input=True, use_3d=False):
    """PSF and measurement loaded with the same processing: returns
    (psf (D, H, W, C), data (D, H, W, C))."""
    _need_file(psf_fp)
    _need_file(data_fp)
    if shape is None and downsample is None:
        raise ValueError("load_data needs downsample or shape")

    psf, bg = load_psf(psf_fp, downsample=downsample or 1, return_float=return_float,
                       bg_pix=bg_pix, return_bg=True, flip=flip, flip_ud=flip_ud,
                       flip_lr=flip_lr, bayer=bayer, blue_gain=blue_gain, red_gain=red_gain,
                       dtype=dtype, single_psf=single_psf, shape=shape, use_3d=use_3d,
                       bgr_input=bgr_input)

    data = load_image(data_fp, flip=flip, flip_ud=flip_ud, flip_lr=flip_lr, bayer=bayer,
                      blue_gain=blue_gain, red_gain=red_gain, bg=bg, as_4d=True,
                      return_float=return_float, shape=psf.shape, normalize=normalize,
                      bgr_input=bgr_input, dtype=dtype)

    if data.shape[-3:-1] != psf.shape[-3:-1]:
        data = resize(data, shape=psf.shape)

    if gray:
        psf = rgb2gray(psf[0])[None] if psf.shape[-1] == 3 else psf
        data = rgb2gray(data[0])[None] if data.shape[-1] == 3 else data

    return psf.astype(dtype), data.astype(dtype)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA image as the
    bytes of a PNG file: one IDAT chunk, every row with filter type 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError("encode_png writes 8-bit images")
    color = {1: 0, 3: 2, 4: 6}.get(1 if img.ndim == 2 else img.shape[-1])
    if img.ndim not in (2, 3) or color is None:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image(img, fp, max_val=255, normalize=True):
    """Normalize to 8 bits and save: RGB, gray or one channel, an array or
    a tensor on any device; a depth or batch axis keeps its first image."""
    img = as_host(img) if isinstance(img, torch.Tensor) else np.asarray(img)
    if img.ndim > 3:
        img = img.reshape(-1, *img.shape[-3:])[0]
    out = img.astype(np.float32)
    if normalize:
        out -= out.min()
        if out.max() > 0:
            out /= out.max()
    out = (np.clip(out, 0, 1) * max_val).astype(np.uint8)
    if out.shape[-1] == 1:
        out = out[..., 0]
    if str(fp).lower().endswith(".png"):
        if out.ndim == 3 and out.shape[-1] == 4:
            out = out[:, :, [2, 1, 0, 3]]      # the JAX package hands RGBA to OpenCV as BGRA
        with open(fp, "wb") as f:
            f.write(encode_png(out))
        return fp
    cv2 = _cv2(fp, "writing")
    if out.ndim == 3 and out.shape[-1] == 3:
        out = np.ascontiguousarray(out[:, :, ::-1])      # RGB -> BGR for OpenCV
    cv2.imwrite(str(fp), out)
    return fp
