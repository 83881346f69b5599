"""Padded-FFT size selection for linear convolution (copy of
lenslesspicam_tpu/ops/padding.py: the port imports nothing of the JAX
package).

The reference (lensless/recon/rfft_convolve.py:111-112) pads each spatial dim
of an ``N``-sized signal to ``next_fast_len(2N - 1)`` (smallest 5-smooth
integer) so that circular FFT convolution equals linear convolution.  We keep
that policy as the compatibility default, and additionally offer a TPU policy
that rounds the padded width up to a lane-aligned (multiple-of-128), even,
hardware-friendlier size.  Any padded size ``>= 2N - 1`` yields the same
linear-convolution values; evenness additionally lets us fold the reference's
``ifftshift`` into the precomputed frequency response (see fft_conv.py).
"""

from __future__ import annotations


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n.

    Same contract as scipy.fftpack.next_fast_len, implemented independently.
    """
    if n <= 6:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()  # power of two always works
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            # smallest power of two multiple of p35 that is >= n
            quotient = -(-n // p35)  # ceil div
            p2 = 1 << (quotient - 1).bit_length()
            candidate = p2 * p35
            if candidate == n:
                return n
            if candidate < best:
                best = candidate
            p35 *= 3
        p5 *= 5
    return best


def next_even_fast_len(n: int) -> int:
    """Smallest even 5-smooth integer >= n (evenness enables shift folding)."""
    m = next_fast_len(n)
    while m % 2:
        m = next_fast_len(m + 1)
    return m


def tpu_fast_len(n: int) -> int:
    """Padded size for TPU: even 5-smooth, and lane-aligned once large.

    For small sizes plain even-5-smooth is fine; for >= 512 we prefer
    multiples of 256 (keeps the rfft half-spectrum lane-aligned at 128).
    """
    m = next_even_fast_len(n)
    if m >= 512:
        aligned = -(-n // 256) * 256
        m = next_even_fast_len(aligned)
    return m


def padded_size(n: int, policy: str = "ref") -> int:
    """Padded FFT size for a length-``n`` signal under the given policy.

    policy "ref": matches reference next_fast_len(2n-1) exactly.
    policy "even": like "ref" but forced even (bit-identical results; the
        fftshift folds into H as a real +-1 mask).
    policy "tpu": even + lane-aligned for large sizes (same math, faster FFT).
    """
    target = 2 * n - 1
    if policy == "ref":
        return next_fast_len(target)
    if policy == "even":
        return next_even_fast_len(target)
    if policy == "tpu":
        return tpu_fast_len(target)
    raise ValueError(f"unknown padding policy: {policy!r}")
